"""Runs the twins: one module per paper table/figure, the campaign's
statistical acceptance run, and the beyond-paper twins (repair recovery,
fleet goodput, cluster FFP, the telemetry tax, serving goodput, the
protection tax per family, scan latency, detector coverage).

    PYTHONPATH=src python -m repro_torch.bench.run [--quick] [--only NAME] [--device cpu|cuda]

Each module validates the paper's claims and writes its numbers to
``experiments/bench_torch/<name>.json``.  The default device is ``cuda``;
without a card, pass ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.bench.common import run_module


def modules() -> dict:
    from repro_torch.bench import (
        campaign,
        cluster_ffp,
        detector_coverage,
        fig02_accuracy_vs_per,
        fig03_motivation_ffp,
        fig09_area,
        fig10_ffp,
        fig11_computing_power,
        fig12_performance,
        fig13_runtime_vs_size,
        fig14_scalability,
        fig15_dppu_grouping,
        fleet_goodput,
        ft_overhead,
        obs_overhead,
        repair_recovery,
        scan_latency,
        serving_goodput,
        tab01_detection,
    )

    return {
        "campaign": campaign.run,
        "fig02_accuracy_vs_per": fig02_accuracy_vs_per.run,
        "fig03_motivation_ffp": fig03_motivation_ffp.run,
        "fig09_area": fig09_area.run,
        "fig10_ffp": fig10_ffp.run,
        "fig11_computing_power": fig11_computing_power.run,
        "fig12_performance": fig12_performance.run,
        "fig13_runtime_vs_size": fig13_runtime_vs_size.run,
        "fig14_scalability": fig14_scalability.run,
        "fig15_dppu_grouping": fig15_dppu_grouping.run,
        "tab01_detection": tab01_detection.run,
        "repair_recovery": repair_recovery.run,
        "fleet_goodput": fleet_goodput.run,
        "cluster_ffp": cluster_ffp.run,
        "obs_overhead": obs_overhead.run,
        "serving_goodput": serving_goodput.run,
        "ft_overhead": ft_overhead.run,
        "scan_latency": scan_latency.run,
        "detector_coverage": detector_coverage.run,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true", help="reduced Monte-Carlo counts")
    ap.add_argument("--only", default="", help="comma-separated module names")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    mods = modules()
    if args.only:
        keep = set(args.only.split(","))
        unknown = keep - set(mods)
        if unknown:
            ap.error(f"unknown module(s) {sorted(unknown)}; known: {sorted(mods)}")
        mods = {k: v for k, v in mods.items() if k in keep}

    results = {name: run_module(name, fn, args.quick, args.device) for name, fn in mods.items()}
    n_claims = sum(len(r.get("claims", [])) for r in results.values())
    n_fail = sum(1 for r in results.values() for cl in r.get("claims", []) if not cl["ok"])
    print(f"\n[bench] {len(results)} modules, {n_claims} claims, {n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
