"""FaultCampaign statistical acceptance run (the twin of the reference's
campaign benchmark).

Runs the batched Monte-Carlo engine over the paper's PER grid under both
fault models and validates the statistical shape of the reproduced curves,
with tolerances taken from the campaign's own binomial confidence intervals:

  * monotone FFP degradation in PER for every scheme;
  * the paper's scheme ordering HyCA >= DR >= CR and DR >= RR (Fig. 10);
  * batched engine == per-config NumPy reference, bit-identical, on the same
    sampled batch;
  * >= 10x fewer Python-level iterations than the legacy per-config loop;
  * remaining computing power degrades monotonically and HyCA dominates it.

The numbers (FFP / remaining power / CI half-widths per scheme × PER × model,
plus host seconds of the batched engine and of the reference) go to
``experiments/bench_torch/campaign.json``.
"""
from __future__ import annotations

import time

from repro_torch.bench.common import Claims, device_name, sync
from repro_torch.core import campaign as cp
from repro_torch.core.redundancy import DPPUConfig

PERS = [0.005, 0.01, 0.02, 0.03, 0.04, 0.06]
SCHEMES = ("RR", "CR", "DR", "HyCA")


def run(quick: bool = False, device="cuda") -> dict:
    n = 300 if quick else 1500
    c = Claims("campaign")
    table: dict = {}
    iterations = 0
    t_vmapped = 0.0

    for model in ("random", "clustered"):
        spec = cp.CampaignSpec(rows=32, cols=32, fault_model=model, n_configs=n,
                               schemes=SCHEMES, dppu=DPPUConfig(size=32))
        t0 = time.perf_counter()
        run_ = cp.run_campaign(spec, PERS, device=device)
        t_vmapped += time.perf_counter() - t0
        iterations += run_.python_iterations
        for r in run_.results:
            table.setdefault(model, {}).setdefault(r.scheme, {})[r.per] = r.as_dict()

    def ffp(model, scheme, per):
        return table[model][scheme][per]["fully_functional_prob"]

    def ci(model, scheme, per):
        return table[model][scheme][per]["ffp_ci95"]

    c.check(
        "FFP degrades monotonically in PER for every scheme (within CI)",
        all(
            ffp(m, s, PERS[i]) >= ffp(m, s, PERS[i + 1])
            - ci(m, s, PERS[i]) - ci(m, s, PERS[i + 1])
            for m in table for s in SCHEMES for i in range(len(PERS) - 1)
        ),
    )
    c.check(
        "scheme ordering HyCA >= DR >= CR and DR >= RR at every PER (within CI)",
        all(
            ffp(m, hi, p) >= ffp(m, lo, p) - ci(m, hi, p) - ci(m, lo, p)
            for m in table for p in PERS
            for hi, lo in (("HyCA", "DR"), ("DR", "CR"), ("DR", "RR"))
        ),
    )
    c.check(
        "remaining computing power: HyCA >= every classical scheme at every PER",
        all(
            table[m]["HyCA"][p]["remaining_power"]
            >= table[m][s][p]["remaining_power"]
            - table[m]["HyCA"][p]["remaining_power_ci95"]
            - table[m][s][p]["remaining_power_ci95"]
            for m in table for s in ("RR", "CR", "DR") for p in PERS
        ),
    )

    # batched (the reference's "vmapped") == reference, bit-identical, on one shared sampled point
    sub = min(n, 200)
    spec = cp.CampaignSpec(rows=32, cols=32, n_configs=sub, schemes=SCHEMES,
                           dppu=DPPUConfig(size=32))
    point = cp.sample_point(spec, 0.02)
    t0 = time.perf_counter()
    vm = cp.evaluate_point(spec, point, engine="vmapped", device=device)
    sync(device)
    t_sub_vmapped = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = cp.evaluate_point(spec, point, engine="reference")
    t_sub_reference = time.perf_counter() - t0
    c.check(
        "vmapped == per-config NumPy reference (bit-identical, all schemes)",
        all(
            a.fully_functional_prob == b.fully_functional_prob
            and a.remaining_power == b.remaining_power
            for a, b in zip(vm, ref)
        ),
    )

    legacy_iterations = len(SCHEMES) * len(PERS) * n * 2
    c.check(
        ">= 10x fewer Python-level iterations than the legacy per-config loop",
        iterations * 10 <= legacy_iterations,
        f"{iterations} vs {legacy_iterations}",
    )

    return {
        "n_configs": n,
        "pers": PERS,
        "table": table,
        "python_iterations": iterations,
        "legacy_iterations": legacy_iterations,
        "device": device_name(device),
        "wall_s_vmapped_full": round(t_vmapped, 3),
        "wall_s_vmapped_subsample": round(t_sub_vmapped, 3),
        "wall_s_reference_subsample": round(t_sub_reference, 3),
        "claims": c.items,
        "all_ok": c.all_ok,
    }
