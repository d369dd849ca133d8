"""Twin regression gate: diff a run of the port's twins against a baseline
run of the same twins (the twin of the reference's benchmarks/regress.py).

Each :class:`Budget` names one metric in one twin's JSON, how its records
are keyed (so baseline and current rows pair up even when the sweep order
changes), and a ``max_ratio`` tolerance: current/baseline above it is a
regression (below ``min_ratio`` for a higher-is-better metric).  Ratios,
not absolute deltas: two runs on two cards differ.

The baseline is a directory of the port's own twin results
(``experiments/bench_torch/`` by default, ``REPRO_TORCH_BENCH_DIR``).  The
port's times are never compared with the reference's files: a file written
by the reference's benchmarks (it names a JAX ``backend`` where the twins
name their ``device``) is skipped with a note.

    python -m repro_torch.bench.run --quick --only ft_overhead,scan_latency   # the baseline
    REPRO_TORCH_BENCH_DIR=/tmp/cur python -m repro_torch.bench.run --quick --only ft_overhead
    python -m repro_torch.bench.regress --current /tmp/cur --warn-only

Run with no arguments it diffs the baseline against itself (every ratio
1.0: a self-test that the budget wiring matches the files).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from repro_torch.bench.common import OUT_DIR


@dataclasses.dataclass(frozen=True)
class Budget:
    """One gated metric: ``records[*][metric]`` in ``<dir>/<bench>.json``,
    rows matched across runs by the ``key`` fields, failing when
    current/baseline > ``max_ratio`` or < ``min_ratio``."""

    bench: str                       # file stem under the bench dir
    metric: str                      # numeric field in each record
    max_ratio: float                 # current/baseline ceiling
    key: tuple[str, ...] = ("arch",)  # record-identity fields
    records: str = "results"         # list field holding the records
    min_ratio: float = 0.0           # current/baseline floor (0 = no floor)


# The reference's budgets, on the twins' metrics of the same names.  The
# *_overhead_x metrics are ratios of ratios (machine speed divides out), so
# their budgets are tighter than raw wall time; the per-site rows time a
# thin slice of a step and get more slack; fused_speedup_x is
# higher-is-better; step_ms, boot_batched_ms and sim_wall_s are raw wall
# time, the widest budgets; goodput and coverage are semantics tripwires.
BUDGETS: tuple[Budget, ...] = (
    Budget("ft_overhead", "twopass_overhead_x", 1.6),
    Budget("ft_overhead", "fused_overhead_x", 1.35),
    Budget("ft_overhead", "fused_speedup_x", float("inf"), min_ratio=0.65),
    Budget("ft_overhead", "fused_overhead_x", 1.8, key=("arch", "site"), records="site_results"),
    Budget("obs_overhead", "overhead_x", 1.10, key=("path",)),
    Budget("scan_latency", "step_ms", 2.5, key=("rows", "cols", "scan_block")),
    Budget("scan_latency", "boot_batched_ms", 2.5, key=("rows", "cols", "scan_block")),
    Budget("fleet_goodput", "goodput_tokens", 1.25, key=("fleet",), min_ratio=0.8),
    Budget("fleet_goodput", "sim_wall_s", 3.0, key=("fleet",)),
    Budget("detector_coverage", "coverage", float("inf"),
           key=("fault_class", "detector"), records="matrix", min_ratio=0.8),
)


def _load(path: str) -> dict | None:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _index(payload: dict, budget: Budget) -> dict[tuple, dict]:
    return {tuple(rec.get(k) for k in budget.key): rec for rec in payload.get(budget.records, [])}


def _is_reference(payload: dict) -> bool:
    """Written by the reference's benchmarks, not by a twin."""
    return "backend" in payload and "device" not in payload


def diff_benchmarks(baseline_dir: str, current_dir: str, budgets: tuple[Budget, ...] = BUDGETS) -> dict:
    """Diff every budgeted metric between two twin-result directories.

    Returns ``{"rows": [...], "notes": [...], "ok": bool}``.  A row is one
    (bench, metric, key) comparison with its ratio and verdict; notes record
    skips (missing or reference file, missing record or metric, non-positive
    baseline); skips never fail the gate, only measured regressions do."""
    rows: list[dict] = []
    notes: list[str] = []
    for b in budgets:
        base = _load(os.path.join(baseline_dir, f"{b.bench}.json"))
        cur = _load(os.path.join(current_dir, f"{b.bench}.json"))
        if base is None:
            notes.append(f"{b.bench}.json: no baseline — skipped")
            continue
        if cur is None:
            notes.append(f"{b.bench}.json: not in current run — skipped")
            continue
        if _is_reference(base) or _is_reference(cur):
            notes.append(f"{b.bench}.json: a reference benchmark's file, not a twin's — skipped")
            continue
        base_idx = _index(base, b)
        for key, crec in _index(cur, b).items():
            brec = base_idx.get(key)
            label = f"{b.bench}:{b.metric}[{','.join(map(str, key))}]"
            if brec is None:
                notes.append(f"{label}: no baseline record — skipped")
                continue
            bval, cval = brec.get(b.metric), crec.get(b.metric)
            if not isinstance(bval, (int, float)) or not isinstance(cval, (int, float)):
                notes.append(f"{label}: metric missing — skipped")
                continue
            if bval <= 0:
                notes.append(f"{label}: non-positive baseline {bval} — skipped")
                continue
            ratio = cval / bval
            rows.append({
                "bench": b.bench, "metric": b.metric,
                "key": dict(zip(b.key, key)),
                "baseline": bval, "current": cval,
                "ratio": round(ratio, 3), "max_ratio": b.max_ratio,
                "min_ratio": b.min_ratio,
                "ok": b.min_ratio <= ratio <= b.max_ratio,
            })
    return {"rows": rows, "notes": notes, "ok": all(r["ok"] for r in rows)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=OUT_DIR,
                    help=f"baseline twin-result dir (default: {OUT_DIR})")
    ap.add_argument("--current", default=None,
                    help="twin-result dir to gate (default: the baseline itself, a wiring self-test)")
    ap.add_argument("--warn-only", action="store_true", help="report regressions but exit 0")
    ap.add_argument("--only", default=None, metavar="BENCH", help="gate only this twin's budgets")
    ap.add_argument("--json", action="store_true", help="emit the diff as JSON")
    args = ap.parse_args(argv)

    budgets = BUDGETS if args.only is None else tuple(b for b in BUDGETS if b.bench == args.only)
    if not budgets:
        print(f"[regress] no budgets for bench {args.only!r}")
        return 2
    out = diff_benchmarks(args.baseline, args.current or args.baseline, budgets)
    if args.json:
        print(json.dumps(out, indent=1))
    else:
        for note in out["notes"]:
            print(f"[regress] note: {note}")
        for r in out["rows"]:
            keystr = ",".join(f"{k}={v}" for k, v in r["key"].items())
            status = "ok  " if r["ok"] else "FAIL"
            print(f"[regress] {status} {r['bench']}:{r['metric']}[{keystr}] "
                  f"{r['baseline']} -> {r['current']} (x{r['ratio']}, budget x{r['max_ratio']})")
        n_bad = sum(not r["ok"] for r in out["rows"])
        verdict = "PASS" if out["ok"] else f"{n_bad} REGRESSION(S)"
        print(f"[regress] {len(out['rows'])} comparisons, {len(out['notes'])} skipped: {verdict}"
              + (" (warn-only)" if args.warn_only and not out["ok"] else ""))
    if not out["ok"] and not args.warn_only:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
