"""Fig. 11: normalized remaining computing power under column-discard
degradation (the twin of the reference's fig11 benchmark).

Paper claims: HyCA highest at every PER, gap grows with PER; RR lowest
(cannot shift faults across columns → discards a column per faulty row-pair).
"""
from __future__ import annotations

from repro_torch.bench.common import Claims
from repro_torch.core.redundancy import DPPUConfig
from repro_torch.core.reliability import sweep


def run(quick: bool = False) -> dict:
    n = 300 if quick else 3000
    pers = [0.01, 0.02, 0.03, 0.04, 0.06]
    out = {}
    for model in ("random", "clustered"):
        res = sweep(("RR", "CR", "DR", "HyCA"), pers, fault_model=model,
                    n_configs=n, dppu=DPPUConfig(size=32))
        t = {}
        for r in res:
            t.setdefault(r.scheme, {})[r.per] = r.remaining_power
        out[model] = t

    c = Claims("fig11")
    c.check(
        "HyCA has the highest remaining computing power at every PER",
        all(
            out[m]["HyCA"][p] >= max(out[m][s][p] for s in ("RR", "CR", "DR")) - 0.01
            for m in out for p in pers
        ),
    )
    c.check(
        "RR has the lowest remaining computing power",
        all(
            out[m]["RR"][p] <= min(out[m][s][p] for s in ("CR", "DR", "HyCA")) + 0.02
            for m in out for p in pers
        ),
    )
    ratio_low = out["random"]["HyCA"][0.01] / max(out["random"]["RR"][0.01], 1e-9)
    ratio_high = out["random"]["HyCA"][0.06] / max(out["random"]["RR"][0.06], 1e-9)
    c.check("HyCA-vs-RR advantage (ratio) grows with PER", ratio_high > ratio_low,
            f"ratio@1%={ratio_low:.1f}x ratio@6%={ratio_high:.1f}x")
    c.check(
        "computing-power ratio HyCA/RR large (~25x paper) at PER 6% random",
        out["random"]["HyCA"][0.06] / max(out["random"]["RR"][0.06], 1e-9) > 8,
        f"ratio={out['random']['HyCA'][0.06] / max(out['random']['RR'][0.06], 1e-9):.1f}x",
    )
    return {"table": out, "claims": c.items, "all_ok": c.all_ok}
