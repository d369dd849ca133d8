"""Fig. 12: end-to-end neural-network performance of the degraded DLAs
(Scale-sim-style analytical model), normalized to RR (the twin of the
reference's fig12 benchmark).

Paper claims: HyCA's speedup over RR grows with PER, reaching ~9× at PER 6%
(random); the performance gap is much smaller than the computing-power gap
because runtime is sublinear in array size and FC layers use one column.
"""
from __future__ import annotations

import numpy as np

from repro_torch.bench.common import Claims
from repro_torch.core.perf_model import NETWORKS, scheme_throughput
from repro_torch.core.redundancy import DPPUConfig


def run(quick: bool = False) -> dict:
    n = 100 if quick else 600
    pers = [0.01, 0.02, 0.04, 0.06]
    nets = list(NETWORKS)
    out = {}
    for model in ("random", "clustered"):
        t = {}
        for s in ("RR", "CR", "DR", "HyCA"):
            for p in pers:
                tps = [
                    scheme_throughput(s, net, p, fault_model=model, n_configs=n,
                                      dppu=DPPUConfig(size=32))
                    for net in nets
                ]
                t.setdefault(s, {})[p] = float(np.mean(tps))
        out[model] = {
            s: {p: t[s][p] / max(t["RR"][p], 1e-15) for p in pers} for s in t
        }

    c = Claims("fig12")
    speedups = {p: out["random"]["HyCA"][p] for p in pers}
    c.check(
        "HyCA speedup over RR grows with PER",
        all(speedups[pers[i]] <= speedups[pers[i + 1]] + 0.2 for i in range(len(pers) - 1)),
        " ".join(f"{p:.0%}:{speedups[p]:.1f}x" for p in pers),
    )
    c.check(
        "HyCA speedup at PER 6% (random) is large (paper ~9x)",
        speedups[0.06] > 4.0,
        f"{speedups[0.06]:.1f}x",
    )
    c.check(
        "HyCA >= CR, DR at every PER/model",
        all(
            out[m]["HyCA"][p] >= out[m][s][p] - 0.05
            for m in out for s in ("CR", "DR") for p in pers
        ),
    )
    return {"speedup_vs_RR": out, "claims": c.items, "all_ok": c.all_ok}
