"""Fig. 13: neural-network runtime vs computing-array size (rows fixed at 32; the
twin of the reference's fig13 benchmark).

Paper claim: runtime decreases sublinearly with column count — at large array
sizes adding columns barely helps (this is what compresses Fig. 12's speedup
relative to Fig. 11's computing-power gap).
"""
from __future__ import annotations

from repro_torch.bench.common import Claims
from repro_torch.core.perf_model import NETWORKS, network_cycles


def run(quick: bool = False) -> dict:
    cols_grid = [4, 8, 16, 24, 32]
    table = {
        net: {c: network_cycles(net, 32, c) for c in cols_grid} for net in NETWORKS
    }
    c = Claims("fig13")
    c.check(
        "runtime monotonically decreases with column count",
        all(
            table[n][cols_grid[i]] >= table[n][cols_grid[i + 1]]
            for n in table for i in range(len(cols_grid) - 1)
        ),
    )
    # sublinearity: doubling 16->32 gives less gain than 4->8
    def gain(n, a, b):
        return table[n][a] / table[n][b]
    c.check(
        "doubling columns gives diminishing returns (gain(16->32) < gain(4->8))",
        all(gain(n, 16, 32) < gain(n, 4, 8) + 0.05 for n in NETWORKS),
        ", ".join(f"{n}: {gain(n,4,8):.2f}->{gain(n,16,32):.2f}" for n in NETWORKS),
    )
    return {"cycles": table, "claims": c.items, "all_ok": c.all_ok}
