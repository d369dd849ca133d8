"""Fig. 3 (motivation): fully-functional probability of RR/CR/DR @32×32 (the
twin of the reference's fig03 benchmark).

Paper claim: the classical schemes can hardly mitigate all faulty PEs even at
PER ≈ 1% (≈10 expected faults) despite having 32 redundant PEs.
"""
from __future__ import annotations

from repro_torch.bench.common import Claims
from repro_torch.core.reliability import sweep


def run(quick: bool = False) -> dict:
    n = 300 if quick else 2000
    pers = [0.001, 0.005, 0.01, 0.02, 0.03, 0.04, 0.06]
    res = sweep(("RR", "CR", "DR"), pers, n_configs=n)
    table = {}
    for r in res:
        table.setdefault(r.scheme, {})[r.per] = r.fully_functional_prob
    c = Claims("fig03")
    c.check(
        "RR/CR FFP < 50% at PER=1% despite 32 spares >> ~10 faults",
        all(table[s][0.01] < 0.5 for s in ("RR", "CR")),
        f"FFP@1%: " + ", ".join(f"{s}={table[s][0.01]:.2f}" for s in table),
    )
    # our DR baseline is an *idealized* optimal row/col-spare matcher — an
    # upper bound on the switch-constrained scheme of [20] (DESIGN.md §7) —
    # so it is stronger than the paper's DR at low PER; it still collapses
    # once faults approach the spare budget.
    c.check(
        "even idealized DR collapses by PER 4% (faults ~ spare budget)",
        table["DR"][0.04] < 0.3,
        f"DR@4%={table['DR'][0.04]:.2f}",
    )
    c.check(
        "FFP monotonically degrades with PER",
        all(
            table[s][pers[i]] >= table[s][pers[i + 1]] - 0.02
            for s in table
            for i in range(len(pers) - 1)
        ),
    )
    return {"table": table, "claims": c.items, "all_ok": c.all_ok}
