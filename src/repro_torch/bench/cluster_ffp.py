"""Beyond-paper: the HyCA insight at cluster granularity (the twin of the
reference's cluster_ffp benchmark; host numpy, so the same seed gives the
reference's table).

A 1024-host fleet with 32 spare hosts, failures either i.i.d. or clustered by
rack (switch/PSU domain).  Policy "region" pins 2 spares per rack (the RR/CR
analogue); policy "pool" lets any spare cover any host (the DPPU analogue).
The same FFP separation as the paper's Fig. 10 appears five orders of
magnitude above the PE array — quantifying why the framework's elastic
runtime (``runtime/elastic.py``) uses a global spare pool + data-axis re-mesh.
"""
from __future__ import annotations

import numpy as np

from repro_torch.bench.common import Claims
from repro_torch.runtime.elastic import spare_pool_ffp


def run(quick: bool = False) -> dict:
    rng = np.random.default_rng(0)
    n_trials = 500 if quick else 4000
    n_hosts, n_racks, n_spares = 1024, 16, 32
    rates = [0.002, 0.005, 0.01, 0.02, 0.03]
    table = {}
    for rate in rates:
        table[rate] = {
            p: spare_pool_ffp(
                rng, n_hosts, rate, n_spares=n_spares, policy=p,
                n_racks=n_racks, n_trials=n_trials,
            )
            for p in ("region", "pool")
        }
    c = Claims("cluster_ffp")
    c.check(
        "global pool >= per-rack spares at every failure rate",
        all(table[r]["pool"] >= table[r]["region"] - 0.02 for r in rates),
        str({r: (round(table[r]['pool'], 2), round(table[r]['region'], 2)) for r in rates}),
    )
    c.check(
        "separation is large in the mid regime (rate 1-2%)",
        (table[0.01]["pool"] - table[0.01]["region"]) > 0.15
        or (table[0.02]["pool"] - table[0.02]["region"]) > 0.15,
    )
    return {"ffp": {str(k): v for k, v in table.items()}, "claims": c.items, "all_ok": c.all_ok}
