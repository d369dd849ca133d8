"""Fig. 9: chip area of RR/CR/DR vs HyCA24/32/40 (the twin of the reference's
fig09 benchmark).

Paper claims: HyCA designs show much less redundancy overhead; MUX networks
dominate RR/CR/DR overhead; HyCA's register files are a small addition.
"""
from __future__ import annotations

from repro_torch.bench.common import Claims
from repro_torch.core.area import all_areas


def run(quick: bool = False) -> dict:
    areas = all_areas(32, 32)
    by = {a.scheme: a for a in areas}
    table = {
        a.scheme: {
            "total": a.total,
            "overhead": a.redundancy_overhead,
            "redundant_pes": a.redundant_pes,
            "mux": a.mux,
            "register_files": a.register_files,
        }
        for a in areas
    }
    c = Claims("fig09")
    c.check(
        "HyCA32 total area < RR/CR/DR total area",
        all(by["HyCA32"].total < by[s].total for s in ("RR", "CR", "DR")),
        f"HyCA32={by['HyCA32'].total:.0f} vs RR={by['RR'].total:.0f}",
    )
    c.check(
        "MUX dominates RR/CR/DR redundancy overhead",
        all(by[s].mux > 0.5 * by[s].redundancy_overhead for s in ("RR", "CR", "DR")),
    )
    c.check(
        "HyCA register files consume much less area than its redundant PEs",
        by["HyCA32"].register_files < 0.6 * by["HyCA32"].redundant_pes,
        f"rf={by['HyCA32'].register_files:.1f} vs pes={by['HyCA32'].redundant_pes:.1f}",
    )
    c.check(
        "HyCA overhead scales with DPPU size",
        by["HyCA24"].redundancy_overhead
        < by["HyCA32"].redundancy_overhead
        < by["HyCA40"].redundancy_overhead,
    )
    return {"table": table, "claims": c.items, "all_ok": c.all_ok}
