"""Fig. 15: unified vs grouped DPPU scalability (sizes 16…48, array 32×32; the twin
of the reference's fig15 benchmark).

Paper claims: the grouped DPPU's effective capacity scales strictly with its
size; the unified DPPU only scales at sizes that divide/multiply Col=32
(16, 32) and is under-utilized at 24, 40, 48.
"""
from __future__ import annotations

from repro_torch.bench.common import Claims
from repro_torch.core.redundancy import DPPUConfig, effective_capacity
from repro_torch.core.reliability import evaluate_scheme


def run(quick: bool = False, device="cuda") -> dict:
    n = 300 if quick else 2000
    sizes = [16, 24, 32, 40, 48]
    caps = {
        "unified": {s: effective_capacity(DPPUConfig(size=s, unified=True), 32) for s in sizes},
        "grouped": {s: effective_capacity(DPPUConfig(size=s, group_size=8), 32) for s in sizes},
    }
    # FFP at a PER where capacity differences matter (expected faults ~ 26)
    per = 0.0255
    ffp = {}
    for kind in ("unified", "grouped"):
        for s in sizes:
            cfg = DPPUConfig(size=s, unified=(kind == "unified"), group_size=8)
            r = evaluate_scheme("HyCA", per, n_configs=n, dppu=cfg)
            ffp.setdefault(kind, {})[s] = r.fully_functional_prob

    c = Claims("fig15")
    c.check(
        "grouped capacity scales strictly with DPPU size",
        all(caps["grouped"][sizes[i]] < caps["grouped"][sizes[i + 1]] for i in range(len(sizes) - 1)),
        str(caps["grouped"]),
    )
    c.check(
        "unified capacity scales at 16 and 32 only",
        caps["unified"][16] == 16 and caps["unified"][32] == 32
        and caps["unified"][24] < 24 and caps["unified"][40] < 40 and caps["unified"][48] < 48,
        str(caps["unified"]),
    )
    c.check(
        "grouped FFP >= unified FFP at sizes 24/40/48",
        all(ffp["grouped"][s] >= ffp["unified"][s] - 0.02 for s in (24, 40, 48)),
        f"grouped={ffp['grouped']}, unified={ffp['unified']}",
    )

    # grouping also buys scan parallelism: p reserved groups probe p PEs per
    # cycle, and the runtime ScanEngine achieves exactly the analytical
    # ceil(Row*Col/p) + Col — the model and the engine agree by construction
    from repro_torch.core.detection import detection_cycles
    from repro_torch.core.scan import build_scan_engine

    scan_cycles = {}
    engine_agrees = True
    for block in (1, 2, 4, 8, 16, 32):
        engine = build_scan_engine(32, 32, block_rows=block, device=device)
        p = engine.cfg.dppu_groups
        scan_cycles[p] = detection_cycles(32, 32, dppu_groups=p)
        # independent derivations: the engine's probe steps a sweep
        # (rows // block_rows probe steps) + the Col drain vs the model's
        # ceil(Row*Col/p) + Col
        achieved = engine.cfg.steps_per_sweep + 32
        engine_agrees &= achieved == scan_cycles[p]
    c.check(
        "ScanEngine sweep latency equals the p-parallel cycle model at every grouping",
        engine_agrees,
        str(scan_cycles),
    )
    ps = sorted(scan_cycles)
    c.check(
        "scan latency strictly decreases with the scan-group count",
        all(scan_cycles[a] > scan_cycles[b] for a, b in zip(ps, ps[1:])),
        str(scan_cycles),
    )
    return {
        "capacity": caps, "ffp": ffp, "per": per,
        "scan_cycles_by_groups": scan_cycles,
        "claims": c.items, "all_ok": c.all_ok,
    }
