"""Scan-pipeline throughput: the batched scan engine vs. the legacy per-PE
loop (the twin of the reference's scan_latency benchmark).

Measures the two costs the serving loop pays:

  * ``boot_ms``: the power-on scan (``max_boot_sweeps`` whole-array sweeps)
    through the batched ScanEngine (whole row-blocks probed on the device,
    detections merged into the FPT there) vs. the legacy
    ``sweeps·rows·cols`` host loop (``FaultManager.boot_scan(batched=False)``);
  * ``step_ms``: one background scan step (a ``scan_block``-row probe of
    the grid) as interleaved into every decode step.

For every configuration the batched and legacy paths must confirm the
IDENTICAL fault set (same probes, same complementary pairing: the
correctness claim), and the engine's sweep latency must equal the
``detection_cycles(rows, cols, dppu_groups=p)`` analytical model.  The
headline claim, kept as the reference states it: at the largest array the
batched boot scan is not collapsed against the legacy loop (> 0.5x).
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.bench.common import Claims, device_name, sync
from repro_torch.core.detection import detection_cycles
from repro_torch.core.engine import HyCAConfig
from repro_torch.core.redundancy import DPPUConfig
from repro_torch.serving.fault_manager import FaultInjector, FaultManager, FaultManagerConfig

N_FAULTS = 6


def _manager(rows: int, cols: int, scan_block: int, seed: int, device="cuda") -> FaultManager:
    inj = FaultInjector(rows, cols, seed=seed)
    # random coordinates, detectable-by-construction signatures: a high-bit
    # stuck-at-1 is exposed by one of the complementary +/- probes on any
    # small accumulator (a random low-bit stuck-at can evade every probe
    # whose accumulator already has that bit)
    rng = np.random.default_rng(seed)
    free = np.argwhere(np.ones((rows, cols), bool))
    for r, c in free[rng.choice(len(free), size=N_FAULTS, replace=False)]:
        inj.inject_at(int(r), int(c), bit=30, val=1)
    hyca = HyCAConfig(rows=rows, cols=cols, dppu=DPPUConfig(size=8, group_size=8))
    return FaultManager(hyca, inj, FaultManagerConfig(scan_block=scan_block), device=device)


def _bench_config(rows: int, cols: int, scan_block: int, *, reps: int, claims: Claims, device="cuda") -> dict:
    _manager(rows, cols, scan_block, seed=99, device=device).boot_scan(batched=True)  # warm-up

    t_b = t_l = 0.0
    for rep in range(reps):
        mb = _manager(rows, cols, scan_block, seed=rep, device=device)
        sync(device)
        t0 = time.perf_counter()
        mb.boot_scan(batched=True)  # ends in the host's read of the hit counters
        t_b += time.perf_counter() - t0
        ml = _manager(rows, cols, scan_block, seed=rep, device=device)
        sync(device)
        t0 = time.perf_counter()
        ml.boot_scan(batched=False)
        t_l += time.perf_counter() - t0
        coords_b, coords_l = mb.confirmed_coords(), ml.confirmed_coords()
        claims.check(
            f"{rows}x{cols} block={scan_block} rep={rep}: batched boot scan "
            f"confirms the identical fault set",
            coords_b == coords_l and len(coords_b) == N_FAULTS,
            f"batched={sorted(coords_b)}",
        )

    # steady-state background step (the per-decode-step cost)
    ms = _manager(rows, cols, scan_block, seed=0, device=device)
    ms.scan_step()  # warm-up
    n_steps = 4 * ms.steps_per_sweep
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        ms.scan_step()  # each ends in the host's read of its flags
    step_ms = (time.perf_counter() - t0) / n_steps * 1e3

    engine = ms.engine
    p = engine.cfg.dppu_groups
    # independent derivations: the engine's probe steps a sweep + drain vs
    # the analytical ceil(Row*Col/p) + Col
    achieved = engine.cfg.steps_per_sweep + cols
    claims.check(
        f"{rows}x{cols} block={scan_block}: engine sweep latency equals the "
        f"p-parallel cycle model",
        achieved == detection_cycles(rows, cols, dppu_groups=p),
        f"p={p}: {achieved} cycles",
    )
    return {
        "rows": rows, "cols": cols, "scan_block": scan_block,
        "dppu_groups": p,
        "steps_per_sweep": engine.cfg.steps_per_sweep,
        "model_cycles_per_sweep": engine.cfg.scan_cycles(),
        "boot_batched_ms": round(t_b / reps * 1e3, 3),
        "boot_legacy_ms": round(t_l / reps * 1e3, 3),
        "boot_speedup_x": round(t_l / max(t_b, 1e-9), 2),
        "step_ms": round(step_ms, 3),
    }


def run(quick: bool = False, device="cuda") -> dict:
    reps = 2 if quick else 5
    # 32x32 stays in quick mode: it is where the legacy loop's rows*cols
    # host iterations hurt, i.e. where the headline claim lives
    shapes = [(8, 8), (32, 32)] if quick else [(8, 8), (16, 16), (32, 32)]
    claims = Claims("scan_latency")
    results = []
    for rows, cols in shapes:
        for scan_block in sorted({1, rows // 4, rows}):
            results.append(_bench_config(rows, cols, scan_block, reps=reps, claims=claims, device=device))
    # the headline: at the largest array the batched boot scan is not
    # collapsed against the per-PE loop; the gate is deliberately loose
    # (> 0.5x), the speedup itself is in the JSON
    big = [r for r in results if (r["rows"], r["cols"]) == shapes[-1]]
    best = max(r["boot_speedup_x"] for r in big)
    claims.check(
        f"batched boot scan not collapsed vs the legacy per-PE loop at "
        f"{shapes[-1][0]}x{shapes[-1][1]}",
        best > 0.5,
        f"best speedup {best}x",
    )
    return {
        "device": device_name(device),
        "reps": reps,
        "n_faults": N_FAULTS,
        "results": results,
        "claims": claims.items,
        "all_ok": claims.all_ok,
    }
