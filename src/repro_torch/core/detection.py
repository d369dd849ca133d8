"""Runtime fault detection with reserved DPPU groups (paper Section IV-D).

One DPPU group of S lanes re-executes an S-MAC slice of one scanned PE per
cycle and checks ``AR == BAR + PR`` against the checking-list buffer (CLB).
With ``p`` DPPU groups reserved for scanning, ``p`` PEs are probed in
parallel, so a whole-array sweep takes ``⌈Row·Col/p⌉ + Col`` cycles (p=1
recovers the paper's ``Row·Col + Col``).  A layer is "covered" iff that
scan fits inside the layer's compute time.

:meth:`repro_torch.core.scan.ScanConfig.scan_cycles` reports exactly
``detection_cycles(rows, cols, dppu_groups=block_rows*cols)``, so the
analytical model and the ScanEngine agree by construction.
:func:`scan_array` drives the ScanEngine's sweep (the CUDA probe kernel on a
card) over a fault map.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.array_sim import ConvLayer, layer_cycles


def detection_cycles(rows: int, cols: int, *, dppu_groups: int = 1) -> int:
    """⌈Row·Col/p⌉ + Col (Section IV-D, p-parallel): ``dppu_groups`` PEs
    scanned per cycle plus the final Col-cycle comparison drain."""
    if dppu_groups < 1:
        raise ValueError(f"dppu_groups must be >= 1, got {dppu_groups}")
    return -(-rows * cols // dppu_groups) + cols


def clb_bytes(cols: int, acc_bytes: int = 4, *, dppu_groups: int = 1) -> int:
    """CLB = 4·W·Col bytes per scanning group: Ping-Pong × (BAR, AR) × Col
    entries of W-byte accumulators (Section IV-D); each of the ``p`` groups
    owns a private ping-pong region."""
    if dppu_groups < 1:
        raise ValueError(f"dppu_groups must be >= 1, got {dppu_groups}")
    return 4 * acc_bytes * cols * dppu_groups


def layer_covered(layer: ConvLayer, rows: int, cols: int, *, dppu_groups: int = 1) -> bool:
    return detection_cycles(rows, cols, dppu_groups=dppu_groups) <= layer_cycles(layer, rows, cols)


def coverage(layers: list[ConvLayer], rows: int, cols: int, *, dppu_groups: int = 1) -> tuple[int, int]:
    """(#layers whose execution fully covers one whole-array scan, #layers)."""
    covered = sum(layer_covered(l, rows, cols, dppu_groups=dppu_groups) for l in layers)
    return covered, len(layers)


# --------------------------------------------------------------------------- #
# functional scan model over the batched ScanEngine
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class ScanResult:
    detected: np.ndarray  # bool (rows, cols)
    false_positives: int
    false_negatives: int


def scan_array(
    rng: np.random.Generator,
    fault_map: np.ndarray,
    *,
    s_lanes: int = 8,
    fault_visibility: float = 1.0,
    block_rows: int | None = None,
    device="cuda",
) -> ScanResult:
    """One full scan of ``fault_map`` through the ScanEngine on ``device``.

    Each faulty PE corrupts the checked partial result with probability
    ``fault_visibility`` per window (the same numpy draw as the reference).
    The visible faults are handed to the engine as bit-30 stuck-at-1
    signatures; the shared probe recipe bounds |acc| far below 2^30, so the
    complementary pair exposes every one of them and the engine detects
    exactly the visible set."""
    from repro_torch.core.engine import empty_fault_state  # deferred: scan imports this module
    from repro_torch.core.scan import build_scan_engine, probe_operands

    rows, cols = fault_map.shape
    visible = rng.random((rows, cols)) < fault_visibility
    effective = fault_map & visible
    engine = build_scan_engine(rows, cols, window=s_lanes, block_rows=block_rows or rows,
                               confirm_hits=1, device=device)
    dev = torch.device(engine.device)
    px, pw = (torch.from_numpy(a).to(dev) for a in probe_operands(rows, cols, 0, s_lanes))
    state, _ = engine.sweep(
        engine.init_state(), empty_fault_state(1, device=dev),
        torch.from_numpy(effective).to(dev),
        torch.full((rows, cols), 30, dtype=torch.int32, device=dev),
        torch.ones((rows, cols), dtype=torch.int32, device=dev), px, pw,
    )
    detected = engine.confirmed(state).cpu().numpy()
    fn = int((fault_map & ~detected).sum())
    fp = int((detected & ~fault_map).sum())
    return ScanResult(detected=detected, false_positives=fp, false_negatives=fn)


def scans_to_full_detection(rng: np.random.Generator, fault_map: np.ndarray, fault_visibility: float,
                            max_scans: int = 64, *, device="cuda") -> int:
    """#sequential whole-array scans until every faulty PE has been flagged."""
    remaining = fault_map.copy()
    for i in range(1, max_scans + 1):
        res = scan_array(rng, remaining, fault_visibility=fault_visibility, device=device)
        remaining &= ~res.detected
        if not remaining.any():
            return i
    return max_scans
