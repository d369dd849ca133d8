"""Runtime fault detection with reserved DPPU groups (paper Section IV-D):
the analytical scan-cycle model the ScanEngine honours.

With ``p`` DPPU groups reserved for scanning, ``p`` PEs are probed in
parallel, so a whole-array sweep takes ``⌈Row·Col/p⌉ + Col`` cycles (p=1
recovers the paper's ``Row·Col + Col``).  The layer-coverage model and the
functional scan simulation come with the campaign slice.
"""
from __future__ import annotations


def detection_cycles(rows: int, cols: int, *, dppu_groups: int = 1) -> int:
    """⌈Row·Col/p⌉ + Col (Section IV-D, p-parallel): ``dppu_groups`` PEs
    scanned per cycle plus the final Col-cycle comparison drain."""
    if dppu_groups < 1:
        raise ValueError(f"dppu_groups must be >= 1, got {dppu_groups}")
    return -(-rows * cols // dppu_groups) + cols
