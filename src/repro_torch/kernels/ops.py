"""The kernel tier's entry points: the paper's two-pass protected matmul.

Paper Fig. 5 at tile granularity: the faulty 2-D array computes every output
(:func:`faulty_array_matmul`, the ``os_array_matmul`` kernel), the DPPU
recomputes the tiles of the PEs it repairs (the ``dppu_recompute`` kernel),
and the output buffer takes the recomputed tiles (:func:`scatter_overwrite`).
:func:`hyca_protected_matmul_fused` is the single-pass variant at the same
tile granularity.

Every entry point follows its operands' device: CUDA tensors launch the
kernels, CPU tensors compute their plain twins.  No wrapper falls back to a
plain version when a build or a launch fails; it raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.engine import FaultState, HyCAConfig, _pe_grids, repaired_grid
from repro_torch.kernels import ref
from repro_torch.kernels.dppu_recompute import dppu_recompute, scatter_overwrite
from repro_torch.kernels.os_array_matmul import os_array_matmul


def fault_grids(state: FaultState, rows: int, cols: int, capacity: int):
    """FPT → dense (rows, cols) bit/val/faulty/repaired grids (the AGU):
    int32, int32, bool, bool tensors on the state's device, built there with
    tensor ops.  ``repaired`` is the first ``capacity`` FPT entries, since the
    FPT is leftmost-sorted."""
    bit, val, faulty = _pe_grids(state, rows, cols)
    repaired = repaired_grid(state, rows, cols, capacity)
    return bit, val, faulty, repaired


# the JAX package's host and traced AGUs are one function here: nothing traces
fault_grids_device = fault_grids


def faulty_array_matmul(x: torch.Tensor, w: torch.Tensor, state: FaultState, cfg: HyCAConfig, *,
                        bm: int = 128, bn: int = 128, bk: int = 128) -> torch.Tensor:
    """Pass 1 of the paper pipeline: the faulty 2-D array's matmul."""
    bit, val, faulty, _ = fault_grids(state, cfg.rows, cfg.cols, cfg.capacity)
    return os_array_matmul(x, w, bit, val, faulty, bm=bm, bn=bn, bk=bk, rows=cfg.rows, cols=cfg.cols)


def tile_fault_table(state: FaultState, cfg: HyCAConfig, gm: int, gn: int) -> list[tuple[int, int]]:
    """The tile-level FPT: every (gm, gn) output tile of a repaired PE, in
    FPT order (leftmost-first), truncated to DPPU capacity worth of *PEs*
    (each PE may own many tiles)."""
    tiles = []
    for i, (r, c) in enumerate(state.fpt.tolist()):
        if r < 0 or i >= cfg.capacity:
            continue
        for ti in range(r, gm, cfg.rows):
            for tj in range(c, gn, cfg.cols):
                tiles.append((ti, tj))
    return tiles


def hyca_protected_matmul_twopass(x: torch.Tensor, w: torch.Tensor, state: FaultState,
                                  cfg: HyCAConfig, *, bm: int = 128, bn: int = 128,
                                  bk: int = 128) -> torch.Tensor:
    """Paper-faithful two-pass pipeline: faulty array pass + DPPU recompute +
    output-buffer overwrite (Fig. 5).  With no tile to recompute it is the
    first pass alone."""
    corrupted = faulty_array_matmul(x, w, state, cfg, bm=bm, bn=bn, bk=bk)
    m, n = corrupted.shape
    tiles = tile_fault_table(state, cfg, m // bm, n // bn)
    if not tiles:
        return corrupted
    tile_fpt = torch.tensor(tiles, dtype=torch.int32)
    recomputed = dppu_recompute(x, w, tile_fpt, bm=bm, bn=bn, bk=bk)
    return scatter_overwrite(corrupted, recomputed, tile_fpt, bm=bm, bn=bn)


def hyca_protected_matmul_fused(x: torch.Tensor, w: torch.Tensor, state: FaultState,
                                cfg: HyCAConfig, *, bm: int = 128, bn: int = 128,
                                bk: int = 128) -> torch.Tensor:
    """Single pass at the two-pass pipeline's tile granularity: repaired PEs
    are never corrupted, unrepaired ones are.  With no RepairPlan that is
    exactly the faulty array's matmul with ``faulty & ~repaired`` as its
    faulty grid (``ref.ft_matmul_ref`` against ``ref.os_array_matmul_ref``),
    so this launches the ``os_array_matmul`` kernel with that grid.  The
    serving kernel ``ft_matmul`` keeps its element placement and gets no
    tile-granular mode."""
    bit, val, faulty, repaired = fault_grids(state, cfg.rows, cfg.cols, cfg.capacity)
    return os_array_matmul(x, w, bit, val, faulty & ~repaired, bm=bm, bn=bn, bk=bk,
                           rows=cfg.rows, cols=cfg.cols)


__all__ = [
    "os_array_matmul",
    "dppu_recompute",
    "scatter_overwrite",
    "ref",
    "fault_grids",
    "fault_grids_device",
    "faulty_array_matmul",
    "tile_fault_table",
    "hyca_protected_matmul_twopass",
    "hyca_protected_matmul_fused",
]
