"""Plain PyTorch oracles of the kernel tier, at tile granularity, under the
JAX package's names.

Tile↔PE mapping shared by the kernels and these oracles: the (M, N) output is
tiled (bm, bn); tile (ti, tj) is "executed by" virtual PE(ti % rows,
tj % cols) — the output-stationary mapping of the paper at tile granularity
(the engine's per-element mapping is the bm = bn = 1 special case).

Each oracle is built on the plain twin of its kernel (one plain version per
function): :func:`os_array_matmul_ref` is ``os_array_matmul_plain``,
:func:`dppu_recompute_ref` is ``dppu_recompute_plain`` followed by
``scatter_overwrite``, and :func:`corrupt_f32` is the engine's stuck-at.
:func:`abft_syndromes_ref` is the host float64 oracle of the ABFT syndromes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import _corrupt_elems
from repro_torch.kernels.dppu_recompute import dppu_recompute_plain, scatter_overwrite
from repro_torch.kernels.os_array_matmul import _tile_grids, os_array_matmul_plain

os_array_matmul_ref = os_array_matmul_plain


def corrupt_f32(out: torch.Tensor, bit: torch.Tensor, val: torch.Tensor,
                faulty: torch.Tensor) -> torch.Tensor:
    """Stuck-at on the f32 accumulator bit pattern wherever ``faulty``."""
    return _corrupt_elems(out.to(torch.float32), bit, val, faulty)


def dppu_recompute_ref(x, w, corrupted: torch.Tensor, fpt: torch.Tensor, *, bm: int,
                       bn: int) -> torch.Tensor:
    """DPPU oracle: recompute the output tiles named by the (tile-level) FPT
    ``(F, 2)`` (``-1`` padded) and overwrite them in a copy of ``corrupted``."""
    tiles = dppu_recompute_plain(x, w, fpt, bm=bm, bn=bn)
    return scatter_overwrite(corrupted.clone(), tiles, fpt, bm=bm, bn=bn)


def ft_matmul_ref(x, w, pe_bit, pe_val, pe_faulty, pe_repaired, *, bm: int, bn: int,
                  pe_prune: torch.Tensor | None = None) -> torch.Tensor:
    """Fused fault-tolerant matmul oracle: healthy/repaired tiles exact,
    faulty-unrepaired tiles stuck-at-corrupted at tile→PE granularity, and
    pruned PEs zeroed at ELEMENT granularity (``out[i, j] -> PE(i % rows,
    j % cols)`` at any block size)."""
    out = os_array_matmul_plain(x, w, pe_bit, pe_val, pe_faulty & ~pe_repaired, bm=bm, bn=bn)
    if pe_prune is not None:
        rows, cols = pe_prune.shape
        ei, ej = _tile_grids(out.shape[0], out.shape[1], 1, 1, rows, cols, out.device)
        out = torch.where(pe_prune[ei, ej], torch.zeros_like(out), out)
    return out


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a, np.float64)


def abft_syndromes_ref(x, w, out, wc=None):
    """Host float64 ABFT syndrome oracle (numpy): what the carried checksum
    lanes should disagree with ``out`` by.  Returns ``(col_syndrome (N,),
    row_syndrome (M,) | None)``:

        col_syndrome = colsum(x) @ w - out.sum(rows)
        row_syndrome = x @ wc        - out.sum(cols)   (wc: encode-time)

    Everything is widened to f64 before any reduction, so for the int32 and
    f32 datapaths the oracle is exact up to 2^53.  Takes tensors on any
    device or numpy arrays."""
    x64, w64, o64 = _f64(x), _f64(w), _f64(out)
    x64 = x64.reshape(-1, x64.shape[-1])
    o64 = o64.reshape(-1, o64.shape[-1])
    col = x64.sum(axis=0) @ w64 - o64.sum(axis=0)
    row = None
    if wc is not None:
        row = x64 @ _f64(wc).reshape(-1) - o64.sum(axis=-1)
    return col, row
