"""Salience: deciding which output channels the array can afford to lose.

The remap planner (:mod:`repro_torch.repair.plan`) needs one number per
residue class (the ``cols`` groups of output channels ``j`` with equal
``j % cols``).  Two estimators:

  * **weight-norm salience**: the L2 norm of each weight column, folded per
    residue class and summed over the weights.  Free: no data.
  * **activation-norm salience**: mean |output| per residue class, recorded
    by running calibration batches through a :class:`SalienceProbe`, a
    duck-typed FTContext stand-in.

Both return (cols,) float64 numpy vectors, the planner's input.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Mapping

import numpy as np
import torch

from repro_torch.core.ftcontext import SITES, plain_matmul
from repro_torch.tree import stacked_leaves

__all__ = [
    "fold_channel_salience",
    "weight_salience",
    "site_weight_salience",
    "SalienceProbe",
]


def fold_channel_salience(channel_salience, cols: int) -> np.ndarray:
    """(N,) per-channel salience -> (cols,) per-residue-class salience: class
    ``c`` owns channels ``c, c+cols, c+2*cols, ...``."""
    s = np.asarray(channel_salience, np.float64).ravel()
    pad = (-s.size) % cols
    return np.pad(s, (0, pad)).reshape(-1, cols).sum(axis=0)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# the column blocks of a layer stack's norms, summed side by side
_THREADS = min(8, os.cpu_count() or 1)


def _carried_squares(rows: list, c0: int, c1: int) -> np.ndarray:
    """Columns ``c0:c1`` of the stacked rows' f32 sums of squares, carried
    from one layer's rows into the next."""
    acc = buf = None
    for r in rows:
        r = r[:, c0:c1]
        if acc is None:
            acc = np.add.reduce(r * r, axis=0)
            continue
        if buf is None or buf.shape[0] != r.shape[0] + 1:
            buf = np.empty((r.shape[0] + 1, c1 - c0), acc.dtype)
        buf[0] = acc
        np.multiply(r, r, out=buf[1:])
        acc = np.add.reduce(buf, axis=0)
    return acc


def _column_norms(layers: list) -> np.ndarray:
    """``np.linalg.norm(stack.reshape(-1, n), axis=0)`` of the leaf stacked
    over ``layers``, bit for bit, one layer at a time: the f32 sums of
    squares are carried from one layer's rows into the next, so the host
    never holds the stack or its squares (deepseek-moe-16b's expert ``down``
    stacks to 19.9 GB).  numpy's reduction over the rows of a matrix adds
    them one after another, so the carried sum is the stacked one.  Blocks
    of at least two columns are summed in threads (numpy lets go of the
    GIL): a column's sum is its own.  A single column is reduced pairwise
    instead, so it is stacked: a column a layer is small."""
    rows = [_host(t) for t in layers]
    n = rows[0].shape[-1]
    if n == 1:
        col = np.concatenate([r.reshape(-1, 1) for r in rows])
        return np.linalg.norm(col, axis=0)
    rows = [r.reshape(-1, n) for r in rows]
    cuts = np.linspace(0, n, min(_THREADS, n // 2) + 1).astype(int)
    with ThreadPoolExecutor(len(cuts) - 1) as pool:
        parts = list(pool.map(lambda c: _carried_squares(rows, *c), zip(cuts[:-1], cuts[1:])))
    return np.sqrt(np.concatenate(parts))


def weight_salience(params, cols: int) -> np.ndarray:
    """(cols,) aggregate weight-norm salience over every >= 2-D float leaf of
    ``params`` (column L2 norms of the trailing axis, folded per residue
    class).  The serving ModelBundle's one plan for all sites.

    ``params`` in this package's layout (one dict per layer) are read as the
    reference reads its stacked params: each leaf of a layer stack
    (``blocks``, ``dense_blocks``, the encoder's ``layers``) stacked over
    the layers (so a norm scale counts as a (L, d) weight, and a column
    norm runs over every layer's rows), leaves in sorted-key order.  A
    stack's column norms are taken layer by layer (:func:`_column_norms`),
    each other leaf's by ``np.linalg.norm``; both are numpy's on the f32
    leaves, so the result is the reference's bit for bit."""
    s = np.zeros(cols, np.float64)
    for _, leaves, stacked in stacked_leaves(params):
        a = _host(leaves[0])
        if a.ndim + stacked < 2 or not np.issubdtype(a.dtype, np.floating):
            continue
        col_norm = _column_norms(leaves) if stacked else np.linalg.norm(a.reshape(-1, a.shape[-1]), axis=0)
        s += fold_channel_salience(col_norm, cols)
    return s


def site_weight_salience(site_weights: Mapping[str, Iterable], cols: int) -> dict[str, np.ndarray]:
    """Per-site salience from an explicit {site: [weight matrices]} mapping,
    for per-site plan dicts."""
    out = {}
    for site, ws in site_weights.items():
        if site not in SITES:
            raise ValueError(f"unknown site {site!r}; known: {SITES}")
        out[site] = weight_salience(list(ws), cols)
    return out


class SalienceProbe:
    """Duck-typed FTContext stand-in that records instead of corrupting.

    Run one calibration forward with the probe as ``ftc`` and it accumulates
    mean |output| per residue class at every protected call site:

        probe = SalienceProbe(cols=hyca.cols)
        forward(params, cfg, calib_batch, ftc=probe)
        plan = remap_plan(state, hyca, probe.salience())

    Implements the surface the models touch (``active``, ``protects``,
    ``n_protected_layers``, ``matmul``, ``einsum``) with plain matmuls, so
    the recorded statistics are the production activations."""

    def __init__(self, cols: int):
        self.cols = cols
        self._sums: dict[str, torch.Tensor] = {}
        self._counts: dict[str, int] = {}

    @property
    def active(self) -> bool:
        return True

    def protects(self, site: str) -> bool:
        if site not in SITES:
            raise ValueError(f"unknown site {site!r}; known: {SITES}")
        return True

    def n_protected_layers(self, n_layers: int) -> int:
        return n_layers

    def matmul(self, x: torch.Tensor, w: torch.Tensor, *, site: str) -> torch.Tensor:
        self.protects(site)
        out = plain_matmul(x, w)
        self._record(site, out)
        return out

    def einsum(self, spec: str, x: torch.Tensor, w: torch.Tensor, *, site: str) -> torch.Tensor:
        self.protects(site)
        out = torch.einsum(spec, x, w)
        self._record(site, out)
        return out

    def _record(self, site: str, out: torch.Tensor) -> None:
        a = out.detach().to(torch.float64).abs()
        per_channel = a.reshape(-1, a.shape[-1]).mean(dim=0)
        pad = (-per_channel.numel()) % self.cols
        folded = torch.nn.functional.pad(per_channel, (0, pad)).reshape(-1, self.cols).sum(dim=0)
        self._sums[site] = self._sums[site] + folded if site in self._sums else folded
        self._counts[site] = self._counts.get(site, 0) + 1

    def salience(self, site: str | None = None) -> np.ndarray:
        """(cols,) activation salience: one site's, or all sites pooled."""
        if site is not None:
            if site not in self._sums:
                raise KeyError(f"no activations recorded for site {site!r}")
            return _host(self._sums[site]) / self._counts[site]
        if not self._sums:
            raise ValueError("probe has recorded no activations yet")
        return sum(_host(v) for v in self._sums.values()) / sum(self._counts.values())

    def site_salience(self) -> dict[str, np.ndarray]:
        return {s: _host(self._sums[s]) / self._counts[s] for s in self._sums}
