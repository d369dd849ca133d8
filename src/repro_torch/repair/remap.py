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


def _leaves(tree) -> Iterable[np.ndarray]:
    """The leaves in the reference's order (dict keys sorted, lists in
    order), each leaf of a layer stack stacked over its layers, one leaf at
    a time: a full-width stack of every leaf at once would double the
    host's copy of the params."""
    for _, leaves, stacked in stacked_leaves(tree):
        yield np.stack([_host(t) for t in leaves]) if stacked else _host(leaves[0])


def weight_salience(params, cols: int) -> np.ndarray:
    """(cols,) aggregate weight-norm salience over every >= 2-D float leaf of
    ``params`` (column L2 norms of the trailing axis, folded per residue
    class).  The serving ModelBundle's one plan for all sites.

    ``params`` in this package's layout (one dict per layer) are read as the
    reference reads its stacked params: each leaf of a layer stack
    (``blocks``, ``dense_blocks``, the encoder's ``layers``) stacked over
    the layers (so a norm scale counts as a (L, d) weight, and a column
    norm runs over every layer's rows), leaves in sorted-key order.  The norms are numpy's on the f32 leaves, so the
    result is the reference's bit for bit."""
    s = np.zeros(cols, np.float64)
    for a in _leaves(params):
        if a.ndim >= 2 and np.issubdtype(a.dtype, np.floating):
            col_norm = np.linalg.norm(a.reshape(-1, a.shape[-1]), axis=0)
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
