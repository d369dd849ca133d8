"""Top-k gradient compression with error feedback.

``compress`` keeps the top ``ratio`` fraction of entries of each leaf by
magnitude and carries the rest forward in the error-feedback accumulator;
the kept entries stay in place, so the step sees the same sparse gradient a
bandwidth-limited exchange would ship.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.tree import map_with_path, stacked_leaves, tree_leaves, tree_map


def ef_init(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def _topk_masks(accs: list[torch.Tensor], k: int) -> list[torch.Tensor]:
    """``|x| >= the k-th largest |x|`` over the tensors of one leaf taken
    together: entries tied with it are all kept, the reference's threshold
    rule."""
    if k >= sum(a.numel() for a in accs):
        return [torch.ones_like(a, dtype=torch.bool) for a in accs]
    thresh = torch.topk(torch.cat([a.abs().reshape(-1) for a in accs]), k).values[-1]
    return [a.abs() >= thresh for a in accs]


def compress(grads: Any, ef: Any, ratio: float) -> tuple[Any, Any, torch.Tensor]:
    """Returns (sparse_grads, new_ef, kept_fraction).

    A leaf is the reference's: the top ``ratio`` of a layer stack's leaf is
    taken over all its layers at once (:func:`~repro_torch.tree.stacked_leaves`),
    and ``kept_fraction`` is the mean of the leaves' kept fractions."""
    out, kept = {}, []
    for (path, gs, _), (_, es, _) in zip(stacked_leaves(grads), stacked_leaves(ef)):
        accs = [g.to(torch.float32) + e for g, e in zip(gs, es)]
        n = sum(a.numel() for a in accs)
        masks = _topk_masks(accs, max(1, int(ratio * n)))
        for i, (g, acc, mask) in enumerate(zip(gs, accs, masks)):
            sent = torch.where(mask, acc, torch.zeros((), dtype=acc.dtype, device=acc.device))
            out[path, i] = (sent.to(g.dtype), acc - sent)
        kept.append(sum(m.sum() for m in masks).to(torch.float32) / n)

    def get(j):
        return lambda path, layer, _: out[path, layer or 0][j]

    return map_with_path(get(0), grads), map_with_path(get(1), grads), torch.mean(torch.stack(kept))


def compressed_bytes(grads: Any, ratio: float, value_bytes: int = 2, index_bytes: int = 4) -> int:
    """Wire bytes of a top-k exchange (values and indices)."""
    n = sum(g.numel() for g in tree_leaves(grads))
    return int(ratio * n) * (value_bytes + index_bytes)
