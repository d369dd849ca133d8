"""AdamW on trees of tensors (nested dicts and lists, the params' layout).

The state is ``{"m", "v", "step", "gnorm"}`` as in the reference: f32
moments mirroring the params, an int32 step and the last global gradient
norm.  The update makes new tensors; nothing is updated in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.tree import pick, tree_leaves, tree_map, tree_map2


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params: Any) -> dict:
    first = tree_leaves(params)[0]
    return {
        "m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
        "gnorm": torch.zeros((), dtype=torch.float32, device=first.device),
    }


def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    """Grads scaled so that their global L2 norm is at most ``max_norm``,
    and the norm before scaling (an f32 0-d tensor)."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), gnorm


def adamw_update(grads: Any, state: dict, params: Any, cfg: AdamWConfig,
                 lr: torch.Tensor | float) -> tuple[Any, dict]:
    """Returns (new_params, new_state).  ``lr`` may be a 0-d tensor (a
    schedule's value)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t

    def upd(p, g, m, v):
        g32 = g.to(torch.float32)
        m2 = cfg.b1 * m + (1 - cfg.b1) * g32
        v2 = cfg.b2 * v + (1 - cfg.b2) * torch.square(g32)
        delta = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m2, v2

    out = tree_map2(upd, params, grads, state["m"], state["v"])
    return pick(out, 0), {"m": pick(out, 1), "v": pick(out, 2), "step": step, "gnorm": gnorm}

