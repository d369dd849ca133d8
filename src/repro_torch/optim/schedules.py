"""Learning-rate schedules; ``step`` may be a 0-d tensor."""
from __future__ import annotations

import math

import torch


def cosine_warmup(step, *, peak_lr: float, warmup: int, total: int, floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` then cosine decay to ``floor * peak_lr``,
    in f32, as a 0-d tensor on ``step``'s device."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * s / max(warmup, 1)
    frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor * peak_lr + (1 - floor) * peak_lr * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(s < warmup, warm, cos)
