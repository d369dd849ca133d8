"""Shared building blocks: norms, RoPE, the FFN and init helpers.

Params are plain dicts of tensors; the dtype order of every op follows the
JAX package exactly, so both compute the same function.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core.ftcontext import site_matmul

Params = dict

DEFAULT_INIT_SCALE = 0.02


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, scale: float | None = None,
               device="cuda") -> torch.Tensor:
    s = DEFAULT_INIT_SCALE if scale is None else scale
    return torch.randn((d_in, d_out), generator=gen, dtype=torch.float32, device=device) * s


def embed_init(gen: torch.Generator, vocab: int, d: int, *, device="cuda") -> torch.Tensor:
    return torch.randn((vocab, d), generator=gen, dtype=torch.float32, device=device) * DEFAULT_INIT_SCALE


def rmsnorm_init(d: int, *, device="cuda") -> torch.Tensor:
    return torch.ones((d,), dtype=torch.float32, device=device)


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    # variance in f32, then inv cast to x.dtype and the scale applied in
    # x.dtype — the JAX package's order
    var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * g.to(x.dtype)


def rope_freqs(head_dim: int, theta: float = 10000.0, *, device="cuda") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S).  Runs in f32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)
    ang = positions[..., :, None, None].to(torch.float32) * freqs  # (..., S, 1, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def ffn_init(gen: torch.Generator, d: int, d_ff: int, gated: bool = True, *, device="cuda") -> Params:
    p = {"up": dense_init(gen, d, d_ff, device=device), "down": dense_init(gen, d_ff, d, device=device)}
    if gated:
        p["gate"] = dense_init(gen, d, d_ff, device=device)
    return p


def ffn(x: torch.Tensor, p: Params, act: Callable = F.silu, ftc=None, site: str = "ffn") -> torch.Tensor:
    """``ftc`` routes the up/gate/down matmuls through the protected virtual
    array; ``ftc=None`` is plain matmuls."""
    mm = site_matmul(ftc, site)
    h = mm(x, p["up"])
    if "gate" in p:
        h = act(mm(x, p["gate"])) * h
    else:
        h = act(h)
    return mm(h, p["down"])
