"""Shared building blocks: norms, RoPE, the FFN, init helpers and the losses.

Params are plain dicts of tensors; the dtype order of every op follows the
JAX package exactly, so both compute the same function.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.ftcontext import site_matmul
from repro_torch.dist.sharding import grad_in_place, is_dtensor, shard

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
    return x * inv * _replicated(g.to(x.dtype))


def _replicated(p: torch.Tensor) -> torch.Tensor:
    """A norm's scale or bias read whole.  The param specs shard a stacked
    ``(L, d)`` scale over ``model`` on ``d``; on DTensors the scale is
    gathered (``d`` elements), so that the activation it multiplies stays
    replicated and is not gathered before each projection."""
    return shard(p, None)


def layernorm_init(d: int, *, device="cuda") -> Params:
    return {"g": torch.ones((d,), dtype=torch.float32, device=device),
            "b": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    # the mean in f32, cast to x.dtype and subtracted in x.dtype; the variance
    # from the f32 copy against the cast mean; inv cast to x.dtype — the JAX
    # package's order
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True).to(x.dtype)
    var = (x32 - mu.to(torch.float32)).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return (x - mu) * inv * _replicated(p["g"].to(x.dtype)) + _replicated(p["b"].to(x.dtype))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh form of GELU, ``jax.nn.gelu``'s default."""
    return F.gelu(x, approximate="tanh")


def rope_freqs(head_dim: int, theta: float = 10000.0, *, device="cuda") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


@dataclasses.dataclass(frozen=True)
class YarnScaling:
    """YaRN's RoPE scaling (arXiv:2309.00071) as DeepSeek-V3 publishes it
    (HF ``DeepseekV3YarnRotaryEmbedding``): each frequency blends the base
    one with the one ``factor`` times slower, by a ramp over the dims
    between the rotation counts ``beta_fast`` and ``beta_slow`` at the
    pre-scaling context ``original_max_position_embeddings``; cos and sin
    are scaled by :meth:`cos_sin_scale`, attention's softmax scale by
    :meth:`softmax_scale_factor`."""

    factor: float
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0
    original_max_position_embeddings: int = 4096

    def _mscale(self, m: float) -> float:
        return 1.0 if self.factor <= 1 else 0.1 * m * math.log(self.factor) + 1.0

    def cos_sin_scale(self) -> float:
        return self._mscale(self.mscale) / self._mscale(self.mscale_all_dim)

    def softmax_scale_factor(self) -> float:
        return self._mscale(self.mscale_all_dim) ** 2

    def inv_freq(self, d: int, theta: float, *, device="cuda") -> torch.Tensor:
        """(d/2,) f32: ``inter * ramp + extra * (1 - ramp)``, ``extra`` the
        base frequencies and ``inter`` them over ``factor``."""
        def dim_of(rotations):
            return d * math.log(self.original_max_position_embeddings / (rotations * 2 * math.pi)) / (
                2 * math.log(theta))

        low = max(math.floor(dim_of(self.beta_fast)), 0)
        high = min(math.ceil(dim_of(self.beta_slow)), d - 1)
        extra = rope_freqs(d, theta, device=device)
        inter = 1.0 / (self.factor * theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=device) / d))
        ramp = torch.clamp((torch.arange(d // 2, dtype=torch.float32, device=device) - low)
                           / (high - low if high != low else 0.001), 0, 1)
        keep = 1.0 - ramp  # HF's inv_freq_mask, and its order of operations
        return inter * (1 - keep) + extra * keep


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0, *,
               scaling: YarnScaling | None = None, interleave: bool = False) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S).  Runs in f32.  On DTensors
    (under a ``DeviceMesh``'s :func:`~repro_torch.dist.sharding.use_mesh`)
    the plain ``freqs`` table is read as replicated: ``use_mesh`` runs the
    model under ``implicit_replication``.

    ``scaling``: YaRN's frequencies and cos/sin scale.  ``interleave``:
    the rotated pairs are (x[2i], x[2i+1]), DeepSeek-V3's layout: they are
    gathered to the halves first (HF's ``view(d/2, 2).transpose``), and the
    result stays in the halves' layout, which q and k share."""
    d = x.shape[-1]
    if interleave:
        x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).reshape(x.shape)
    freqs = rope_freqs(d, theta, device=x.device) if scaling is None else scaling.inv_freq(d, theta, device=x.device)
    ang = positions[..., :, None, None].to(torch.float32) * freqs  # (..., S, 1, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if scaling is not None and scaling.cos_sin_scale() != 1.0:
        cos, sin = cos * scaling.cos_sin_scale(), sin * scaling.cos_sin_scale()
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int, *, device="cuda") -> torch.Tensor:
    """(n, d) f32 table: sin on the even features, cos on the odd ones."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device) * (-math.log(10000.0) / d))
    pe = torch.zeros((n, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def split_heads(x: torch.Tensor, n_heads: int, head_dim: int, axis: str = "heads") -> torch.Tensor:
    """(B, S, H * D) -> (B, S, H, D).  On a DTensor the projection is first
    constrained with ``axis`` checked against H: where H does not divide the
    mesh axis (granite-moe's 24 heads on 16 devices) the resolver's fallback
    replicates the last dim, so the unflatten is even; where it divides, the
    column-parallel layout already is that and no collective is issued."""
    b, s, _ = x.shape
    x = shard(x, "batch", "seq", axis, dims=(b, s, n_heads))
    return x.reshape(b, s, n_heads, head_dim)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(..., H, D) -> (..., H * D), the inverse of :func:`split_heads`; on a
    DTensor its gradient flows back in the heads' own placements
    (:func:`~repro_torch.dist.sharding.grad_in_place`)."""
    return grad_in_place(x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1]))


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
    out = mm(h, p["down"])
    if out.dim() == 3:  # the row-parallel product's reduction (the reference's layers.py:131)
        out = shard(out, "batch", "seq", "embed")
    return out


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL in f32; labels < 0 are masked out."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    if is_dtensor(logits):  # vocab-sharded: each device picks the label's logit from its own columns
        cols = torch.arange(logits.shape[-1], device=logits.device)
        ll = torch.where(cols == labels.clamp(min=0).long()[..., None], logits, 0.0).sum(-1)
    else:
        ll = torch.gather(logits, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    return torch.sum((lse - ll) * mask) / torch.clamp(mask.sum(), min=1.0)


def streamed_cross_entropy(x: torch.Tensor, table: torch.Tensor, labels: torch.Tensor, n_chunks: int,
                           true_vocab: int, ftc=None) -> torch.Tensor:
    """NLL of ``x @ table.T`` computed in vocab chunks, so the (B, S, V)
    logits are never built whole.  Each chunk runs under
    ``torch.utils.checkpoint``, so the backward recomputes its logits
    instead of keeping them (the reference's ``jax.checkpoint``).

    table: (V, d) with V % n_chunks == 0; rows >= ``true_vocab`` are
    padding.  With a context that protects the head, the label's logit is
    taken from the same (possibly corrupted) chunk panel as the normaliser;
    otherwise it is a row gather of the table."""
    b, s, d = x.shape
    v = table.shape[0]
    if v % n_chunks:
        raise ValueError(f"vocab {v} does not split into {n_chunks} chunks")
    tc = v // n_chunks
    xf = x.reshape(b * s, d)
    lab = labels.reshape(-1).clamp(min=0).long()
    head_mm = site_matmul(ftc, "head")
    fault_path = ftc is not None and ftc.protects("head")
    cols = torch.arange(tc, device=x.device)

    def chunk(m, acc, llc, xf, ci: int):
        rows = table[ci * tc:(ci + 1) * tc].to(x.dtype)
        lg = head_mm(xf, rows.T).to(torch.float32)  # (N, tc)
        lg = lg.masked_fill(ci * tc + cols >= true_vocab, -1e30)
        m2 = torch.maximum(m, lg.max(dim=-1).values)
        acc = acc * torch.exp(m - m2) + torch.exp(lg - m2[:, None]).sum(-1)
        if fault_path:  # the label's logit out of this chunk's panel
            inchunk = (lab >= ci * tc) & (lab < (ci + 1) * tc)
            col = (lab - ci * tc).clamp(0, tc - 1)
            got = torch.gather(lg, 1, col[:, None])[:, 0]
            llc = torch.where(inchunk, got, llc)
        return m2, acc, llc

    n = b * s
    m = torch.full((n,), -1e30, dtype=torch.float32, device=x.device)
    acc = torch.zeros((n,), dtype=torch.float32, device=x.device)
    llc = torch.zeros((n,), dtype=torch.float32, device=x.device)
    for ci in range(n_chunks):
        m, acc, llc = checkpoint(chunk, m, acc, llc, xf, ci, use_reentrant=False)
    if fault_path:
        ll = llc
    else:
        ll = torch.sum(xf * table[lab].to(x.dtype), dim=-1).to(torch.float32)
    lse = m + torch.log(acc)
    mask = (labels.reshape(-1) >= 0).to(torch.float32)
    return torch.sum((lse - ll) * mask) / torch.clamp(mask.sum(), min=1.0)
