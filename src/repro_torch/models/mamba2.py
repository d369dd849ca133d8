"""Mamba2 block (SSD, state-space duality), chunked matmul formulation.

The chunked SSD form turns the selective-scan recurrence into blocked
einsums (an attention-like term within a chunk, a state carried from chunk
to chunk), one chunk at a time in a Python loop (the reference scans the
chunks).  The decay exponentials are differences of a monotone cumsum;
the term within a chunk forms exp(cums_i - cums_j) for every (i, j) and
masks j > i afterwards, as the reference does, so at long chunks and large
decays the masked entries overflow to inf (they are masked in the forward;
a gradient through them is not finite, in the reference too).

Only ``in_proj`` (site ``ssm.in``) and ``out_proj`` (``ssm.out``) run on
the protected array; the SSD recurrence stays in plain PyTorch.  Used by
zamba2-1.2b (Mamba2 layers and a shared attention block).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core.ftcontext import site_matmul
from repro_torch.dist.sharding import copy_into, einsum
from repro_torch.models.layers import Params, dense_init, merge_heads, rmsnorm, rmsnorm_init


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    chunk: int = 128
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def mamba2_init(gen: torch.Generator, cfg: Mamba2Config, *, device="cuda") -> Params:
    """One block's f32 params from ``gen``: N(0, 0.02) projections, ``A_log``
    = log(1..H), ``dt_bias`` the inverse softplus of a dt drawn log-uniform
    in [dt_min, dt_max), ``D`` ones."""
    di, n, h = cfg.d_inner, cfg.d_state, cfg.n_heads
    d_in_proj = 2 * di + 2 * n + h  # in_proj emits [z, x, B, C, dt]
    in_proj = dense_init(gen, cfg.d_model, d_in_proj, device=device)
    out_proj = dense_init(gen, di, cfg.d_model, device=device)
    lo, hi = math.log(cfg.dt_min), math.log(cfg.dt_max)
    dt = torch.exp(torch.rand((h,), generator=gen, dtype=torch.float32, device=device) * (hi - lo) + lo)
    return {
        "in_proj": in_proj,
        "out_proj": out_proj,
        "A_log": torch.log(torch.arange(1, h + 1, dtype=torch.float32, device=device)),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),  # inverse softplus
        "D": torch.ones((h,), dtype=torch.float32, device=device),
        "norm": rmsnorm_init(di, device=device),
    }


def _split_in_proj(zxbcdt, cfg: Mamba2Config):
    di, n = cfg.d_inner, cfg.d_state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di], zxbcdt[..., 2 * di:2 * di + n],
            zxbcdt[..., 2 * di + n:2 * di + 2 * n], zxbcdt[..., 2 * di + 2 * n:])


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssd_chunked(x, dt, A_log, B, C, D, chunk: int):
    """x: (B, S, H, P); dt: (B, S, H); B, C: (B, S, N).  Returns y: (B, S,
    H, P) in x's dtype.

    h_t = exp(dt_t a_h) h_{t-1} + dt_t B_t x_tᵀ;  y_t = C_t·h_t + D x_t."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"sequence length {s} is not a multiple of the chunk {q}")
    a = -torch.exp(A_log.to(torch.float32))  # (H,) negative
    x32, dt32, B32, C32 = (t.to(torch.float32) for t in (x, dt, B, C))
    dA = dt32 * a  # (B, S, H) <= 0
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    S = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, s, q):
        # one chunk at a time keeps the (q, q, H) decay tensor transient
        xc, dtc, dac, Bc, Cc = (t[:, c0:c0 + q] for t in (x32, dt32, dA, B32, C32))
        cums = torch.cumsum(dac, dim=1)  # (B, q, H) monotone decreasing
        # within the chunk: L[i, j] = exp(cums_i - cums_j) for j <= i
        li = cums[:, :, None, :] - cums[:, None, :, :]  # (B, q, q, H)
        L = torch.where(mask[None, :, :, None], torch.exp(li), 0.0)
        cb = einsum("bin,bjn->bij", Cc, Bc)  # (B, q, q)
        w = cb[..., None] * L * dtc[:, None, :, :]  # weight j -> i per head
        y_intra = einsum("bijh,bjhp->bihp", w, xc)
        # from the previous chunks: y_i += exp(cums_i) C_i · S_prev
        y_inter = einsum("bih,bin,bhnp->bihp", torch.exp(cums), Cc, S)
        # the chunk's final state: dec·S_prev + Σ_j exp(cums_q - cums_j) dt_j B_j ⊗ x_j
        decay_to_end = torch.exp(cums[:, -1:, :] - cums)  # (B, q, H) <= 1
        S_c = einsum("bjh,bjn,bjhp->bhnp", decay_to_end * dtc, Bc, xc)
        S = S * torch.exp(cums[:, -1, :])[..., None, None] + S_c
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)
    return (y + D[None, None, :, None] * x32).to(x.dtype)


def mamba2_forward(x, p, cfg: Mamba2Config, ftc=None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d), from a zero state."""
    z, xs, B, C, dt = _split_in_proj(site_matmul(ftc, "ssm.in")(x, p["in_proj"]), cfg)
    b, s, _ = x.shape
    dt = _softplus(dt.to(torch.float32) + p["dt_bias"])
    xs = xs.reshape(b, s, cfg.n_heads, cfg.head_dim)
    y = merge_heads(ssd_chunked(xs, dt, p["A_log"], B, C, p["D"], cfg.chunk))
    y = rmsnorm(y * F.silu(z.to(torch.float32)).to(y.dtype), p["norm"])
    return site_matmul(ftc, "ssm.out")(y, p["out_proj"])


# --------------------------------------------------------------------------- #
# decode: O(1) state update per token
# --------------------------------------------------------------------------- #
def mamba2_cache_init(cfg: Mamba2Config, batch: int, dtype=torch.float32, *, device="cuda") -> Params:
    return {"ssm": torch.zeros((batch, cfg.n_heads, cfg.d_state, cfg.head_dim), dtype=dtype, device=device)}


def mamba2_decode(x, p, cfg: Mamba2Config, cache: Params, ftc=None) -> tuple[torch.Tensor, Params]:
    """x: (B, 1, d).  h = exp(dt a) h + dt B ⊗ x; y = C·h + D x.  The new
    state is written into ``cache["ssm"]`` and the same dict is returned,
    as :func:`~repro_torch.models.rwkv6.rwkv6_decode` does."""
    b = x.shape[0]
    z, xs, B, C, dt = _split_in_proj(site_matmul(ftc, "ssm.in")(x, p["in_proj"])[:, 0], cfg)
    dt = _softplus(dt.to(torch.float32) + p["dt_bias"])  # (B, H)
    a = -torch.exp(p["A_log"].to(torch.float32))
    xs = xs.reshape(b, cfg.n_heads, cfg.head_dim).to(torch.float32)
    decay = torch.exp(dt * a)[..., None, None]  # (B, H, 1, 1)
    upd = einsum("bh,bn,bhp->bhnp", dt, B.to(torch.float32), xs)
    S_new = cache["ssm"] * decay + upd
    y = einsum("bn,bhnp->bhp", C.to(torch.float32), S_new)
    y = y + p["D"][None, :, None] * xs
    y = y.reshape(b, 1, cfg.d_inner).to(x.dtype)
    y = rmsnorm(y * F.silu(z.to(torch.float32)).to(y.dtype)[:, None, :], p["norm"])
    copy_into(cache["ssm"], S_new)
    return site_matmul(ftc, "ssm.out")(y, p["out_proj"]), cache
