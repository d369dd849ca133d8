"""RWKV6 ("Finch") block: linear attention with a data-dependent decay per
channel, token-shift mixing, and a squared-ReLU channel-mix FFN.

The sequence mix runs in a chunked matmul form (GLA-style): within a chunk
the decay products factorise as exp(ecw_i) · exp(-cumw_j); chunks are short
enough (CHUNK = 16) that with the decay floor LOGW_MIN the factors stay
inside f32 range, and cross-chunk terms use differences <= 0 only.  The
O(1)-state recurrent form is used for decode and as the test oracle.

Only the projections run on the protected array (sites ``ssm.in``,
``ssm.out``, ``ffn``): the WKV recurrence is elementwise state evolution,
not a matmul, and stays in plain PyTorch, as in the JAX package.  The dtype
order of every op follows the JAX package: the block's params (``mu``,
``w0``, ``u`` included) arrive in ``cfg.dtype``, the r/k/v/decay math runs
in f32, and the gated output is cast back to the input's dtype.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.ftcontext import site_matmul
from repro_torch.dist.sharding import copy_into, einsum, shard
from repro_torch.models.layers import Params, dense_init, merge_heads, rmsnorm, rmsnorm_init, split_heads

CHUNK = 16
LOGW_MIN = -4.0  # per-step log-decay floor; bounds exp(-cumw) <= e^64 in a chunk


@dataclasses.dataclass(frozen=True)
class RWKV6Config:
    d_model: int
    d_ff: int
    head_dim: int = 64
    decay_lora: int = 64

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_dim


def rwkv6_init(gen: torch.Generator, cfg: RWKV6Config, *, device="cuda") -> Params:
    """One block's f32 params from ``gen``, with the reference's
    distributions: uniform [0, 1) shift mixes, N(0, 0.02) projections (the
    decay LoRA pair N(0, 0.01)), the decay bias at -1, N(0, 0.02) bonus."""
    d, h, dk = cfg.d_model, cfg.n_heads, cfg.head_dim

    def dense(d_in, d_out, scale=None):
        return dense_init(gen, d_in, d_out, scale=scale, device=device)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, dtype=torch.float32, device=device)

    return {
        # time mixing
        "mu": uniform(5, d),  # r, k, v, w, g shift mixes
        "wr": dense(d, d),
        "wk": dense(d, d),
        "wv": dense(d, d),
        "wg": dense(d, d),
        "wo": dense(d, d),
        "w0": torch.full((d,), -1.0, dtype=torch.float32, device=device),
        "w_a": dense(d, cfg.decay_lora, 0.01),
        "w_b": dense(cfg.decay_lora, d, 0.01),
        "u": torch.randn((h, dk), generator=gen, dtype=torch.float32, device=device) * 0.02,
        "ln_x": rmsnorm_init(d, device=device),
        "ln1": rmsnorm_init(d, device=device),
        "ln2": rmsnorm_init(d, device=device),
        # channel mixing
        "mu_ff": uniform(2, d),
        "ffk": dense(d, cfg.d_ff),
        "ffv": dense(cfg.d_ff, d),
        "ffr": dense(d, d),
    }


def _token_shift(x: torch.Tensor) -> torch.Tensor:
    """x shifted right by one along S, zeros at position 0."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _rkvwg(x, xs, p, cfg: RWKV6Config, ftc=None):
    """r, k, v and the log-decay (B, S, H, dk) in f32, and the f32 gate
    (B, S, d).  The decay LoRA's second matmul takes the f32 ``tanh`` against
    the ``cfg.dtype`` weight ``w_b``: a mixed pair, promoted to f32."""
    def mix(i):
        return x + (xs - x) * p["mu"][i]

    mm = site_matmul(ftc, "ssm.in")
    r = mm(mix(0), p["wr"])
    k = mm(mix(1), p["wk"])
    v = mm(mix(2), p["wv"])
    # on DTensors the LoRA's sum over its sharded rank is reduced before the
    # bias is added
    lora = shard(mm(torch.tanh(mm(mix(3), p["w_a"]).to(torch.float32)), p["w_b"]), "batch", "seq", "embed")
    logw = -torch.exp(p["w0"] + lora)
    logw = torch.clamp(logw, min=LOGW_MIN)
    g = F.silu(mm(mix(4), p["wg"]).to(torch.float32))

    def heads(t):
        return split_heads(t, cfg.n_heads, cfg.head_dim)

    return (heads(r).to(torch.float32), heads(k).to(torch.float32), heads(v).to(torch.float32), heads(logw), g)


def wkv_chunked(r, k, v, logw, u, state=None, chunk: int = CHUNK):
    """r, k, v, logw: (B, S, H, dk) f32; u: (H, dk).  Returns (y, final
    state).

    State S: (B, H, dk, dv) with S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t and
    y_t = rᵀ(S_{t-1} + diag(u) k_t ⊗ v_t), one chunk of ``chunk`` steps at a
    time in a Python loop (the reference scans the chunks)."""
    b, s, h, dk = r.shape
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"sequence length {s} is not a multiple of the chunk {q}")
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=r.device), diagonal=-1)  # j < i
    u = u.to(torch.float32)  # jnp.einsum promotes the cfg.dtype bonus
    S = torch.zeros((b, h, dk, dk), dtype=torch.float32, device=r.device) if state is None else state
    ys = []
    for c0 in range(0, s, q):
        rc, kc, vc, wc = (t[:, c0:c0 + q] for t in (r, k, v, logw))
        cumw = torch.cumsum(wc, dim=1)  # inclusive, <= 0, decreasing
        ecw = cumw - wc  # exclusive cumsum (ecw_0 = 0)
        qd = rc * torch.exp(ecw)  # <= |r|
        kd = kc * torch.exp(-cumw)  # <= |k|·e^{|LOGW_MIN|·q}
        sc = einsum("bihd,bjhd->bhij", qd, kd)
        sc = torch.where(mask, sc, 0.0)
        diag = einsum("bihd,hd,bihd->bhi", rc, u, kc)
        y = einsum("bhij,bjhd->bihd", sc, vc) + diag.transpose(1, 2)[..., None] * vc
        y = y + einsum("bihd,bhde->bihe", rc * torch.exp(ecw), S)
        dec_end = torch.exp(cumw[:, -1:] - cumw)  # <= 1
        S = S * torch.exp(cumw[:, -1])[..., None] + einsum("bjhd,bjhe->bhde", kc * dec_end, vc)
        ys.append(y)
    return torch.cat(ys, dim=1), S


def wkv_recurrent(r, k, v, logw, u, state=None):
    """The decode form and the oracle: the O(1)-state recurrence, one step
    at a time.  Returns (y (B, S, H, dv), final state)."""
    b, s, h, dk = r.shape
    u = u.to(torch.float32)
    S = torch.zeros((b, h, dk, dk), dtype=torch.float32, device=r.device) if state is None else state
    ys = []
    for t in range(s):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], logw[:, t]  # (B, H, dk)
        kv = einsum("bhd,bhe->bhde", kt, vt)
        ys.append(einsum("bhd,bhde->bhe", rt, S + u[None, :, :, None] * kv))
        S = S * torch.exp(wt)[..., None] + kv
    return torch.stack(ys, dim=1), S


def rwkv6_time_mix(x, p, cfg: RWKV6Config, *, chunked: bool = True, ftc=None):
    r, k, v, logw, g = _rkvwg(x, _token_shift(x), p, cfg, ftc)
    wkv = wkv_chunked if chunked else wkv_recurrent
    y, _ = wkv(r, k, v, logw, p["u"])
    y = rmsnorm(merge_heads(y), p["ln_x"])
    return site_matmul(ftc, "ssm.out")((y * g).to(x.dtype), p["wo"])


def _channel_mix(x, xs, p, ftc=None):
    xk = x + (xs - x) * p["mu_ff"][0]
    xr = x + (xs - x) * p["mu_ff"][1]
    mm = site_matmul(ftc, "ffn")
    kk = torch.square(F.relu(mm(xk, p["ffk"])))
    return torch.sigmoid(mm(xr, p["ffr"])) * mm(kk, p["ffv"])


def rwkv6_channel_mix(x, p, ftc=None):
    return _channel_mix(x, _token_shift(x), p, ftc)


def rwkv6_forward(x, p, cfg: RWKV6Config, *, chunked: bool = True, ftc=None):
    """One block over a sequence x: (B, S, d), from a zero state."""
    x = x + rwkv6_time_mix(rmsnorm(x, p["ln1"]), p, cfg, chunked=chunked, ftc=ftc)
    return x + rwkv6_channel_mix(rmsnorm(x, p["ln2"]), p, ftc)


# --------------------------------------------------------------------------- #
# decode
# --------------------------------------------------------------------------- #
def rwkv6_cache_init(cfg: RWKV6Config, batch: int, *, device="cuda") -> Params:
    d = cfg.d_model
    return {
        "S": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.head_dim), dtype=torch.float32, device=device),
        "x_tm": torch.zeros((batch, d), dtype=torch.float32, device=device),  # last token (time mix)
        "x_cm": torch.zeros((batch, d), dtype=torch.float32, device=device),  # last token (channel mix)
    }


def rwkv6_decode(x, p, cfg: RWKV6Config, cache: Params, ftc=None) -> tuple[torch.Tensor, Params]:
    """One-token decode, x: (B, 1, d).  The state ``S`` and the two token
    shifts ``x_tm`` / ``x_cm`` are written into the cache's own tensors
    after their last read, and the same dict is returned (the reference
    returns new arrays), so a captured CUDA graph that reads this cache
    carries the state from replay to replay."""
    xn = rmsnorm(x, p["ln1"])
    xs = cache["x_tm"][:, None, :].to(x.dtype)
    r, k, v, logw, g = _rkvwg(xn, xs, p, cfg, ftc)
    y, S_new = wkv_recurrent(r, k, v, logw, p["u"], cache["S"])
    b = x.shape[0]
    y = rmsnorm(y.reshape(b, 1, cfg.d_model), p["ln_x"])
    x1 = x + site_matmul(ftc, "ssm.out")((y * g).to(x.dtype), p["wo"])
    x1n = rmsnorm(x1, p["ln2"])
    out = x1 + _channel_mix(x1n, cache["x_cm"][:, None, :].to(x.dtype), p, ftc)
    copy_into(cache["S"], S_new)
    copy_into(cache["x_tm"], xn[:, 0])
    copy_into(cache["x_cm"], x1n[:, 0])
    return out, cache
