"""Encoder-decoder backbone (whisper-tiny): a bidirectional encoder over
precomputed audio-frame embeddings and a causal decoder with
cross-attention, as the JAX package has it.

Kept from whisper: pre-LN LayerNorm blocks, non-gated GELU FFNs, MHA
(n_kv == n_heads), sinusoidal encoder positions.  As in the reference, the
decoder's self-attention goes through the GQA path and so uses RoPE, the
cross-attention has no mask, and the encoder attention has no RoPE.  The
encoder's layer stack is ``encoder["layers"]``, a list of per-layer dicts
(the reference stacks it on a leading layer axis).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.ftcontext import site_matmul
from repro_torch.dist.sharding import einsum, shard
from repro_torch.models.attention import AttnConfig, gqa_cache_init, gqa_init
from repro_torch.models.layers import (
    Params, dense_init, ffn, ffn_init, gelu, layernorm, layernorm_init, merge_heads, sinusoidal_positions,
    split_heads,
)


@dataclasses.dataclass(frozen=True)
class CrossAttnConfig:
    d_model: int
    n_heads: int

    @property
    def hd(self) -> int:
        return self.d_model // self.n_heads


def cross_attn_init(gen: torch.Generator, cfg: CrossAttnConfig, *, device="cuda") -> Params:
    d = cfg.d_model
    return {name: dense_init(gen, d, d, device=device) for name in ("wq", "wk", "wv", "wo")}


def _softmax_attn(q, k, v, scale_by: float, dtype) -> torch.Tensor:
    """Full attention in f32, no mask: q (B,S,H,D), k/v (B,T,H,D)."""
    sc = einsum("bshd,bthd->bhst", q.to(torch.float32), k.to(torch.float32))
    wts = torch.softmax(sc / scale_by, dim=-1)
    return einsum("bhst,bthd->bshd", wts, v.to(torch.float32)).to(dtype)


def cross_attn(x: torch.Tensor, enc: torch.Tensor, p: Params, cfg: CrossAttnConfig, ftc=None) -> torch.Tensor:
    """x: (B, S, d) queries; enc: (B, T, d) encoder keys and values (no
    mask).  K and V are projected from ``enc`` on every call, on the array."""
    h, hd = cfg.n_heads, cfg.hd
    mm = site_matmul(ftc, "attn.qkv")
    q = split_heads(mm(x, p["wq"]), h, hd)
    k = split_heads(mm(enc, p["wk"]), h, hd)
    v = split_heads(mm(enc, p["wv"]), h, hd)
    out = _softmax_attn(q, k, v, hd ** 0.5, x.dtype)
    return shard(site_matmul(ftc, "attn.out")(merge_heads(out), p["wo"]), "batch", "seq", "embed")


def _self_attn_bidir(x: torch.Tensor, p: Params, cfg: AttnConfig, ftc=None) -> torch.Tensor:
    """Full bidirectional MHA (the encoder's); no RoPE."""
    h, hd = cfg.n_heads, cfg.hd
    mm = site_matmul(ftc, "attn.qkv")
    q = split_heads(mm(x, p["wq"]), h, hd)
    k = split_heads(mm(x, p["wk"]), h, hd)
    v = split_heads(mm(x, p["wv"]), h, hd)
    out = _softmax_attn(q, k, v, hd ** 0.5, x.dtype)
    return shard(site_matmul(ftc, "attn.out")(merge_heads(out), p["wo"]), "batch", "seq", "embed")


# --------------------------------------------------------------------------- #
# encoder
# --------------------------------------------------------------------------- #
def encoder_layer_init(gen: torch.Generator, d: int, n_heads: int, d_ff: int, *, device="cuda") -> Params:
    return {
        "ln1": layernorm_init(d, device=device),
        "attn": gqa_init(gen, AttnConfig(d, n_heads, n_heads), device=device),
        "ln2": layernorm_init(d, device=device),
        "ffn": ffn_init(gen, d, d_ff, gated=False, device=device),
    }


def encoder_init(gen: torch.Generator, n_layers: int, d: int, n_heads: int, d_ff: int, *,
                 device="cuda") -> Params:
    return {
        "layers": [encoder_layer_init(gen, d, n_heads, d_ff, device=device) for _ in range(n_layers)],
        "ln_post": layernorm_init(d, device=device),
    }


def encoder_forward(frames: torch.Tensor, p: Params, d: int, n_heads: int, ftc=None) -> torch.Tensor:
    """frames: (B, T, d) mel-frame embeddings.  The sinusoidal table is
    added here as well as in :func:`~repro_torch.models.frontends.audio_frontend`,
    as the reference does, so frames through both get it twice."""
    acfg = AttnConfig(d, n_heads, n_heads)
    x = frames + sinusoidal_positions(frames.shape[1], d, device=frames.device)[None].to(frames.dtype)
    for lp in p["layers"]:
        x = x + _self_attn_bidir(layernorm(x, lp["ln1"]), lp["attn"], acfg, ftc)
        x = x + ffn(layernorm(x, lp["ln2"]), lp["ffn"], act=gelu, ftc=ftc)
    return layernorm(x, p["ln_post"])


# --------------------------------------------------------------------------- #
# decoder layer (self + cross + ffn), used by lm.py's encdec family
# --------------------------------------------------------------------------- #
def decoder_layer_init(gen: torch.Generator, d: int, n_heads: int, n_kv: int, d_ff: int, *,
                       device="cuda") -> Params:
    return {
        "ln1": layernorm_init(d, device=device),
        "attn": gqa_init(gen, AttnConfig(d, n_heads, n_kv), device=device),
        "ln_x": layernorm_init(d, device=device),
        "xattn": cross_attn_init(gen, CrossAttnConfig(d, n_heads), device=device),
        "ln2": layernorm_init(d, device=device),
        "ffn": ffn_init(gen, d, d_ff, gated=False, device=device),
    }


def decoder_cache_init(d: int, n_heads: int, n_kv: int, n_layers: int, batch: int, smax: int,
                       dtype=torch.bfloat16, *, device="cuda") -> list:
    """One GQA self-attention cache per decoder layer."""
    return [gqa_cache_init(AttnConfig(d, n_heads, n_kv), batch, smax, dtype, device=device)
            for _ in range(n_layers)]
