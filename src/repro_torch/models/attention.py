"""Attention: grouped-query attention (covers MHA) and multi-head latent
attention (MLA, MiniCPM3 / DeepSeek-V2 style).  Each has its projections,
the blockwise causal attention of a sequence (prefill and training),
one-token decode and its cache.  Scores and softmax run in f32, as in the
JAX package; attention itself is plain PyTorch (the JAX package left it to
XLA, outside any Pallas kernel), except MLA's prefill core on a card, one
launch of :func:`~repro_torch.kernels.mla_prefill.mla_prefill`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.ftcontext import site_matmul
from repro_torch.dist.sharding import einsum, is_dtensor, shard
from repro_torch.kernels.mla_prefill import mla_prefill
from repro_torch.models.layers import (
    Params, YarnScaling, apply_rope, dense_init, merge_heads, rmsnorm, rmsnorm_init, split_heads,
)
from repro_torch.obs.spans import ATTN_MLA


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int | None = None
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    q_block: int = 512

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


def gqa_init(gen: torch.Generator, cfg: AttnConfig, *, device="cuda") -> Params:
    hd = cfg.hd
    p = {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * hd, device=device),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv * hd, device=device),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv * hd, device=device),
        "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model, device=device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.n_heads * hd), ("bk", cfg.n_kv * hd), ("bv", cfg.n_kv * hd)):
            p[name] = torch.zeros((width,), dtype=torch.float32, device=device)
    return p


def _qkv(x, p, cfg: AttnConfig, positions, ftc=None):
    b, s, _ = x.shape
    hd = cfg.hd
    mm = site_matmul(ftc, "attn.qkv")
    q = mm(x, p["wq"])
    k = mm(x, p["wk"])
    v = mm(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = split_heads(q, cfg.n_heads, hd)
    k = split_heads(k, cfg.n_kv, hd, "kv_heads")
    v = split_heads(v, cfg.n_kv, hd, "kv_heads")
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _grouped_scores(qb, k, scale):
    """qb: (B,qb,Hk,G,D), k: (B,S,Hk,D) -> (B,qb,Hk,G,S) fp32."""
    return einsum("bqhgd,bshd->bqhgs", qb.to(torch.float32), k.to(torch.float32)) * scale


def blockwise_causal_attention(q, k, v, n_kv: int, q_block: int) -> torch.Tensor:
    """q: (B,S,Hq,D); k, v: (B,S,Hk,D); returns (B,S,Hq,D).

    Query blocks of ``q_block`` rows in a Python loop (the reference scans
    them); each block sees the whole K/V panel under a causal mask of -1e30,
    in f32, so the score tensor is B·qb·Hq·S, never B·S·Hq·S."""
    b, s, hq, d = q.shape
    g = hq // n_kv
    scale = 1.0 / (d ** 0.5)
    qb = min(q_block, s)
    if s % qb:
        raise ValueError(f"sequence length {s} is not a multiple of the query block {qb}")
    # grouped by KV head: on DTensors the heads stay sharded only where the
    # KV heads divide the mesh axis too
    q = shard(q, "batch", "seq", "kv_heads", None, dims=(b, s, n_kv, d))
    qr = q.reshape(b, s // qb, qb, n_kv, g, d)
    kpos = torch.arange(s, device=q.device)
    k32, v32 = k.to(torch.float32), v.to(torch.float32)
    neg = torch.full((), -1e30, device=q.device)
    outs = []
    for blk in range(s // qb):
        qpos = blk * qb + torch.arange(qb, device=q.device)
        sc = _grouped_scores(qr[:, blk], k32, scale)  # (B,qb,Hk,G,S)
        mask = kpos[None, :] <= qpos[:, None]  # (qb, S)
        sc = torch.where(mask[None, :, None, None, :], sc, neg)
        wts = torch.softmax(sc, dim=-1)
        outs.append(einsum("bqhgs,bshd->bqhgd", wts, v32).to(q.dtype))
    return torch.stack(outs, dim=1).reshape(b, s, hq, d)


def gqa_forward(x, p, cfg: AttnConfig, positions=None, ftc=None) -> torch.Tensor:
    """Attention over a whole sequence x: (B,S,d), causal, for prefill and
    training; every projection goes through ``ftc``."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _qkv(x, p, cfg, positions, ftc)
    out = blockwise_causal_attention(q, k, v, cfg.n_kv, cfg.q_block)
    out = site_matmul(ftc, "attn.out")(merge_heads(out), p["wo"])
    return shard(out, "batch", "seq", "embed")  # the reference's attention.py:114


def _write_rows(bidx: torch.Tensor, idx: torch.Tensor, *pairs: tuple[torch.Tensor, torch.Tensor]) -> None:
    """``cache[b, idx[b]] = new[b]`` in place, for each ``(cache, new)`` of
    ``pairs``, for every slot whose ``idx`` is inside the cache; a slot at or
    past its capacity (an idle slot keeps advancing) keeps its cache as it
    was, as the reference's scatter drops an out-of-bounds write, and no
    index leaves the tensor."""
    smax = pairs[0][0].shape[1]
    if is_dtensor(pairs[0][0]):
        for cache, new in pairs:
            _write_rows_local(idx, cache, new)
        return
    pos = torch.clamp(idx, max=smax - 1).long()
    keep = idx < smax
    for cache, new in pairs:
        k = keep.view(-1, *([1] * (new.dim() - 1)))
        cache[bidx, pos] = torch.where(k, new.to(cache.dtype), cache[bidx, pos])


def _write_rows_local(idx, cache, new) -> None:
    """:func:`_write_rows` for one DTensor cache ``(B, S, ...)``, on this
    device's shard, in place: ``new`` ``(B, ...)`` is redistributed to the
    cache's placements with its length dim dropped, and a slot writes only
    where its row lies in this shard's length range (the flash-decoding
    layout shards the length over ``model``).  Its out-of-bounds rule is
    the plain path's."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh, pl = cache.device_mesh, cache.placements
    smax = cache.shape[1]
    row_pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else
                   Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1 else p for p in pl)
    idx_pl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in pl)
    local = cache.to_local()
    new_l = new.redistribute(mesh, row_pl).to_local()
    idx_l = idx.redistribute(mesh, idx_pl).to_local()
    _, offset = compute_local_shape_and_global_offset(cache.shape, mesh, pl)
    rows = local.shape[1]
    rel = idx_l.long() - offset[1]
    keep = (idx_l < smax) & (rel >= 0) & (rel < rows)
    pos = torch.clamp(rel, 0, rows - 1)
    bidx = torch.arange(local.shape[0], device=local.device)
    k = keep.view(-1, *([1] * (new_l.dim() - 1)))
    local[bidx, pos] = torch.where(k, new_l.to(local.dtype), local[bidx, pos])


def _softmax_over_cache(sc: torch.Tensor) -> torch.Tensor:
    """Softmax over the last dim, the cache's length.  On a DTensor whose
    length is sharded (the flash-decoding layout of the cache), by parts:
    each device's max and sum over its rows, reduced over the mesh, so the
    scores are never gathered; the plain path is ``torch.softmax``."""
    if not is_dtensor(sc) or not any(getattr(p, "dim", None) == sc.dim() - 1 for p in sc.placements):
        return torch.softmax(sc, dim=-1)
    m = sc.amax(dim=-1, keepdim=True)
    e = torch.exp(sc - m)
    return e / e.sum(dim=-1, keepdim=True)


def gqa_decode(x, p, cfg: AttnConfig, cache: Params, ftc=None) -> tuple[torch.Tensor, Params]:
    """One-token decode.  x: (B,1,d); cache: {k, v: (B,Smax,Hk,D), idx: (B,)}.

    The cache is updated in place and returned: the new K/V rows are written
    into ``cache["k"]`` / ``cache["v"]`` and ``cache["idx"]`` advances by one
    after its last read (the JAX package returns updated copies and donates
    the old ones).  Every tensor keeps its storage, so a captured CUDA graph
    that read this cache updates it on every replay."""
    b = x.shape[0]
    idx = cache["idx"]  # (B,) current length
    q, k_new, v_new = _qkv(x, p, cfg, idx[:, None], ftc)
    bidx = torch.arange(b, device=x.device)
    k_cache, v_cache = cache["k"], cache["v"]
    _write_rows(bidx, idx, (k_cache, k_new[:, 0]), (v_cache, v_new[:, 0]))
    smax = k_cache.shape[1]
    g = cfg.n_heads // cfg.n_kv
    scale = 1.0 / (cfg.hd ** 0.5)
    # the query heads grouped by KV head: on DTensors the heads stay sharded
    # only where the KV heads divide the mesh axis too
    qh = shard(q, "batch", None, "kv_heads", None, dims=(b, 1, cfg.n_kv, cfg.hd)).reshape(b, 1, cfg.n_kv, g, cfg.hd)
    sc = _grouped_scores(qh, k_cache, scale)[:, 0]  # (B,Hk,G,S)
    valid = torch.arange(smax, device=x.device)[None, :] <= idx[:, None]  # (B,S)
    sc = torch.where(valid[:, None, None, :], sc, torch.full((), -1e30, device=x.device))
    wts = _softmax_over_cache(sc)
    out = einsum("bhgs,bshd->bhgd", wts, v_cache.to(torch.float32))
    out = out.reshape(b, 1, cfg.n_heads * cfg.hd).to(x.dtype)
    idx.add_(1)
    return shard(site_matmul(ftc, "attn.out")(out, p["wo"]), "batch", None, "embed"), cache


def gqa_cache_init(cfg: AttnConfig, batch: int, smax: int, dtype=torch.bfloat16, *, device="cuda") -> Params:
    return {
        "k": torch.zeros((batch, smax, cfg.n_kv, cfg.hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, smax, cfg.n_kv, cfg.hd), dtype=dtype, device=device),
        "idx": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


# --------------------------------------------------------------------------- #
# MLA — multi-head latent attention (MiniCPM3 / DeepSeek-V2 / DeepSeek-V3)
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """The reference package's MLA config, field for field: plain RoPE at
    the base theta on contiguous halves.  :class:`YarnMLAConfig` adds
    DeepSeek-V3's RoPE."""

    d_model: int
    n_heads: int
    q_lora: int = 768
    kv_lora: int = 256
    d_nope: int = 64
    d_rope: int = 32
    d_v: int = 64
    rope_theta: float = 10000.0
    q_block: int = 512

    rope_scaling = None       # no fields here: YarnMLAConfig's
    rope_interleave = False

    @property
    def softmax_scale(self) -> float:
        """``(d_nope + d_rope) ** -0.5``, times YaRN's ``mscale_all_dim``
        squared."""
        scale = 1.0 / ((self.d_nope + self.d_rope) ** 0.5)
        if self.rope_scaling is not None:
            scale *= self.rope_scaling.softmax_scale_factor()
        return scale

    def rope(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        return apply_rope(x, positions, self.rope_theta, scaling=self.rope_scaling,
                          interleave=self.rope_interleave)


@dataclasses.dataclass(frozen=True)
class YarnMLAConfig(MLAConfig):
    """MLA with DeepSeek-V3's RoPE: ``rope_scaling``, YaRN's frequencies,
    which also scale the softmax (:attr:`softmax_scale`); ``rope_interleave``,
    the rotated pairs interleaved
    (:func:`~repro_torch.models.layers.apply_rope`)."""

    rope_scaling: YarnScaling | None = None
    rope_interleave: bool = False


def mla_init(gen: torch.Generator, cfg: MLAConfig, *, device="cuda") -> Params:
    h, dn, dr, dv = cfg.n_heads, cfg.d_nope, cfg.d_rope, cfg.d_v
    return {
        "wq_a": dense_init(gen, cfg.d_model, cfg.q_lora, device=device),
        "q_norm": rmsnorm_init(cfg.q_lora, device=device),
        "wq_b": dense_init(gen, cfg.q_lora, h * (dn + dr), device=device),
        "wkv_a": dense_init(gen, cfg.d_model, cfg.kv_lora + dr, device=device),
        "kv_norm": rmsnorm_init(cfg.kv_lora, device=device),
        "wkv_b": dense_init(gen, cfg.kv_lora, h * (dn + dv), device=device),
        "wo": dense_init(gen, h * dv, cfg.d_model, device=device),
    }


def _mla_qkr(x, p, cfg: MLAConfig, positions, ftc=None):
    """(q_nope (B,S,H,dn), q_rope (B,S,H,dr), c_kv (B,S,kv_lora), k_rope
    (B,S,dr)): the query through its LoRA pair, the compressed KV latent and
    the one RoPE key that all heads share."""
    b, s, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.d_nope, cfg.d_rope
    mm = site_matmul(ftc, "attn.qkv")
    q = split_heads(mm(rmsnorm(mm(x, p["wq_a"]), p["q_norm"]), p["wq_b"]), h, dn + dr)
    q_nope, q_rope = q[..., :dn], cfg.rope(q[..., dn:], positions)
    kv_a = mm(x, p["wkv_a"])
    c_kv = rmsnorm(kv_a[..., :cfg.kv_lora], p["kv_norm"])
    k_rope = cfg.rope(kv_a[..., cfg.kv_lora:][:, :, None, :], positions)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def mla_forward(x, p, cfg: MLAConfig, positions=None, ftc=None) -> torch.Tensor:
    """MLA over a whole sequence x: (B,S,d), causal; the keys and values are
    expanded from the latent through ``wkv_b`` on the array (site
    attn.qkv).  The attention core, from the expanded keys and values to
    the heads' output, is the span ``attn.mla``
    (:mod:`repro_torch.obs.spans`): :func:`mla_prefill`, one kernel launch
    on a card, the plain version on the CPU and on DTensors, in query blocks
    of ``q_block`` rows, each over the keys up to its last row."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    h, dn, dv = cfg.n_heads, cfg.d_nope, cfg.d_v
    q_nope, q_rope, c_kv, k_rope = _mla_qkr(x, p, cfg, positions, ftc)
    kv = split_heads(site_matmul(ftc, "attn.qkv")(c_kv, p["wkv_b"]), h, dn + dv)
    qb = min(cfg.q_block, s)
    if s % qb:
        raise ValueError(f"sequence length {s} is not a multiple of the query block {qb}")
    with ATTN_MLA.on(x.device):
        out = merge_heads(mla_prefill(q_nope, q_rope, kv[..., :dn], k_rope, kv[..., dn:], cfg.softmax_scale,
                                      q_block=qb))
    return shard(site_matmul(ftc, "attn.out")(out, p["wo"]), "batch", "seq", "embed")


def mla_cache_init(cfg: MLAConfig, batch: int, smax: int, dtype=torch.bfloat16, *, device="cuda") -> Params:
    return {
        "c_kv": torch.zeros((batch, smax, cfg.kv_lora), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, smax, cfg.d_rope), dtype=dtype, device=device),
        "idx": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def mla_decode(x, p, cfg: MLAConfig, cache: Params, ftc=None) -> tuple[torch.Tensor, Params]:
    """Absorbed-matmul decode: attention runs in the compressed latent space,
    so the cache holds (kv_lora + d_rope) values a token.

    The latent einsums on ``w_uk`` / ``w_uv`` (views of ``wkv_b``) run off
    the array, as in the reference: ``wkv_b`` is on it in
    :func:`mla_forward`; here the q-side projections and ``wo`` are.  The
    reference's einsums promote a bf16 ``w_uk`` / ``w_uv`` and an f32
    operand to f32; here they are cast to f32 where it promotes.  The cache
    is updated in place and returned, ``idx`` advancing after its last read
    (see :func:`gqa_decode`).  The attention core, from the absorbed query
    to the heads' output, is the span ``attn.mla``."""
    b = x.shape[0]
    idx = cache["idx"]
    h, dn, dv = cfg.n_heads, cfg.d_nope, cfg.d_v
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkr(x, p, cfg, idx[:, None], ftc)
    bidx = torch.arange(b, device=x.device)
    c_cache, r_cache = cache["c_kv"], cache["k_rope"]
    _write_rows(bidx, idx, (c_cache, c_kv_new[:, 0]), (r_cache, k_rope_new[:, 0]))
    wkv_b = shard(p["wkv_b"], None, "heads", dims=(cfg.kv_lora, h)).reshape(cfg.kv_lora, h, dn + dv)
    with ATTN_MLA.on(x.device):
        w_uk, w_uv = wkv_b[..., :dn].to(torch.float32), wkv_b[..., dn:].to(torch.float32)  # (L,H,dn), (L,H,dv)
        q_abs = einsum("bhd,lhd->bhl", q_nope[:, 0].to(torch.float32), w_uk)
        scale = cfg.softmax_scale
        c32 = c_cache.to(torch.float32)
        sc = (einsum("bhl,bsl->bhs", q_abs, c32)
              + einsum("bhd,bsd->bhs", q_rope[:, 0].to(torch.float32), r_cache.to(torch.float32))) * scale
        valid = torch.arange(c_cache.shape[1], device=x.device)[None, :] <= idx[:, None]
        sc = torch.where(valid[:, None, :], sc, torch.full((), -1e30, device=x.device))
        wts = _softmax_over_cache(sc)
        ctx = einsum("bhs,bsl->bhl", wts, c32)
        out = shard(einsum("bhl,lhd->bhd", ctx, w_uv), "batch", "heads", None).reshape(b, 1, h * dv).to(x.dtype)
    idx.add_(1)
    return shard(site_matmul(ftc, "attn.out")(out, p["wo"]), "batch", None, "embed"), cache
