"""LM composer: config schema, init, KV cache and one-token decode.

This slice ports the dense family (the qwen1.5-0.5b serving path); the other
families raise ``NotImplementedError`` until their slice lands.

Params are nested dicts of tensors in the JAX package's layout (``w`` is
``(d_in, d_out)``, ``x @ w``), except that the layer stack is a list of
per-layer dicts walked by a Python loop instead of arrays stacked on a
leading layer axis.  Masters are float32; :func:`cast_params` makes the
``cfg.dtype`` working copies that :func:`decode_step` reads.
:func:`params_from_numpy` turns the JAX param pytree (as numpy arrays) into
this layout, so both packages can run the same weights.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.ftcontext import FTContext, site_matmul
from repro_torch.models.attention import AttnConfig, gqa_cache_init, gqa_decode, gqa_init
from repro_torch.models.layers import Params, embed_init, ffn, ffn_init, rmsnorm, rmsnorm_init

_ACTS = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"), "relu": F.relu}


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    family: str              # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    attn_kind: str = "gqa"   # gqa | mla
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm: str = "rms"        # rms | ln
    gated_ffn: bool = True
    act: str = "silu"
    tie_embeddings: bool = True
    q_block: int = 512
    # MoE
    moe: Any = None
    first_k_dense: int = 0
    dense_d_ff: int = 0
    # MLA
    mla: Any = None
    # SSM / hybrid
    ssm: Any = None
    rwkv: Any = None
    attn_every: int = 0
    # enc-dec
    n_enc_layers: int = 0
    enc_len: int = 1500
    # vlm
    n_patches: int = 0
    d_vision: int = 1024
    subquadratic: bool = False
    remat: bool = True
    remat_policy: str = "full"
    loss_chunks: int = 0
    unroll: bool = False
    dtype: Any = torch.bfloat16

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (padded logit rows are masked)."""
        return -(-self.vocab // 256) * 256

    @property
    def attn_cfg(self) -> AttnConfig:
        return AttnConfig(
            self.d_model, self.n_heads, self.n_kv, head_dim=self.head_dim,
            qkv_bias=self.qkv_bias, rope_theta=self.rope_theta, q_block=self.q_block,
        )


def _require_dense(cfg: LMConfig) -> None:
    if cfg.family != "dense" or cfg.attn_kind != "gqa" or cfg.norm != "rms":
        raise NotImplementedError(
            f"{cfg.name}: family={cfg.family!r} attn={cfg.attn_kind!r} norm={cfg.norm!r} "
            f"comes with a later slice; this one ports the dense GQA/RMSNorm family"
        )


# --------------------------------------------------------------------------- #
# params
# --------------------------------------------------------------------------- #
def init_params(gen: torch.Generator, cfg: LMConfig, *, device=None) -> Params:
    """Random f32 master params from a seeded ``torch.Generator``, on the
    generator's device (or ``device``, which must match it)."""
    _require_dense(cfg)
    device = gen.device if device is None else torch.device(device)
    p: Params = {"embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, device=device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(gen, cfg.padded_vocab, cfg.d_model, device=device)
    p["final_norm"] = rmsnorm_init(cfg.d_model, device=device)
    p["blocks"] = [
        {
            "ln1": rmsnorm_init(cfg.d_model, device=device),
            "attn": gqa_init(gen, cfg.attn_cfg, device=device),
            "ln2": rmsnorm_init(cfg.d_model, device=device),
            "ffn": ffn_init(gen, cfg.d_model, cfg.d_ff, gated=cfg.gated_ffn, device=device),
        }
        for _ in range(cfg.n_layers)
    ]
    return p


def tree_map(fn, tree):
    """``fn`` over every tensor of a params/cache tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def params_from_numpy(tree: dict, device="cuda") -> Params:
    """The JAX param pytree, handed over as nested dicts of numpy arrays
    (``jax.tree.map(np.asarray, params)``), in this package's layout: the
    stacked ``blocks`` arrays become one dict per layer."""
    def to_t(a):
        return torch.from_numpy(np.array(a)).to(device)

    out = {k: tree_map(to_t, v) for k, v in tree.items() if k != "blocks"}
    blocks = tree["blocks"]
    out["blocks"] = [tree_map(lambda a, i=i: to_t(a[i]), blocks) for i in range(len(blocks["ln1"]))]
    return out


def cast_params(params: Params, dtype) -> Params:
    """Working copies in ``dtype`` of every floating leaf — the JAX package's
    per-step ``_cast`` done once.  A leaf already in ``dtype`` is shared, not
    copied."""
    return tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a, params)


# --------------------------------------------------------------------------- #
# serve: cache init + single-token decode
# --------------------------------------------------------------------------- #
def init_cache(cfg: LMConfig, batch: int, smax: int, dtype=torch.bfloat16, *, device="cuda") -> Params:
    """{"attn": [per-layer {k, v: (B,Smax,Hk,D), idx: (B,)}]}."""
    _require_dense(cfg)
    return {"attn": [gqa_cache_init(cfg.attn_cfg, batch, smax, dtype, device=device)
                     for _ in range(cfg.n_layers)]}


def _layer_splits(n: int, ftc: FTContext | None) -> list[tuple[int, int, FTContext | None]]:
    """Protected-prefix split of an ``n``-layer stack: layers [0, k) run with
    the fault-aware context, layers [k, n) with plain matmuls."""
    if ftc is None or not ftc.active or n == 0:
        return [(0, n, ftc if (ftc is not None and ftc.active) else None)]
    k = ftc.n_protected_layers(n)
    if k == 0:
        return [(0, n, None)]
    if k >= n:
        return [(0, n, ftc)]
    return [(0, k, ftc), (k, n, None)]


def _logits(x, params, cfg: LMConfig, ftc: FTContext | None = None):
    x = rmsnorm(x, params["final_norm"])
    table = params.get("lm_head", params["embed"])
    # table.T is a strided view of the tied table: the head matmul reads it
    # through its strides, never through a transposed copy
    logits = site_matmul(ftc, "head")(x, table.T)
    if cfg.padded_vocab != cfg.vocab:  # mask padded rows out of the softmax
        logits[..., cfg.vocab:] = -1e30
    return logits


def decode_step(
    params: Params,
    cfg: LMConfig,
    cache: Params,
    batch: dict,
    *,
    ftc: FTContext | None = None,
) -> tuple[torch.Tensor, Params]:
    """batch: {"token": (B, 1) int}.  Returns (logits (B,1,V), new cache).

    ``params`` are the ``cfg.dtype`` working copies (:func:`cast_params`).
    The JAX counterpart (``repro/models/lm.py:533-553``) casts the f32
    masters to ``cfg.dtype`` and applies the no-op ``shard`` constraints
    inside every step; here both are done once, when the bundle is built
    (the values are identical), and must not come back per step: at full
    width the cast alone moves about 1.9 GB per step.

    Every weight matmul of the protected layer prefix and the LM head routes
    through ``ftc``.  The KV cache is updated in place (see
    :func:`~repro_torch.models.attention.gqa_decode`).
    """
    _require_dense(cfg)
    x = params["embed"][batch["token"].long()]
    act = _ACTS[cfg.act]
    layers = []
    for lo, hi, fc in _layer_splits(cfg.n_layers, ftc):
        for i in range(lo, hi):
            lp = params["blocks"][i]
            h, c2 = gqa_decode(rmsnorm(x, lp["ln1"]), lp["attn"], cfg.attn_cfg, cache["attn"][i], fc)
            x = x + h
            x = x + ffn(rmsnorm(x, lp["ln2"]), lp["ffn"], act=act, ftc=fc)
            layers.append(c2)
    return _logits(x, params, cfg, ftc), {"attn": layers}
