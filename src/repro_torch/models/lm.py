"""LM composer: config schema, init, the sequence forward and its loss
(prefill and training), the decode cache and one-token decode.

All six families of the JAX package: dense (qwen1.5-0.5b, granite-8b,
starcoder2-3b, minicpm3-4b), moe (granite-moe-3b-a800m, deepseek-moe-16b),
vlm (llava-next-mistral-7b: the projected patches spliced over the prompt's
prefix, decoded as dense), encdec (whisper-tiny: an encoder over
precomputed frames, decoder layers with cross-attention), ssm (rwkv6-7b:
RWKV6 blocks) and hybrid (zamba2-1.2b: Mamba2 layers in groups, one shared
attention + FFN block after each group), with GQA or MLA attention,
RMSNorm or LayerNorm, gated or plain FFNs.

Params are nested dicts of tensors in the JAX package's layout (``w`` is
``(d_in, d_out)``, ``x @ w``), except that a layer stack (``blocks``,
``dense_blocks``, ``encoder["layers"]``) is a list of per-layer dicts walked
by a Python loop instead of arrays stacked on a leading layer axis.  Masters
are float32; :func:`cast_params` makes the ``cfg.dtype`` working copies that
:func:`decode_step` reads, while :func:`forward` and :func:`loss_fn` take
the masters and cast them inside, so that gradients reach them.
:func:`params_from_numpy` turns the JAX param pytree (as numpy arrays) into
this layout and :func:`params_to_numpy` turns it back, so both packages can
run, and compare, the same weights.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.core.ftcontext import FTContext, site_matmul
from repro_torch.dist.sharding import contiguous_strides, is_dtensor, shard
from repro_torch.models import encdec as ed
from repro_torch.models.attention import (
    AttnConfig, gqa_cache_init, gqa_decode, gqa_forward, gqa_init, mla_cache_init, mla_decode, mla_forward,
    mla_init,
)
from repro_torch.models.frontends import audio_frontend, mm_project, mm_projector_init, splice_patches
from repro_torch.models.layers import (
    Params, cross_entropy, embed_init, ffn, ffn_init, gelu, layernorm, layernorm_init, rmsnorm, rmsnorm_init,
    streamed_cross_entropy,
)
from repro_torch.models.mamba2 import mamba2_cache_init, mamba2_decode, mamba2_forward, mamba2_init
from repro_torch.models.moe import moe_forward, moe_init
from repro_torch.models.rwkv6 import rwkv6_cache_init, rwkv6_decode, rwkv6_forward, rwkv6_init
from repro_torch.tree import STACKED, tree_leaves, tree_map

_ACTS = {"silu": F.silu, "gelu": gelu, "relu": F.relu}


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

    def n_params(self) -> int:
        """Total parameter count, from ``meta`` params (no storage)."""
        params = init_params(torch.Generator(), self, device="meta")
        return sum(leaf.numel() for leaf in tree_leaves(params))

    def n_active_params(self) -> int:
        """Active params per token (MoE: only the routed top-k and the shared
        experts).  A layer that holds a share of the experts
        (``moe.experts_held``) counts the picks expected on its share,
        ``top_k * experts_held / n_experts`` experts a token."""
        total = self.n_params()
        if self.moe is None:
            return total
        m = self.moe
        per_expert = 3 * self.d_model * m.d_expert
        n_moe = self.n_layers - self.first_k_dense
        if m.experts_held:
            return total - round((m.experts_held - m.top_k * m.experts_held / m.n_experts) * per_expert * n_moe)
        inactive = (m.n_padded - m.top_k) * per_expert * n_moe
        return total - inactive


PORTED_FAMILIES = ("dense", "moe", "vlm", "encdec", "ssm", "hybrid")


def _require_ported(cfg: LMConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; known: {PORTED_FAMILIES}")


# --------------------------------------------------------------------------- #
# norm dispatch
# --------------------------------------------------------------------------- #
def _norm_init(cfg: LMConfig, d: int, device):
    return rmsnorm_init(d, device=device) if cfg.norm == "rms" else layernorm_init(d, device=device)


def _norm(x, p, cfg: LMConfig):
    return rmsnorm(x, p) if cfg.norm == "rms" else layernorm(x, p)


# --------------------------------------------------------------------------- #
# params
# --------------------------------------------------------------------------- #
def _attn_init(gen: torch.Generator, cfg: LMConfig, device) -> Params:
    if cfg.attn_kind == "mla":
        return mla_init(gen, cfg.mla, device=device)
    return gqa_init(gen, cfg.attn_cfg, device=device)


def _dense_block_init(gen: torch.Generator, cfg: LMConfig, d_ff: int, device) -> Params:
    return {
        "ln1": _norm_init(cfg, cfg.d_model, device),
        "attn": _attn_init(gen, cfg, device),
        "ln2": _norm_init(cfg, cfg.d_model, device),
        "ffn": ffn_init(gen, cfg.d_model, d_ff, gated=cfg.gated_ffn, device=device),
    }


def _moe_block_init(gen: torch.Generator, cfg: LMConfig, device) -> Params:
    return {
        "ln1": _norm_init(cfg, cfg.d_model, device),
        "attn": _attn_init(gen, cfg, device),
        "ln2": _norm_init(cfg, cfg.d_model, device),
        "moe": moe_init(gen, cfg.moe, device=device),
    }


def init_params(gen: torch.Generator, cfg: LMConfig, *, device=None, block_fn=None) -> Params:
    """Random f32 master params from a seeded ``torch.Generator``, on the
    generator's device (or ``device``, which must match it).  The moe family
    has ``blocks`` of MoE blocks and, when ``first_k_dense > 0``, the dense
    ``dense_blocks`` that sit below them; vlm adds the projector
    ``mm_proj``; encdec has the ``encoder`` and decoder layers as
    ``blocks``; ssm has RWKV6 ``blocks``; hybrid has ``blocks`` of ``{ln,
    mamba}`` and one ``shared`` dense block, which is no layer stack.

    ``block_fn``, when given, takes each piece as soon as it is drawn (the
    embedding, the head, the final norm, each layer of a stack, the
    projector, the shared block, the encoder) and its result stands in the
    tree in the piece's place.  It draws nothing, so the draws are those of
    a call without it: :class:`~repro_torch.serving.ModelBundle` hands each
    f32 piece to the host and keeps a cast copy on the card, which then
    never holds the whole f32 tree."""
    _require_ported(cfg)
    device = gen.device if device is None else torch.device(device)
    put = block_fn or (lambda piece: piece)
    p: Params = {"embed": put(embed_init(gen, cfg.padded_vocab, cfg.d_model, device=device))}
    if not cfg.tie_embeddings:
        p["lm_head"] = put(embed_init(gen, cfg.padded_vocab, cfg.d_model, device=device))
    p["final_norm"] = put(_norm_init(cfg, cfg.d_model, device))
    if cfg.family in ("dense", "vlm"):
        p["blocks"] = [put(_dense_block_init(gen, cfg, cfg.d_ff, device)) for _ in range(cfg.n_layers)]
        if cfg.family == "vlm":
            p["mm_proj"] = put(mm_projector_init(gen, cfg.d_vision, cfg.d_model, device=device))
    elif cfg.family == "ssm":
        p["blocks"] = [put(rwkv6_init(gen, cfg.rwkv, device=device)) for _ in range(cfg.n_layers)]
    elif cfg.family == "hybrid":
        p["blocks"] = [put({"ln": _norm_init(cfg, cfg.d_model, device),
                            "mamba": mamba2_init(gen, cfg.ssm, device=device)})
                       for _ in range(cfg.n_layers)]
        p["shared"] = put(_dense_block_init(gen, cfg, cfg.d_ff, device))
    elif cfg.family == "encdec":
        p["encoder"] = put(ed.encoder_init(gen, cfg.n_enc_layers, cfg.d_model, cfg.n_heads, cfg.d_ff, device=device))
        p["blocks"] = [put(ed.decoder_layer_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_ff, device=device))
                       for _ in range(cfg.n_layers)]
    else:
        p["blocks"] = [put(_moe_block_init(gen, cfg, device)) for _ in range(cfg.n_layers - cfg.first_k_dense)]
        if cfg.first_k_dense:
            p["dense_blocks"] = [put(_dense_block_init(gen, cfg, cfg.dense_d_ff or cfg.d_ff, device))
                                 for _ in range(cfg.first_k_dense)]
    return p


def params_from_numpy(tree: dict, device="cuda") -> Params:
    """The JAX param pytree, handed over as nested dicts of numpy arrays
    (``jax.tree.map(np.asarray, params)``), in this package's layout: each
    layer stack (a key of :data:`~repro_torch.tree.STACKED`: ``blocks``,
    ``dense_blocks``, the encoder's ``layers``) becomes one dict per layer."""
    def conv(t):
        if not isinstance(t, dict):
            return torch.from_numpy(np.array(t)).to(device)
        return {k: [conv(tree_map(lambda a, i=i: a[i], v)) for i in range(len(tree_leaves(v)[0]))]
                if k in STACKED else conv(v) for k, v in t.items()}

    return conv(tree)


def params_to_numpy(params: Params) -> dict:
    """The inverse of :func:`params_from_numpy`: nested dicts of numpy
    arrays in the JAX package's layout, each layer stack's per-layer dicts
    stacked on a leading layer axis."""
    def conv(t):
        if not isinstance(t, dict):
            return t.detach().cpu().numpy()
        return {k: stack_layers([conv(lp) for lp in v]) if k in STACKED and isinstance(v, list) else conv(v)
                for k, v in t.items()}

    return conv(params)


def stack_layers(layers: list):
    """Per-layer trees of numpy arrays stacked leaf by leaf on a new leading
    axis: the reference's layout of a layer stack."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: stack_layers([lp[k] for lp in layers]) for k in first}
    return np.stack(layers)


def cast_params(params: Params, dtype, *, device=None) -> Params:
    """Working copies in ``dtype`` of every floating leaf — the JAX package's
    per-step ``_cast`` done once — on ``device`` (default: where each leaf
    is), moved there leaf by leaf before the cast, so that host masters are
    cast on the card.  A leaf already in ``dtype`` on ``device`` is shared,
    not copied."""
    def one(a):
        a = a if device is None else a.to(device)
        return a.to(dtype) if a.is_floating_point() else a

    return tree_map(one, params)


# --------------------------------------------------------------------------- #
# forward (prefill and training) and the loss
# --------------------------------------------------------------------------- #
def forward(
    params: Params,
    cfg: LMConfig,
    batch: dict,
    *,
    ftc: FTContext | None = None,
    last_only: bool = False,
    return_hidden: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits, aux_loss).  batch: {"tokens": (B, S) int} [+
    "frames" (B, enc_len, d) for encdec, "patches" (B, n_patches,
    d_vision) for vlm].

    ``params`` are the f32 masters (or working copies already in
    ``cfg.dtype``): they are cast to ``cfg.dtype`` here, inside whatever is
    differentiated, as the reference's ``_cast`` does.  Every weight matmul
    of the protected layer prefix and the LM head routes through ``ftc``;
    the moe family's first-k dense blocks, the multimodal projector and the
    encoder run with the whole ``ftc``, and so does every layer of the
    hybrid family and every application of its shared block (no layer
    split, as in the reference: the shared block runs after every group).
    ``last_only``: production prefill,
    the logits of the last position only (the (B, S, V) tensor is never
    built).  ``return_hidden``: the final normed hidden state instead of
    the logits."""
    _require_ported(cfg)
    p = cast_params(params, cfg.dtype)
    tokens = batch["tokens"].long()
    x = _embed_rows(p["embed"], tokens)
    if cfg.family == "vlm" and "patches" in batch:
        x = splice_patches(x, mm_project(batch["patches"].to(cfg.dtype), p["mm_proj"], ftc))
    x = shard(x, "batch", "seq", "embed")
    b, s = tokens.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    act = _ACTS[cfg.act]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    xcfg = ed.CrossAttnConfig(cfg.d_model, cfg.n_heads)

    def attn(x, lp, fc):
        if cfg.attn_kind == "mla":
            return mla_forward(x, lp, cfg.mla, positions, fc)
        return gqa_forward(x, lp, cfg.attn_cfg, positions, fc)

    # each block's output is constrained as the reference's scanned bodies
    # constrain theirs (lm.py:278, 280, 363)
    def dense_block(x, lp, fc):
        x = x + attn(_norm(x, lp["ln1"], cfg), lp["attn"], fc)
        return shard(x + ffn(_norm(x, lp["ln2"], cfg), lp["ffn"], act=act, ftc=fc), "batch", "seq", "embed")

    def moe_block(x, aux, lp, fc):
        x = x + attn(_norm(x, lp["ln1"], cfg), lp["attn"], fc)
        y, ai = moe_forward(_norm(x, lp["ln2"], cfg), lp["moe"], cfg.moe, ftc=fc)
        return shard(x + y, "batch", "seq", "embed"), aux + ai

    def decoder_block(x, enc, lp, fc):
        x = x + gqa_forward(layernorm(x, lp["ln1"]), lp["attn"], cfg.attn_cfg, positions, fc)
        x = x + ed.cross_attn(layernorm(x, lp["ln_x"]), enc, lp["xattn"], xcfg, fc)
        return shard(x + ffn(layernorm(x, lp["ln2"]), lp["ffn"], act=_ACTS["gelu"], ftc=fc),
                     "batch", "seq", "embed")

    def rwkv_block(x, lp, fc):
        return shard(rwkv6_forward(x, lp, cfg.rwkv, ftc=fc), "batch", "seq", "embed")

    def mamba_block(x, lp, fc):
        return shard(x + mamba2_forward(_norm(x, lp["ln"], cfg), lp["mamba"], cfg.ssm, ftc=fc),
                     "batch", "seq", "embed")

    dense, moe, decoder = _remat(dense_block, cfg), _remat(moe_block, cfg), _remat(decoder_block, cfg)
    rwkv, mamba = _remat(rwkv_block, cfg), _remat(mamba_block, cfg)
    if cfg.family == "encdec":
        enc = ed.encoder_forward(audio_frontend(batch["frames"].to(cfg.dtype)), p["encoder"], cfg.d_model,
                                 cfg.n_heads, ftc=ftc)
        enc = shard(enc, "batch", "seq", "embed")
    if cfg.first_k_dense:
        for lp in p["dense_blocks"]:
            x = dense(x, lp, ftc)
    n_main = cfg.n_layers - cfg.first_k_dense
    if cfg.family == "hybrid":  # all-or-nothing: the shared block runs after every group
        for start, length in _hybrid_groups(cfg):
            for i in range(start, start + length):
                x = mamba(x, p["blocks"][i], ftc)
            x = dense_block(x, p["shared"], ftc)  # constrained inside, the reference's lm.py:436
    else:
        for lo, hi, fc in _layer_splits(n_main, ftc):
            for i in range(lo, hi):
                if cfg.family == "moe":
                    x, aux = moe(x, aux, p["blocks"][i], fc)
                elif cfg.family == "encdec":
                    x = decoder(x, enc, p["blocks"][i], fc)
                elif cfg.family == "ssm":
                    x = rwkv(x, p["blocks"][i], fc)
                else:
                    x = dense(x, p["blocks"][i], fc)
    if cfg.family == "moe":
        aux = aux / max(n_main, 1)
    if last_only:
        x = x[:, -1:]
    if return_hidden:
        return _norm(x, p["final_norm"], cfg), aux
    return _logits(x, p, cfg, ftc), aux


def loss_fn(params: Params, cfg: LMConfig, batch: dict, *, aux_weight: float = 0.01,
            ftc: FTContext | None = None) -> tuple[torch.Tensor, dict]:
    """(loss, {"loss": nll, "aux": aux}): the mean next-token NLL over
    ``batch["labels"]`` (labels < 0 masked) plus ``aux_weight`` times the
    MoE load-balancing loss.  With ``cfg.loss_chunks`` the NLL streams over
    vocab chunks (:func:`~repro_torch.models.layers.streamed_cross_entropy`)."""
    if cfg.loss_chunks:
        x, aux = forward(params, cfg, batch, ftc=ftc, return_hidden=True)
        table = params.get("lm_head", params["embed"]).to(cfg.dtype)
        nll = streamed_cross_entropy(x, table, batch["labels"], cfg.loss_chunks, cfg.vocab, ftc=ftc)
    else:
        logits, aux = forward(params, cfg, batch, ftc=ftc)
        nll = cross_entropy(logits, batch["labels"])
    return nll + aux_weight * aux, {"loss": nll, "aux": aux}


# --------------------------------------------------------------------------- #
# serve: cache init + single-token decode
# --------------------------------------------------------------------------- #
def init_cache(cfg: LMConfig, batch: int, smax: int, dtype=torch.bfloat16, *, device="cuda") -> Params:
    """{"attn": [per-layer cache]} for the main stack: GQA {k, v:
    (B,Smax,Hk,D), idx: (B,)} or MLA {c_kv: (B,Smax,kv_lora), k_rope:
    (B,Smax,d_rope), idx: (B,)}; plus "attn_dense" for the first
    ``first_k_dense`` layers, and for encdec "enc", the encoder output
    (B, enc_len, d) that cross-attention reads (zeros until a caller fills
    it).  ssm: {"rwkv": [per-layer {S: (B,H,dk,dk), x_tm, x_cm: (B,d)}]};
    hybrid: {"mamba": [per-layer {ssm: (B,H,N,P)}], "shared_attn":
    [per-group GQA cache]}.  The recurrent states are float32 whatever
    ``dtype``, as in the reference."""
    _require_ported(cfg)
    if cfg.family == "ssm":
        return {"rwkv": [rwkv6_cache_init(cfg.rwkv, batch, device=device) for _ in range(cfg.n_layers)]}
    if cfg.family == "hybrid":
        return {"mamba": [mamba2_cache_init(cfg.ssm, batch, device=device) for _ in range(cfg.n_layers)],
                "shared_attn": [gqa_cache_init(cfg.attn_cfg, batch, smax, dtype, device=device)
                                for _ in _hybrid_groups(cfg)]}

    def layers(n):
        if cfg.attn_kind == "mla":
            return [mla_cache_init(cfg.mla, batch, smax, dtype, device=device) for _ in range(n)]
        return [gqa_cache_init(cfg.attn_cfg, batch, smax, dtype, device=device) for _ in range(n)]

    if cfg.family == "encdec":
        return {"attn": ed.decoder_cache_init(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.n_layers, batch, smax, dtype,
                                              device=device),
                "enc": torch.zeros((batch, cfg.enc_len, cfg.d_model), dtype=dtype, device=device)}
    cache: Params = {"attn": layers(cfg.n_layers - cfg.first_k_dense)}
    if cfg.first_k_dense:
        cache["attn_dense"] = layers(cfg.first_k_dense)
    return cache


def _hybrid_groups(cfg: LMConfig) -> list[tuple[int, int]]:
    """[(start, length)] of the hybrid family's mamba-layer groups; the
    shared attention block runs after each."""
    ae = cfg.attn_every or cfg.n_layers
    return [(i, min(ae, cfg.n_layers - i)) for i in range(0, cfg.n_layers, ae)]


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


# the matmuls without batch dims: what jax.checkpoint_policies.
# checkpoint_dots_with_no_batch_dims keeps (a 2-D matmul lowers to one of
# these; einsums with batch dims lower to bmm and are recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(f, cfg: LMConfig):
    """One layer's body under ``torch.utils.checkpoint`` when ``cfg.remat``
    (the reference's ``jax.checkpoint``).  ``remat_policy="full"``: the
    backward recomputes the layer's activations instead of keeping them;
    ``"dots"``: the outputs of matmuls without batch dims are kept and the
    rest is recomputed, the attention ``bmm``s included (a selective
    checkpoint).  Either way the values are those of no remat, bit for bit.
    Without gradients it runs plain."""
    if not cfg.remat:
        return f
    if cfg.remat_policy not in ("full", "dots"):
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; known: full, dots")
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _dots_policy)

    def g(*args):
        if not torch.is_grad_enabled():
            return f(*args)
        return checkpoint(f, *args, use_reentrant=False, **kw)
    return g


def _logits(x, params, cfg: LMConfig, ftc: FTContext | None = None):
    x = _norm(x, params["final_norm"], cfg)
    table = params.get("lm_head", params["embed"])
    # table.T is a strided view of the tied table: the head matmul reads it
    # through its strides, never through a transposed copy
    logits = site_matmul(ftc, "head")(x, table.T)
    if cfg.padded_vocab != cfg.vocab:  # mask padded rows out of the softmax
        if is_dtensor(logits):  # a vocab-sharded slice cannot be written in place
            pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab
            logits = torch.where(pad, torch.full((), -1e30, dtype=logits.dtype, device=logits.device), logits)
        else:
            logits[..., cfg.vocab:] = -1e30
    return shard(logits, "batch", "seq", "vocab")


def _embed_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens``: a row gather.  On a DTensor table,
    the vocab-parallel lookup (:class:`_VocabParallelLookup`)."""
    if is_dtensor(table):
        return _VocabParallelLookup.apply(table, tokens)
    return table[tokens]


class _VocabParallelLookup(torch.autograd.Function):
    """Megatron's vocab-parallel embedding on DTensors, the reference's
    masked lookup and all-reduce.  Each device looks up the tokens that fall
    in its rows of a vocab-sharded table and writes zeros for the others; the
    rows are a pending sum (``Partial``) over the mesh axes that shard the
    vocab, which the next ``shard`` reduces.  The backward scatters each
    device's rows of the gradient into its shard of the table: a pending sum
    over the axes that shard the tokens.  (DTensor's own rule for
    ``embedding`` on a sharded table has no backward from a pending sum.)"""

    @staticmethod
    def forward(ctx, table, tokens):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        mesh = table.device_mesh
        if not is_dtensor(tokens):
            tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
        out_pl, grad_pl = [], []
        for tp, kp in zip(table.placements, tokens.placements):
            if isinstance(tp, Shard) and tp.dim == 0 and kp.is_replicate():
                out_pl.append(Partial())
                grad_pl.append(tp)
            elif tp.is_replicate():
                out_pl.append(kp)
                grad_pl.append(Replicate() if kp.is_replicate() else Partial())
            else:
                raise ValueError(f"an embedding table placed {table.placements} against tokens placed "
                                 f"{tokens.placements}: only the vocab dim may be sharded, by axes the tokens "
                                 "are replicated over")
        _, off = compute_local_shape_and_global_offset(tuple(table.shape), mesh, table.placements)
        tl, kl = table.to_local(), tokens.to_local()
        rows = tl.shape[0]
        rel = kl.long() - off[0]
        ok = ((rel >= 0) & (rel < rows))[..., None]
        rel = rel.clamp(0, rows - 1)
        out = torch.where(ok, tl[rel], torch.zeros((), dtype=tl.dtype, device=tl.device))
        ctx.save_for_backward(rel, ok)
        ctx.spec = (mesh, tuple(out_pl), tuple(grad_pl), tuple(table.shape), table.stride(), rows)
        shape = (*tokens.shape, table.shape[1])
        return DTensor.from_local(out, mesh, out_pl, run_check=False, shape=torch.Size(shape),
                                  stride=contiguous_strides(shape))

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor, Partial, Replicate

        rel, ok = ctx.saved_tensors
        mesh, out_pl, grad_pl, shape, stride, rows = ctx.spec
        g = grad.redistribute(mesh, [Replicate() if isinstance(p, Partial) else p for p in out_pl]).to_local()
        g = torch.where(ok, g, torch.zeros((), dtype=g.dtype, device=g.device))
        gt = torch.zeros((rows, shape[1]), dtype=g.dtype, device=g.device)
        gt.index_add_(0, rel.reshape(-1), g.reshape(-1, shape[1]))
        return DTensor.from_local(gt, mesh, grad_pl, run_check=False, shape=torch.Size(shape), stride=stride), None


def decode_step(
    params: Params,
    cfg: LMConfig,
    cache: Params,
    batch: dict,
    *,
    ftc: FTContext | None = None,
) -> tuple[torch.Tensor, Params]:
    """batch: {"token": (B, 1) int}.  Returns (logits (B,1,V), cache).

    ``params`` are the ``cfg.dtype`` working copies (:func:`cast_params`).
    The JAX counterpart (``repro/models/lm.py:533-553``) casts the f32
    masters to ``cfg.dtype`` inside every step; here that is done once, when
    the bundle is built (the values are identical), and must not come back
    per step: at full width the cast alone moves about 1.9 GB per step.
    The ``shard`` constraints are its own; they act on DTensors only (the
    sharded dry run) and are no-ops on the plain tensors a server holds.

    Every weight matmul of the protected layer prefix and the LM head routes
    through ``ftc``: attention projections, FFN, MoE router and experts.  The
    moe family's first-k dense blocks run with the whole ``ftc``, below the
    split main stack, as in the JAX package.  The encdec family's
    cross-attention projects K and V from ``cache["enc"]`` on every step,
    on the array.  The ssm family splits its RWKV6 stack as the dense one;
    the hybrid family runs every mamba layer and the shared block with the
    whole ``ftc``.  The cache is updated in place, lengths and recurrent
    states included, and the same dict is returned (see
    :func:`~repro_torch.models.attention.gqa_decode`): the port's
    counterpart of the reference step's donated cache.
    """
    _require_ported(cfg)
    x = shard(_embed_rows(params["embed"], batch["token"].long()), "batch", None, "embed")
    act = _ACTS[cfg.act]
    xcfg = ed.CrossAttnConfig(cfg.d_model, cfg.n_heads)

    def attn(x, lp, c, fc):
        if cfg.attn_kind == "mla":
            return mla_decode(x, lp, cfg.mla, c, fc)[0]
        return gqa_decode(x, lp, cfg.attn_cfg, c, fc)[0]

    # each block's output is constrained as in the reference (lm.py:562)
    def dense_block(x, lp, c, fc):
        x = x + attn(_norm(x, lp["ln1"], cfg), lp["attn"], c, fc)
        return shard(x + ffn(_norm(x, lp["ln2"], cfg), lp["ffn"], act=act, ftc=fc), "batch", None, "embed")

    def moe_block(x, lp, c, fc):
        x = x + attn(_norm(x, lp["ln1"], cfg), lp["attn"], c, fc)
        y, _ = moe_forward(_norm(x, lp["ln2"], cfg), lp["moe"], cfg.moe, ftc=fc)
        return shard(x + y, "batch", None, "embed")

    def decoder_block(x, lp, c, fc):
        x = x + gqa_decode(layernorm(x, lp["ln1"]), lp["attn"], cfg.attn_cfg, c, fc)[0]
        x = x + ed.cross_attn(layernorm(x, lp["ln_x"]), cache["enc"], lp["xattn"], xcfg, fc)
        return shard(x + ffn(layernorm(x, lp["ln2"]), lp["ffn"], act=_ACTS["gelu"], ftc=fc), "batch", None, "embed")

    def rwkv_block(x, lp, c, fc):
        return shard(rwkv6_decode(x, lp, cfg.rwkv, c, fc)[0], "batch", None, "embed")

    if cfg.family == "hybrid":
        for gi, (start, length) in enumerate(_hybrid_groups(cfg)):
            for i in range(start, start + length):
                lp = params["blocks"][i]
                x = shard(x + mamba2_decode(_norm(x, lp["ln"], cfg), lp["mamba"], cfg.ssm, cache["mamba"][i], ftc)[0],
                          "batch", None, "embed")
            x = dense_block(x, params["shared"], cache["shared_attn"][gi], ftc)
        return _logits(x, params, cfg, ftc), cache
    if cfg.first_k_dense:
        for lp, c in zip(params["dense_blocks"], cache["attn_dense"]):
            x = dense_block(x, lp, c, ftc)
    block = {"moe": moe_block, "encdec": decoder_block, "ssm": rwkv_block}.get(cfg.family, dense_block)
    layer_caches = cache["rwkv" if cfg.family == "ssm" else "attn"]
    for lo, hi, fc in _layer_splits(cfg.n_layers - cfg.first_k_dense, ftc):
        for i in range(lo, hi):
            x = block(x, params["blocks"][i], layer_caches[i], fc)
    return _logits(x, params, cfg, ftc), cache
