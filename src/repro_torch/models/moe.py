"""Mixture-of-Experts FFN with GShard-style capacity dispatch, token-grouped.

Dispatch and combine are einsums over a one-hot (B, G, E, C) tensor, as in
the JAX package; they are plain einsums here as there (outside any kernel;
``dist.sharding.einsum``, which is ``torch.einsum`` on plain tensors).  The three expert matmuls go through ``ftc.einsum(...,
site="moe.expert")`` (one ``ft_matmul_batched`` launch each under the fused
dispatch), the router through ``site_matmul(ftc, "moe.router")``.

Every expert is computed, padded and unrouted ones included, as the JAX
package does: with an exponent-bit fault an unrouted expert's output can be
inf, and ``0 · inf`` in the combine einsum is NaN, so skipping experts would
change results.

Experts whose count does not divide a mesh axis are padded (``pad_to``); the
router masks the padded experts' logits to -1e30, so they are never routed
to.  Covers deepseek-moe-16b (64 routed top-6 + 2 shared) and granite-moe
(40 routed top-8, padded to 48, no shared).

Two options serve DeepSeek-V3 (``configs/deepseek_v3.py``):

* ``scoring="sigmoid"``: its router (``noaux_tc``).  The logits come from
  float32 operands (the published gate's), ``s = sigmoid(logits)``; the
  experts are chosen on ``s + bias`` (the score-correction bias, for
  selection only): each group of ``n_experts / n_group`` scores the sum of
  its two best, the best ``topk_group`` groups are kept, and the top-k of
  the kept experts by a stable sort (ties to the lower index) are the
  picks; each pick's weight is ``s`` there, normalised over the picks
  (``norm_topk``) and times ``routed_scale``.  The default, ``"softmax"``,
  is the path above, bit for bit.
* ``experts_held``: the layer holds experts ``[expert_offset,
  expert_offset + experts_held)`` of the ``n_experts`` (one chip's share of
  an expert-parallel layout).  Routing, each expert's capacity and each
  pick's queue position are those of the whole layer; dispatch and combine
  then keep the held experts' columns only, so the layer computes its own
  experts' part of the output, plus the shared experts.  Nothing stands in
  for the experts held elsewhere.  Such a layer counts its picks
  (:mod:`repro_torch.obs.router`).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.ftcontext import site_matmul
from repro_torch.dist.sharding import einsum, shard
from repro_torch.models.layers import Params, dense_init, ffn, ffn_init
from repro_torch.obs import router as router_tally


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    n_experts: int
    top_k: int
    d_expert: int  # per-expert FFN hidden size
    n_shared: int = 0
    d_shared: int = 0  # shared-expert FFN hidden (fine-grained MoE)
    capacity_factor: float = 1.25
    group_size: int = 2048  # tokens per dispatch group (GShard group dim)
    pad_to: int = 0         # pad the expert count (0 = no padding)
    scoring: str = "softmax"  # softmax | sigmoid (module docstring)
    n_group: int = 1        # sigmoid: expert groups, of which topk_group are kept
    topk_group: int = 1
    routed_scale: float = 1.0  # sigmoid: the picks' weights' factor
    norm_topk: bool = True  # sigmoid: normalise the picks' weights
    experts_held: int = 0   # the experts this layer holds (0: all of them)
    expert_offset: int = 0  # the first held expert

    def __post_init__(self):
        if self.scoring not in ("softmax", "sigmoid"):
            raise ValueError(f"unknown MoE scoring {self.scoring!r}; known: softmax, sigmoid")
        if self.experts_held and (self.pad_to > self.n_experts
                                  or self.expert_offset + self.experts_held > self.n_experts):
            raise ValueError(f"experts [{self.expert_offset}, {self.expert_offset + self.experts_held}) "
                             f"are not a share of {self.n_experts} unpadded experts")

    @property
    def n_padded(self) -> int:
        return max(self.pad_to, self.n_experts)

    @property
    def n_held(self) -> int:
        """The experts whose weights the layer holds."""
        return self.experts_held or self.n_padded


def moe_init(gen: torch.Generator, cfg: MoEConfig, *, device="cuda") -> Params:
    e, d, f = cfg.n_held, cfg.d_model, cfg.d_expert

    def normal(shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=device) * 0.02

    p = {
        "router": dense_init(gen, d, cfg.n_padded, scale=0.006, device=device),
        "gate": normal((e, d, f)),
        "up": normal((e, d, f)),
        "down": normal((e, f, d)),
    }
    if cfg.scoring == "sigmoid":  # the score-correction bias
        p["bias"] = normal((cfg.n_experts,))
    if cfg.n_shared:
        p["shared"] = ffn_init(gen, d, cfg.d_shared or cfg.d_expert * cfg.n_shared, device=device)
    return p


def _topk_dispatch(gates: torch.Tensor, top_k: int, capacity: int):
    """gates: (B, G, E) probabilities.  Returns the dispatch (B, G, E, C)
    one-hot and the combine weights; capacity-dropped tokens get zero weight.

    The top-k is a stable descending sort cut at k, so on tied gates the
    lower expert index comes first, as ``jax.lax.top_k`` orders them."""
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :top_k], topi[..., :top_k]  # (B, G, k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)  # renormalise
    return _dispatch_picks(topv, topi, gates.shape[-1], capacity)


def _sigmoid_topk(logits: torch.Tensor, bias: torch.Tensor, cfg: MoEConfig):
    """logits: (B, G, E) f32.  DeepSeek-V3's group-limited pick (module
    docstring): (weights, expert ids), each (B, G, k), and the sigmoid
    scores (B, G, E)."""
    b, g, e = logits.shape
    s = torch.sigmoid(logits)
    choice = s + bias.to(torch.float32)
    per = e // cfg.n_group
    group_score = choice.view(b, g, cfg.n_group, per).topk(2, dim=-1).values.sum(-1)  # (B, G, n_group)
    kept = torch.sort(group_score, dim=-1, descending=True, stable=True).indices[..., :cfg.topk_group]
    keep = torch.zeros_like(group_score, dtype=torch.bool).scatter_(-1, kept, True)
    choice = choice.masked_fill(~keep.repeat_interleave(per, dim=-1), float("-inf"))
    topi = torch.sort(choice, dim=-1, descending=True, stable=True).indices[..., :cfg.top_k]
    topv = s.gather(-1, topi)
    if cfg.norm_topk:
        topv = topv / (topv.sum(-1, keepdim=True) + 1e-20)
    return topv * cfg.routed_scale, topi, s


def _dispatch_picks(topv: torch.Tensor, topi: torch.Tensor, e: int, capacity: int):
    """topv, topi: (B, G, k) weights and expert ids of the picks, best
    first.  The dispatch (B, G, E, C) one-hot and the combine weights over
    ``e`` experts, a pick past its expert's capacity dropped."""
    b, g, top_k = topi.shape
    experts = torch.arange(e, device=topi.device)
    onehot = (topi.movedim(-1, 0)[..., None] == experts).to(torch.float32)  # (k, B, G, E)
    # queue position per token within its expert, counted across (slot, token)
    flat = onehot.movedim(0, 1).reshape(b, top_k * g, e)  # slot-major
    pos = torch.cumsum(flat, dim=1).reshape(b, top_k, g, e).movedim(1, 0) - 1.0  # (k, B, G, E)
    keep = (pos < capacity) * onehot
    # a token occupies at most one slot per expert -> collapse k first
    pos_ne = (pos * onehot).sum(0)  # (B, G, E)
    keep_ne = keep.sum(0)           # (B, G, E)
    gate_ne = einsum("bgk,kbge->bge", topv, onehot)
    # one_hot(pos, C): a position past capacity is an all-zero row
    slots = torch.arange(capacity, device=topi.device)
    dispatch = keep_ne[..., None] * (pos_ne.to(torch.int32)[..., None] == slots).to(torch.float32)
    combine = dispatch * gate_ne[..., None]
    return dispatch, combine


def _group_forward(xg: torch.Tensor, p: Params, cfg: MoEConfig, ftc=None):
    """xg: (B, G, d), one token group per batch row.  Returns (out, aux)."""
    b, g, d = xg.shape
    capacity = max(1, int(cfg.capacity_factor * cfg.top_k * g / cfg.n_experts))
    if cfg.scoring == "sigmoid":
        # the published gate's float32 operands (ft_matmul's CUDA-core path)
        logits = site_matmul(ftc, "moe.router")(xg.to(torch.float32), p["router"].to(torch.float32))
        topv, topi, gates = _sigmoid_topk(logits, p["bias"], cfg)
        dispatch, combine = _dispatch_picks(topv, topi, cfg.n_experts, capacity)
    else:
        logits = site_matmul(ftc, "moe.router")(xg, p["router"]).to(torch.float32)  # (B, G, E_pad)
        if cfg.n_padded != cfg.n_experts:  # mask padded experts out of routing
            dead = torch.arange(cfg.n_padded, device=xg.device) >= cfg.n_experts
            logits = logits.masked_fill(dead, -1e30)
        gates = torch.softmax(logits, dim=-1)
        dispatch, combine = _topk_dispatch(gates, cfg.top_k, capacity)
    aux = None
    if cfg.experts_held:  # this layer's share: its experts' columns, the aux loss over all
        aux = _aux_loss(gates, dispatch, cfg)
        lo, hi = cfg.expert_offset, cfg.expert_offset + cfg.experts_held
        dispatch, combine = dispatch[:, :, lo:hi], combine[:, :, lo:hi]
        held = ((topi >= lo) & (topi < hi)).sum()
        router_tally.add(torch.full((), topi.numel(), dtype=torch.int64, device=xg.device), held,
                         held - dispatch.sum().to(torch.int64))
    # on DTensors the dispatch and combine are cut to each device's experts
    # first (a local slice), so that the einsums gather and scatter only its
    # experts' rows: GSPMD infers this from the constraint on xe
    dispatch = shard(dispatch, "batch", None, "expert", None)
    combine = shard(combine, "batch", None, "expert", None)
    xe = einsum("bgec,bgd->becd", dispatch.to(xg.dtype), xg)  # (B, E, C, d)
    xe = shard(xe, "batch", "expert", None, None)  # the reference's moe.py:105
    # per-expert matmuls: each expert is one virtual-array execution
    ein = (lambda s, a, w: ftc.einsum(s, a, w, site="moe.expert")) if ftc is not None else einsum
    h = F.silu(ein("becd,edf->becf", xe, p["gate"].to(xg.dtype)))
    h = h * ein("becd,edf->becf", xe, p["up"].to(xg.dtype))
    ye = ein("becf,efd->becd", h, p["down"].to(xg.dtype))
    out = einsum("bgec,becd->bgd", combine.to(xg.dtype), ye)
    return out, _aux_loss(gates, dispatch, cfg) if aux is None else aux


def _aux_loss(gates: torch.Tensor, dispatch: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """The load-balancing aux loss (Switch-style), over real experts only."""
    me = gates[..., : cfg.n_experts].mean((0, 1))
    ce = dispatch[..., : cfg.n_experts, :].sum(-1).mean((0, 1))
    return cfg.n_experts * torch.sum(me * ce)


def moe_forward(x: torch.Tensor, p: Params, cfg: MoEConfig, *, ftc=None):
    """x: (B, S, d).  Returns (out, aux_loss).  Tokens stream through dispatch
    groups of ``cfg.group_size`` within each batch row (a Python loop over
    groups)."""
    b, s, d = x.shape
    gsz = min(cfg.group_size, s)
    if s % gsz:  # awkward sequence lengths: one group per row
        gsz = s
    n_groups = s // gsz
    if n_groups == 1:
        out, aux = _group_forward(x, p, cfg, ftc)
        return out + _shared(x, p, ftc), aux
    outs, auxs = [], []
    for i in range(n_groups):
        o, a = _group_forward(x[:, i * gsz:(i + 1) * gsz], p, cfg, ftc)
        outs.append(o)
        auxs.append(a)
    return torch.cat(outs, dim=1) + _shared(x, p, ftc), torch.stack(auxs).sum() / n_groups


def _shared(x: torch.Tensor, p: Params, ftc=None) -> torch.Tensor:
    return ffn(x, p["shared"], ftc=ftc) if "shared" in p else torch.zeros_like(x)
