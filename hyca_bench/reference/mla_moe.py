"""Plain float32 reference of the mla_moe family (DeepSeek-V3, and one
chip's share of its experts), written from the published equations: HF
``modeling_deepseek_v3`` and arXiv:2412.19437.  It imports torch only: no
kernel, cache or batching of the port.

A layer is pre-norm: ``x += attn(rms(x) * ln1)``, then ``x += ffn(rms(x)
* ln2)``, where ffn is the gated SiLU FFN for the first
``first_k_dense_replace`` layers and the MoE for the others.

Attention is MLA, causal, every sequence at positions 0..S-1.  The query
is ``rms(x @ wq_a) * q_norm @ wq_b``, per head ``qk_nope_head_dim`` values
without position and ``qk_rope_head_dim`` with RoPE.  ``x @ wkv_a`` gives
the latent (``kv_lora_rank``), normed by ``kv_norm``, and one RoPE key for
all heads; ``latent @ wkv_b`` gives each head's key (without position) and
value.  RoPE is YaRN's (``rope_scaling``): frequencies blended between the
base ones and those ``factor`` times slower over a linear ramp of the dims,
cos and sin scaled by ``mscale(factor, mscale) / mscale(factor,
mscale_all_dim)``; the rotated pairs are interleaved, (x[2i], x[2i+1]),
and moved to the rotate-half layout first.  Scores in float32, scaled by
``(nope + rope) ** -0.5 * mscale(factor, mscale_all_dim) ** 2``.

The router (``noaux_tc``): ``s = sigmoid(x @ router)``; experts are chosen
on ``s + bias``: each of ``n_group`` groups scores the sum of its two best,
the best ``topk_group`` groups are kept, and the ``num_experts_per_tok``
best kept experts (ties to the lower index) are the picks; their weights
are ``s``, normalised over the picks and times ``routed_scaling_factor``.
The layer holds experts ``[expert_offset, expert_offset + experts_held)``
of the ``n_routed_experts``: the router runs over all of them, and only
the held experts' part of the output is computed, plus the shared expert;
nothing stands in for the other experts.  The head is ``rms(x) *
final_norm @ lm_head.T`` over the published vocabulary.

Routing comes in two forms, as the port runs them: per token (a served
decode step, where each slot's token is a dispatch group of its own and
nothing is dropped), and by capacity (a prefill: each row's tokens form
dispatch groups of up to ``dispatch_group`` tokens; an expert takes at most
``capacity = int(capacity_factor * top_k * g / n_routed_experts)`` of a
group's picks, counted over all the experts first by pick rank, then by
token; a pick past it adds nothing).

``quant="fp8"`` is the control: the model one precision below the
configuration's bf16, which every tensor the port holds in bf16 is held in
here in float8 e4m3 (absmax-scaled to 448: activations per row, weights per
output column): the embedding rows, every linear layer's input, weight and
output, the RoPE'd query and key, the residual stream after each add and
the MoE output; the router's operands (the port casts them to float32).
Products accumulate in float32, and what the port computes in float32
(norm statistics, scores, softmax, router logits and gates) stays so.

``weights(part)`` gives a part's leaves in float32 (``embed``, ``head``,
``dense.<i>``, ``moe.<i>``; the benchmark draws them); the model is run a
layer at a time over every sequence.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

Weights = Callable[[str], dict]


def exact_matmuls() -> None:
    """float32 matmuls in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _q8(t: torch.Tensor, dim: int) -> torch.Tensor:
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def store(x: torch.Tensor, quant: str | None) -> torch.Tensor:
    """``x`` as held between operations: float32, or the control's fp8."""
    if quant is None:
        return x
    if quant != "fp8":
        raise ValueError(f"unknown quant {quant!r}")
    return _q8(x, -1)


def linear(x: torch.Tensor, w: torch.Tensor, quant: str | None) -> torch.Tensor:
    """``x @ w`` with ``w`` (fan_in, fan_out), in float32 or the control's fp8."""
    if quant is not None:
        x, w = store(x, quant), _q8(w, -2)
    return store(x @ w, quant)


def rms(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * g


# --------------------------------------------------------------------------- #
# YaRN RoPE, transcribed from DeepseekV3YarnRotaryEmbedding
# --------------------------------------------------------------------------- #
def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(m: dict) -> torch.Tensor:
    """(rope / 2,) float32 frequencies of the configuration's YaRN RoPE."""
    rs, dim, base = m["rope_scaling"], m["qk_rope_head_dim"], m["rope_theta"]
    orig = rs["original_max_position_embeddings"]

    def correction_dim(rotations):
        return dim * math.log(orig / (rotations * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(correction_dim(rs["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    extra = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    inter = 1.0 / (rs["factor"] * base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def softmax_scale(m: dict) -> float:
    rs = m["rope_scaling"]
    s = (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]) ** -0.5
    return s * yarn_mscale(rs["factor"], rs["mscale_all_dim"]) ** 2


def rope(x: torch.Tensor, m: dict) -> torch.Tensor:
    """x: (B, S, H, D) at positions 0..S-1: interleaved pairs moved to
    halves, then ``x * cos + rotate_half(x) * sin``."""
    s, d = x.shape[1], x.shape[-1]
    rs = m["rope_scaling"]
    if m["rope_interleave"]:
        x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).reshape(x.shape)
    freqs = torch.outer(torch.arange(s, dtype=torch.float32), yarn_inv_freq(m)).to(x.device)
    emb = torch.cat([freqs, freqs], dim=-1)
    ms = yarn_mscale(rs["factor"], rs["mscale"]) / yarn_mscale(rs["factor"], rs["mscale_all_dim"])
    cos, sin = (emb.cos() * ms)[:, None], (emb.sin() * ms)[:, None]
    rotated = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * cos + rotated * sin


# --------------------------------------------------------------------------- #
# the layers
# --------------------------------------------------------------------------- #
def attention(x: torch.Tensor, w: dict, m: dict, quant: str | None, q_block: int = 512) -> torch.Tensor:
    b, s, _ = x.shape
    eps = m["rms_norm_eps"]
    h, kl = m["num_attention_heads"], m["kv_lora_rank"]
    dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    q = linear(rms(linear(x, w["wq_a"], quant), w["q_norm"], eps), w["wq_b"], quant).view(b, s, h, dn + dr)
    kv_a = linear(x, w["wkv_a"], quant)
    kv = linear(rms(kv_a[..., :kl], w["kv_norm"], eps), w["wkv_b"], quant).view(b, s, h, dn + dv)
    q_pe = store(rope(q[..., dn:], m), quant)
    k_pe = store(rope(kv_a[..., kl:][:, :, None], m), quant)             # (B, S, 1, rope): every head's
    qf = torch.cat([q[..., :dn], q_pe], dim=-1).transpose(1, 2)          # (B, H, S, nope + rope)
    kf = torch.cat([kv[..., :dn], k_pe.expand(b, s, h, dr)], dim=-1).transpose(1, 2)
    v = kv[..., dn:].transpose(1, 2)                                     # (B, H, S, v)
    scale = softmax_scale(m)
    out = torch.empty((b, h, s, dv), dtype=torch.float32, device=x.device)
    pos = torch.arange(s, device=x.device)
    for lo in range(0, s, q_block):
        hi = min(s, lo + q_block)
        sc = qf[:, :, lo:hi] @ kf.transpose(-1, -2) * scale
        sc = sc.masked_fill(pos[None, :] > pos[lo:hi, None], float("-inf"))
        out[:, :, lo:hi] = torch.softmax(sc, dim=-1) @ v
    return linear(out.transpose(1, 2).reshape(b, s, h * dv), w["wo"], quant)


def gated_ffn(x: torch.Tensor, gate, up, down, quant: str | None) -> torch.Tensor:
    return linear(F.silu(linear(x, gate, quant)) * linear(x, up, quant), down, quant)


def route(x: torch.Tensor, w: dict, m: dict, quant: str | None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (N, d) -> (expert ids, weights), each (N, top_k), best first."""
    k, n_group, per = m["num_experts_per_tok"], m["n_group"], m["n_routed_experts"] // m["n_group"]
    router = w["router"] if quant is None else _q8(w["router"], -2)
    s = torch.sigmoid(store(x, quant) @ router)
    choice = s + w["bias"]
    group = choice.view(-1, n_group, per).topk(2, dim=-1).values.sum(-1)
    kept = torch.sort(group, dim=-1, descending=True, stable=True).indices[:, : m["topk_group"]]
    allowed = torch.zeros_like(group, dtype=torch.bool).scatter_(1, kept, True).repeat_interleave(per, dim=1)
    topi = torch.sort(choice.masked_fill(~allowed, float("-inf")), dim=-1, descending=True,
                      stable=True).indices[:, :k]
    topv = s.gather(1, topi)
    if m["norm_topk_prob"]:
        topv = topv / (topv.sum(-1, keepdim=True) + 1e-20)
    return topi, topv * m["routed_scaling_factor"]


def capacity_keep(topi: torch.Tensor, n_experts: int, capacity: int) -> torch.Tensor:
    """topi: (g, k) picks of one dispatch group -> (g, k) bool: the pick is
    within its expert's capacity, counted over picks in rank-major order
    (every token's first pick, then every token's second, ...)."""
    g, k = topi.shape
    onehot = F.one_hot(topi.t().reshape(-1), n_experts)          # (k*g, E), rank-major
    pos = (torch.cumsum(onehot, dim=0) - 1).gather(1, topi.t().reshape(-1, 1))[:, 0]
    return (pos < capacity).view(k, g).t()


def moe(x: torch.Tensor, w: dict, m: dict, quant: str | None, routing: str) -> torch.Tensor:
    """x: (B, S, d).  ``routing``: "token" or "capacity" (see the module)."""
    b, s, d = x.shape
    e, k = m["n_routed_experts"], m["num_experts_per_tok"]
    flat = x.reshape(b * s, d)
    topi, topv = route(flat, w, m, quant)
    if routing == "capacity":
        g = min(m["dispatch_group"], s)
        if s % g:
            g = s
        cap = max(1, int(m["capacity_factor"] * k * g / e))
        keep = torch.cat([capacity_keep(grp, e, cap) for grp in topi.view(b * s // g, g, k)])
        topv = topv * keep
    elif routing != "token":
        raise ValueError(f"unknown routing {routing!r}")
    out = torch.zeros_like(flat)
    for i in range(m["experts_held"]):
        tok, slot = torch.nonzero(topi == m["expert_offset"] + i, as_tuple=True)
        if tok.numel():
            y = gated_ffn(flat[tok], w["gate"][i], w["up"][i], w["down"][i], quant)
            out.index_add_(0, tok, y * topv[tok, slot, None])
    out = out + gated_ffn(flat, w["shared.gate"], w["shared.up"], w["shared.down"], quant)
    return store(out.view(b, s, d), quant)


def layer(x: torch.Tensor, w: dict, m: dict, kind: str, quant: str | None, routing: str) -> torch.Tensor:
    eps = m["rms_norm_eps"]
    x = store(x + attention(rms(x, w["ln1"], eps), w, m, quant), quant)
    h = rms(x, w["ln2"], eps)
    if kind == "dense":
        return store(x + gated_ffn(h, w["ffn.gate"], w["ffn.up"], w["ffn.down"], quant), quant)
    return store(x + moe(h, w, m, quant, routing), quant)


def layer_parts(m: dict) -> list[str]:
    n_dense = m["first_k_dense_replace"]
    return [f"dense.{i}" for i in range(n_dense)] + [f"moe.{i}" for i in range(m["num_hidden_layers"] - n_dense)]


def hidden(m: dict, weights: Weights, batches: list[torch.Tensor], *, quant: str | None = None,
           routing: str = "token") -> list[torch.Tensor]:
    """Final hidden states (before the final norm) of each token batch
    (B, S) of ids, every batch at positions 0..S-1, run a layer at a time."""
    table = weights("embed")["embed"]
    xs = [store(table[t], quant) for t in batches]
    del table
    for part in layer_parts(m):
        w = weights(part)
        xs = [layer(x, w, m, part.split(".")[0], quant, routing) for x in xs]
        del w
    return xs


def head(m: dict, weights: Weights, h: torch.Tensor, quant: str | None = None) -> torch.Tensor:
    """Logits over the published vocabulary of hidden states h (..., d)."""
    w = weights("head")
    table = w["lm_head"] if "lm_head" in w else weights("embed")["embed"]
    x = rms(h, w["final_norm"], m["rms_norm_eps"])
    return linear(x, table[: m["vocab_size"]].t(), quant)


def teacher_forced(m: dict, weights: Weights, seqs: list[torch.Tensor], starts: list[int], *,
                   quant: str | None = None) -> list[torch.Tensor]:
    """Logits (n_i - starts_i, V) at positions starts_i..n_i-1 of each
    sequence of ids, with per-token routing: what a served decode step
    computes at each position."""
    hs = hidden(m, weights, [s[None] for s in seqs], quant=quant, routing="token")
    return [head(m, weights, h[0, st:], quant) for h, st in zip(hs, starts)]


def prefill_last(m: dict, weights: Weights, batches: list[torch.Tensor], *,
                 quant: str | None = None) -> list[torch.Tensor]:
    """Last-position logits (B, V) of each (B, S) batch, with capacity
    routing: what a prefill computes."""
    hs = hidden(m, weights, batches, quant=quant, routing="capacity")
    return [head(m, weights, h[:, -1], quant) for h in hs]
