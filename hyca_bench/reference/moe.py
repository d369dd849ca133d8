"""Plain float32 reference of the moe family (granite-moe-3b-a800m,
deepseek-moe-16b), written from the configuration's equations.  It imports
torch only: no kernel, cache or batching of the port.

A layer is pre-norm: ``x += attn(rms(x) * ln1)``, then ``x += ffn(rms(x)
* ln2)``, where ffn is the gated SiLU FFN for a dense layer and, for an MoE
layer, the top-k routed experts plus the shared experts.  Attention is
causal GQA (MHA when the KV heads equal the heads) with the rotate-half
RoPE on q and k, scores in float32 scaled by 1/sqrt(head_dim).  The router
takes the softmax of the published experts' logits, keeps the top k (ties
to the lower index) and renormalises their weights when
``norm_topk_prob``.  The head is ``rms(x) * final_norm @ table.T`` over the
published vocabulary.

Routing comes in two forms, as the port runs them: per token (a served
decode step, where each slot's token is a dispatch group of its own and
nothing is dropped), and by capacity (a prefill: each row's tokens form
dispatch groups of up to ``dispatch_group`` tokens; an expert takes at most
``capacity = int(capacity_factor * top_k * g / E)`` of a group's picks,
counted first by pick rank, then by token; a pick past it adds nothing).

``quant="fp8"`` is the control: the model one precision below the
configuration's bf16, which every tensor the port holds in bf16 is held in
here in float8 e4m3 (absmax-scaled to 448: activations per row, weights per
output column): the embedding rows, every linear layer's input, weight and
output, q and k after RoPE, the residual stream after each add and the MoE
output.  Products accumulate in float32, and what the port computes in
float32 (norm statistics, scores, softmax, router gates) stays so.

``weights(part)`` gives a part's leaves in float32 (``embed``, ``head``,
``dense.<i>``, ``moe.<i>``; the benchmark draws them); the model is run a
layer at a time over every sequence, so one layer's weights are held at a
time.
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


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D) at positions 0..S-1, rotate-half form."""
    s, d = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs  # (S, D/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(x: torch.Tensor, w: dict, m: dict, quant: str | None, q_block: int = 512) -> torch.Tensor:
    b, s, _ = x.shape
    hd, h, hk = m["head_dim"], m["num_attention_heads"], m["num_key_value_heads"]
    q = store(rope(linear(x, w["wq"], quant).view(b, s, h, hd), m["rope_theta"]), quant)
    k = store(rope(linear(x, w["wk"], quant).view(b, s, hk, hd), m["rope_theta"]), quant)
    v = linear(x, w["wv"], quant).view(b, s, hk, hd)
    k = k.repeat_interleave(h // hk, dim=2).transpose(1, 2)  # (B, H, S, D): head i reads KV head i // (h/hk)
    v = v.repeat_interleave(h // hk, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    out = torch.empty_like(q)
    pos = torch.arange(s, device=x.device)
    for lo in range(0, s, q_block):
        hi = min(s, lo + q_block)
        sc = q[:, :, lo:hi] @ k.transpose(-1, -2) / math.sqrt(hd)
        sc = sc.masked_fill(pos[None, :] > pos[lo:hi, None], float("-inf"))
        out[:, :, lo:hi] = torch.softmax(sc, dim=-1) @ v
    return linear(out.transpose(1, 2).reshape(b, s, h * hd), w["wo"], quant)


def gated_ffn(x: torch.Tensor, gate, up, down, quant: str | None) -> torch.Tensor:
    return linear(F.silu(linear(x, gate, quant)) * linear(x, up, quant), down, quant)


def route(x: torch.Tensor, w: dict, m: dict, quant: str | None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (N, d) -> (expert ids, weights), each (N, top_k), best first."""
    e, k = m["num_local_experts"], m["num_experts_per_tok"]
    gates = torch.softmax(linear(x, w["router"][:, :e], quant), dim=-1)
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    if m["norm_topk_prob"]:
        topv = topv / topv.sum(-1, keepdim=True)
    return topi, topv


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
    e, k = m["num_local_experts"], m["num_experts_per_tok"]
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
    for ex in range(e):
        tok, slot = torch.nonzero(topi == ex, as_tuple=True)
        if tok.numel():
            y = gated_ffn(flat[tok], w["gate"][ex], w["up"][ex], w["down"][ex], quant)
            out.index_add_(0, tok, y * topv[tok, slot, None])
    if m["n_shared_experts"]:
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
