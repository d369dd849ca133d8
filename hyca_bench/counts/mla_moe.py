"""The benchmark's own count of the work of the mla_moe family's passes
(DeepSeek-V3 on one chip's share of the experts), from the configuration's
published sizes alone, whatever implements them.

A protected linear call (``ft_matmul``) of M rows, K in, N out counts
2 M K N operations and reads x and w once and writes the output once, in
bf16; the router's operands and output are float32 (the published gate's),
held to the same peak.  A prefill pass of B sequences of S tokens makes, a
layer: the query's LoRA pair (q_a, q_b), the latent (kv_a), the latent's
expansion to keys and values (kv_b), the output projection (o); a dense
layer's FFN, or an MoE layer's router, held experts and shared expert.  An
MoE layer runs one dispatch group at a time (``dispatch_group`` tokens of
a row, or the whole row where that does not divide it): each group makes a
router call over its B x g rows and three expert calls
(``ft_matmul_batched``) over the held experts, each at its capacity of
``int(capacity_factor * top_k * g / n_routed_experts)`` rows of each of
the B rows, all of them computed.  The head runs on the last positions.
(The family's one cell is a prefill: a served decode step, which absorbs
``wkv_b`` into the attention core, is not counted here.)

The attention core is no protected call: one entry a pass, kernel
``mla_attn``, counts every layer's causal work ``B H S (S + 1) / 2 x 2
(nope + rope + v)`` and the bytes of the query, the latent (kv_lora + rope
a token) and the output in bf16, whatever implements it
(:func:`mla_attn_bound_s`).
"""
from __future__ import annotations

import json
from pathlib import Path

BYTES = 2  # bf16 operands and outputs
F32 = 4

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def _call(kernel: str, m: int, k: int, n: int, *, w_bytes: float | None = None, elt: int = BYTES) -> dict:
    w = k * n * elt if w_bytes is None else w_bytes
    return {"kernel": kernel, "flops": 2.0 * m * k * n, "bytes": float((m * k + m * n) * elt + w)}


def _layers(m: dict) -> list[str]:
    n_dense = m["first_k_dense_replace"]
    return ["dense"] * n_dense + ["moe"] * (m["num_hidden_layers"] - n_dense)


def group_size(m: dict, s: int) -> int:
    """Tokens of a dispatch group in a row of ``s`` tokens."""
    g = min(m["dispatch_group"], s)
    return s if s % g else g


def capacity(m: dict, g: int) -> int:
    return max(1, int(m["capacity_factor"] * m["num_experts_per_tok"] * g / m["n_routed_experts"]))


def attn_cores(m: dict, b: int, s: int) -> dict:
    """Every layer's attention core over B causal sequences of S tokens."""
    h, dn, dr, dv = m["num_attention_heads"], m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    t, n = b * s, m["num_hidden_layers"]
    flops = n * b * h * s * (s + 1) / 2 * 2.0 * (dn + dr + dv)
    nbytes = n * (t * h * (dn + dr) + t * (m["kv_lora_rank"] + dr) + t * h * dv) * BYTES
    return {"kernel": "mla_attn", "b": b, "s": s, "flops": flops, "bytes": float(nbytes)}


def calls(m: dict, tokens: int, head_rows: int) -> list[dict]:
    """The calls of one prefill over ``tokens`` token rows in ``head_rows``
    sequences of equal length (B x S rows, B sequences) with the head over
    the last positions, each as {kernel, flops, bytes}: the protected
    linear calls and the attention cores."""
    d, h = m["hidden_size"], m["num_attention_heads"]
    ql, kl = m["q_lora_rank"], m["kv_lora_rank"]
    dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    t, b = tokens, head_rows
    s = t // b
    out = []
    for kind in _layers(m):
        out += [_call("ft_matmul", t, d, ql), _call("ft_matmul", t, ql, h * (dn + dr)),
                _call("ft_matmul", t, d, kl + dr), _call("ft_matmul", t, kl, h * (dn + dv)),
                _call("ft_matmul", t, h * dv, d)]
        if kind == "dense":
            f = m["intermediate_size"]
            out += [_call("ft_matmul", t, d, f), _call("ft_matmul", t, d, f), _call("ft_matmul", t, f, d)]
            continue
        held, f = m["experts_held"], m["moe_intermediate_size"]
        g = group_size(m, s)
        rows = held * b * capacity(m, g)
        for _ in range(s // g):
            out.append(_call("ft_matmul", b * g, d, m["n_routed_experts"], elt=F32))
            out += [_call("ft_matmul_batched", rows, d, f, w_bytes=held * d * f * BYTES),
                    _call("ft_matmul_batched", rows, d, f, w_bytes=held * d * f * BYTES),
                    _call("ft_matmul_batched", rows, f, d, w_bytes=held * f * d * BYTES)]
        sf = m["n_shared_experts"] * f
        out += [_call("ft_matmul", t, d, sf), _call("ft_matmul", t, d, sf), _call("ft_matmul", t, sf, d)]
    return out + [_call("ft_matmul", head_rows, d, m["vocab_size"]), attn_cores(m, b, s)]


def bound_s(call: dict) -> float:
    """The least time the chip could take for ``call``: its operations at
    the bf16 peak or its bytes at the HBM peak, whichever is longer."""
    return max(call["flops"] / PEAKS["bf16_flops_per_s"], call["bytes"] / PEAKS["hbm_bytes_per_s"])


def mla_attn_bound_s(m: dict, b: int, s: int) -> float:
    """The least time of a prefill's attention cores, every layer, over B
    causal sequences of S tokens (:func:`attn_cores` at :func:`bound_s`)."""
    return bound_s(attn_cores(m, b, s))


def token_flops(m: dict) -> float:
    """Operations of one prefilled token's linear layers, the head left
    out: the projections, the dense FFNs and shared experts, the router,
    and of the routed experts the share a token is expected to send to the
    held ones (``top_k x experts_held / n_routed_experts`` experts)."""
    d, h = m["hidden_size"], m["num_attention_heads"]
    ql, kl = m["q_lora_rank"], m["kv_lora_rank"]
    dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    attn = 2.0 * (d * ql + ql * h * (dn + dr) + d * (kl + dr) + kl * h * (dn + dv) + h * dv * d)
    f = m["moe_intermediate_size"]
    routed = m["num_experts_per_tok"] * m["experts_held"] / m["n_routed_experts"]
    moe = 2.0 * (d * m["n_routed_experts"] + 3 * d * f * (routed + m["n_shared_experts"]))
    dense = 2.0 * 3 * d * m["intermediate_size"]
    n_dense = m["first_k_dense_replace"]
    return m["num_hidden_layers"] * attn + n_dense * dense + (m["num_hidden_layers"] - n_dense) * moe


def head_flops(m: dict) -> float:
    return 2.0 * m["hidden_size"] * m["vocab_size"]


def prefill_flops(m: dict, b: int, s: int) -> float:
    """Model operations of a causal prefill of B x S tokens whose head runs
    on the last position only: the linear layers, the causal attention
    cores (:func:`attn_cores`) and the head."""
    return b * s * token_flops(m) + b * head_flops(m) + attn_cores(m, b, s)["flops"]
