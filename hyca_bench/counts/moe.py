"""The benchmark's own count of the work of the moe family's passes, from
the configuration's published sizes alone, whatever implements them.

A protected linear call (``ft_matmul``) of M rows, K in, N out counts
2 M K N operations and reads x and w once and writes the output once, in
bf16.  The experts' calls (``ft_matmul_batched``) count only the rows
actually routed, T x top_k over T tokens, and read the weights of each
expert some token reaches: with T tokens routed uniformly,
E (1 - (1 - top_k / E) ** T) of the E published experts; the port's
router-masked padding experts are never counted.  The router counts the
published E outputs.  Attention over the cache is no protected call; it
counts in the model's operations (``pass_flops``): 4 ctx x heads x
head_dim a layer for a token that attends over ctx positions.
"""
from __future__ import annotations

import json
from pathlib import Path

BYTES = 2  # bf16 operands and outputs

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def _call(kernel: str, m: int, k: int, n: int, *, w_bytes: float | None = None) -> dict:
    w = k * n * BYTES if w_bytes is None else w_bytes
    return {"kernel": kernel, "flops": 2.0 * m * k * n, "bytes": float((m * k + m * n) * BYTES + w)}


def experts_reached(m: dict, tokens: int) -> float:
    e, k = m["num_local_experts"], m["num_experts_per_tok"]
    return e * (1.0 - (1.0 - k / e) ** tokens)


def _layers(m: dict) -> list[str]:
    n_dense = m["first_k_dense_replace"]
    return ["dense"] * n_dense + ["moe"] * (m["num_hidden_layers"] - n_dense)


def calls(m: dict, tokens: int, head_rows: int) -> list[dict]:
    """The protected linear calls of one pass over ``tokens`` token rows
    (a decode step: the slots; a prefill: B x S) with the head over
    ``head_rows`` rows, each as {kernel, flops, bytes}."""
    d, hd = m["hidden_size"], m["head_dim"]
    hq, hk = m["num_attention_heads"] * hd, m["num_key_value_heads"] * hd
    t = tokens
    out = []
    for kind in _layers(m):
        out += [_call("ft_matmul", t, d, hq), _call("ft_matmul", t, d, hk), _call("ft_matmul", t, d, hk),
                _call("ft_matmul", t, hq, d)]
        if kind == "dense":
            f = m["dense_intermediate_size"]
            out += [_call("ft_matmul", t, d, f), _call("ft_matmul", t, d, f), _call("ft_matmul", t, f, d)]
            continue
        e, k, f = m["num_local_experts"], m["num_experts_per_tok"], m["intermediate_size"]
        out.append(_call("ft_matmul", t, d, e))
        rows, reached = t * k, experts_reached(m, t)
        out += [_call("ft_matmul_batched", rows, d, f, w_bytes=reached * d * f * BYTES),
                _call("ft_matmul_batched", rows, d, f, w_bytes=reached * d * f * BYTES),
                _call("ft_matmul_batched", rows, f, d, w_bytes=reached * f * d * BYTES)]
        if m["n_shared_experts"]:
            s = m["shared_intermediate_size"]
            out += [_call("ft_matmul", t, d, s), _call("ft_matmul", t, d, s), _call("ft_matmul", t, s, d)]
    out.append(_call("ft_matmul", head_rows, d, m["vocab_size"]))
    return out


def bound_s(call: dict) -> float:
    """The least time the chip could take for ``call``: its operations at
    the bf16 peak or its bytes at the HBM peak, whichever is longer."""
    return max(call["flops"] / PEAKS["bf16_flops_per_s"], call["bytes"] / PEAKS["hbm_bytes_per_s"])


def token_flops(m: dict) -> float:
    """Operations of one token's linear layers, the head left out."""
    return sum(c["flops"] for c in calls(m, 1, 0))


def head_flops(m: dict) -> float:
    return 2.0 * m["hidden_size"] * m["vocab_size"]


def attn_flops_per_ctx(m: dict) -> float:
    """Attention's operations per attended position of one token, over
    every layer: QK and PV, 2 x 2 x heads x head_dim each layer."""
    return 4.0 * m["num_attention_heads"] * m["head_dim"] * m["num_hidden_layers"]


def decode_flops(m: dict, tokens: int, ctx_sum: int) -> float:
    """Model operations of ``tokens`` decoded (or prompt-fed) token rows,
    each with the head, attending over ``ctx_sum`` positions in all."""
    return tokens * (token_flops(m) + head_flops(m)) + attn_flops_per_ctx(m) * ctx_sum


def prefill_flops(m: dict, b: int, s: int) -> float:
    """Model operations of a causal prefill of B x S tokens whose head runs
    on the last position only."""
    return b * s * token_flops(m) + b * head_flops(m) + attn_flops_per_ctx(m) * b * s * (s + 1) / 2
