"""The benchmark's frozen counts at smoke size, against sums by hand."""
import json

import pytest

from hyca_bench.counts import moe as counts
from hyca_bench.harness.spec import BENCH_DIR

G = json.loads((BENCH_DIR / "tests" / "data" / "configs" / "granite-smoke.json").read_text())["model"]
D = json.loads((BENCH_DIR / "tests" / "data" / "configs" / "deepseek-smoke.json").read_text())["model"]


def test_granite_smoke_decode_step():
    # d 64, 4 heads of 16 (q 64, kv 32), 2 layers, 40 experts top-8 of width 32, vocab 500; 4 slots
    c = counts.calls(G, 4, 4)
    assert [x["kernel"] for x in c].count("ft_matmul") == 2 * 5 + 1
    assert [x["kernel"] for x in c].count("ft_matmul_batched") == 2 * 3
    attn = 2 * 4 * 64 * 64 + 2 * (2 * 4 * 64 * 32) + 2 * 4 * 64 * 64
    router = 2 * 4 * 64 * 40
    experts = 3 * 2 * (4 * 8) * 64 * 32
    head = 2 * 4 * 64 * 500
    assert sum(x["flops"] for x in c) == 2 * (attn + router + experts) + head
    reached = 40 * (1 - (1 - 8 / 40) ** 4)
    gate = [x for x in c if x["kernel"] == "ft_matmul_batched"][0]
    assert gate["bytes"] == pytest.approx(32 * 64 * 2 + 32 * 32 * 2 + reached * 64 * 32 * 2)
    wq = c[0]
    assert wq["bytes"] == (4 * 64 + 4 * 64 + 64 * 64) * 2
    # 1 ms at 4 slots is bytes-bound: bytes / 3.35 TB/s
    assert counts.bound_s(wq) == pytest.approx(wq["bytes"] / 3.35e12)


def test_deepseek_smoke_prefill_and_model_flops():
    # 3 layers: 1 dense (d_ff 128), 2 MoE (8 experts top-2 of 32, 2 shared of width 64); vocab 512, untied
    b, s = 2, 16
    t = b * s
    attn = 4 * (2 * t * 64 * 64)
    dense = 3 * 2 * t * 64 * 128
    moe = 2 * t * 64 * 8 + 3 * 2 * (t * 2) * 64 * 32 + 3 * 2 * t * 64 * 64
    head = 2 * b * 64 * 512
    c = counts.calls(D, t, b)
    assert sum(x["flops"] for x in c) == 3 * attn + dense + 2 * moe + head
    per_token = (3 * attn + dense + 2 * moe) / t
    assert counts.token_flops(D) == per_token
    causal = 4 * 4 * 16 * 3 * b * s * (s + 1) / 2
    assert counts.prefill_flops(D, b, s) == pytest.approx(t * per_token + head + causal)
    assert counts.decode_flops(D, 3, 40) == pytest.approx(3 * (per_token + 2 * 64 * 512) + 4 * 4 * 16 * 3 * 40)


def test_experts_reached_counts_no_padding_expert():
    assert counts.experts_reached(G, 10**6) == pytest.approx(G["num_local_experts"])
    assert G["experts_padded_to"] > G["num_local_experts"]
