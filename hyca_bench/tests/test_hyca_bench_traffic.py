"""The inputs drawn from the seed: traffic, weights, fault map."""
import json

import numpy as np
import pytest
import torch

from hyca_bench.bridges import moe as bridge
from hyca_bench.harness import inputs
from hyca_bench.harness.spec import BENCH_DIR

CHAT = json.loads((BENCH_DIR / "traffic" / "chat.json").read_text())
PREFILL = json.loads((BENCH_DIR / "traffic" / "prefill.json").read_text())
BIG = 2**31 + 2**30 + 12345  # seeds run past 32 signed bits


@pytest.mark.parametrize("seed", [0, BIG])
def test_chat_is_deterministic_and_fits_the_cache(seed):
    a, b = inputs.ChatTraffic(CHAT, seed, 49155), inputs.ChatTraffic(CHAT, seed, 49155)
    for k in range(70):
        (pa, oa), (pb, ob) = a.request(k), b.request(k)
        assert oa == ob and np.array_equal(pa, pb)
        assert len(pa) + oa <= CHAT["smax"] and pa.min() >= 0 and pa.max() < 49155
        assert CHAT["prompt"]["min"] <= len(pa) <= CHAT["prompt"]["max"]
        assert CHAT["output"]["min"] <= oa <= CHAT["output"]["max"]


def test_every_seed_sends_the_same_sizes_in_the_same_order():
    n = CHAT["levels"]
    traffic = [inputs.ChatTraffic(CHAT, s, 100) for s in (1, 2, BIG)]
    sizes = [[(len(p), o) for p, o in (t.request(k) for k in range(3 * n))] for t in traffic]
    assert sizes[0] == sizes[1] == sizes[2] and sizes[0][:n] == sizes[0][n:2 * n]
    assert len(set(sizes[0][:n])) == n
    assert not np.array_equal(traffic[0].request(5)[0], traffic[1].request(5)[0])
    mean_prompt = np.mean([p for p, _ in sizes[0][:n]])
    assert 150 < mean_prompt < 180  # lognormal median 128, sigma 0.7: mean 164


@pytest.mark.parametrize("seed", [3, BIG])
def test_prefill_batches(seed):
    t = inputs.PrefillTraffic(PREFILL, seed, 102400)
    shapes = [t.shape(j) for j in range(9)]
    for blk in range(3):
        assert sorted(s for _, s in shapes[3 * blk:3 * blk + 3]) == sorted(PREFILL["seq_lens"])
    for j, (b, s) in enumerate(shapes):
        assert b * s == PREFILL["tokens_per_batch"]
        x = t.batch(j)
        assert x.shape == (b, s) and np.array_equal(x, inputs.PrefillTraffic(PREFILL, seed, 102400).batch(j))
        assert x.max() < 102400


def test_weights_redraw_identically_and_keep_their_scales():
    m = json.loads((BENCH_DIR / "tests" / "data" / "configs" / "deepseek-smoke.json").read_text())["model"]
    leaves = bridge.part_leaves(m, "moe.1")
    a = inputs.draw_part(leaves, BIG, "moe.1", "cpu")
    b = inputs.draw_part(leaves, BIG, "moe.1", "cpu")
    c = inputs.draw_part(leaves, BIG + 1, "moe.1", "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a) and not torch.equal(a["wq"], c["wq"])
    assert torch.equal(a["ln1"], torch.ones_like(a["ln1"]))
    assert abs(a["gate"].float().std().item() - m["hidden_size"] ** -0.5) < 0.01
    assert all(t.dtype == torch.bfloat16 and t.data_ptr() % 16 == 0 for t in a.values())


def test_fault_map():
    f = inputs.fault_map(BIG, 32, 32, 16)
    assert f == inputs.fault_map(BIG, 32, 32, 16) and len({(r, c) for r, c, _, _ in f}) == 16
    assert all(0 <= r < 32 and 0 <= c < 32 and 0 <= b < 32 and v in (0, 1) for r, c, b, v in f)
