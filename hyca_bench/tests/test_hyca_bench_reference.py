"""The plain reference against itself (routing against a dense loop,
capacity against a loop over picks) and against the port's float32
forward at smoke size."""
import dataclasses
import json

import pytest
import torch
import torch.nn.functional as F

from hyca_bench.bridges import moe as bridge
from hyca_bench.harness import inputs
from hyca_bench.harness.spec import BENCH_DIR
from hyca_bench.reference import moe as ref

CFGS = {n: json.loads((BENCH_DIR / "tests" / "data" / "configs" / f"{n}.json").read_text())
        for n in ("granite-smoke", "deepseek-smoke")}


def weights(m, seed=5):
    drawn = inputs.draw_all(bridge, m, seed, "cpu", torch.float32)
    return drawn, (lambda part: {k: v.float() for k, v in drawn[part].items()})


@pytest.mark.parametrize("name", sorted(CFGS))
def test_token_routing_against_a_dense_loop(name):
    m = CFGS[name]["model"]
    _, w = weights(m)
    lw = w("moe.0")
    x = torch.randn(1, 7, m["hidden_size"], generator=torch.Generator().manual_seed(1))
    got = ref.moe(x, lw, m, None, "token")[0]
    e, k = m["num_local_experts"], m["num_experts_per_tok"]
    want = torch.zeros_like(got)
    for t in range(7):
        g = torch.softmax(x[0, t] @ lw["router"][:, :e], -1)
        top = sorted(range(e), key=lambda i: (-g[i].item(), i))[:k]
        tot = sum(g[i] for i in top) if m["norm_topk_prob"] else 1.0
        for i in top:
            h = F.silu(x[0, t] @ lw["gate"][i]) * (x[0, t] @ lw["up"][i])
            want[t] += g[i] / tot * (h @ lw["down"][i])
        if m["n_shared_experts"]:
            h = F.silu(x[0, t] @ lw["shared.gate"]) * (x[0, t] @ lw["shared.up"])
            want[t] += h @ lw["shared.down"]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_capacity_against_a_loop_over_picks():
    topi = torch.stack([torch.randperm(5, generator=torch.Generator().manual_seed(i))[:3] for i in range(40)])
    keep = ref.capacity_keep(topi, 5, 13)
    load = [0] * 5
    want = torch.zeros(40, 3, dtype=torch.bool)
    for j in range(3):          # every token's j-th pick before any (j+1)-th
        for t in range(40):
            e = int(topi[t, j])
            want[t, j] = load[e] < 13
            load[e] += 1
    assert torch.equal(keep, want) and not keep.all()


@pytest.mark.parametrize("name", sorted(CFGS))
def test_reference_is_the_ports_float32_function(name):
    """In float32 the port's forward (capacity routing, last position) and
    its per-token routing agree with the reference to rounding."""
    from repro_torch.models.lm import forward

    cfg = CFGS[name]
    m = cfg["model"]
    lm = dataclasses.replace(bridge.lm_config(cfg), dtype=torch.float32)
    drawn, w = weights(m)
    params = bridge.program_params(m, drawn)
    tok = torch.randint(0, m["vocab_size"], (2, 32), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        last, _ = forward(params, lm, {"tokens": tok}, last_only=True)
        per_token, _ = forward(params, dataclasses.replace(lm, moe=dataclasses.replace(lm.moe, group_size=1)),
                               {"tokens": tok})
    v = m["vocab_size"]
    torch.testing.assert_close(last[:, 0, :v], ref.prefill_last(m, w, [tok])[0], rtol=1e-5, atol=1e-5)
    for i, r in enumerate(ref.teacher_forced(m, w, [tok[0], tok[1]], [0, 0])):
        torch.testing.assert_close(per_token[i, :, :v], r, rtol=1e-5, atol=1e-5)


def test_fp8_control_is_coarser():
    m = CFGS["granite-smoke"]["model"]
    _, w = weights(m)
    tok = torch.randint(0, m["vocab_size"], (2, 16), generator=torch.Generator().manual_seed(3))
    exact = ref.prefill_last(m, w, [tok])[0]
    low = ref.prefill_last(m, w, [tok], quant="fp8")[0]
    err = ((low - exact).abs().max(-1).values / exact.abs().max(-1).values).max()
    assert 1e-3 < err < 1.0
