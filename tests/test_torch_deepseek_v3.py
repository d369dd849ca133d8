"""DeepSeek-V3's mechanisms in the port (a port-only id: the JAX package
has no such model), at CPU size: YaRN RoPE and its interleaved pairs, the
group-limited sigmoid router, the expert share, the latent cache's decode,
the ``attn.mla`` span and the router counters.

Tolerances: float32 throughout; where two computations differ only in the
order of float32 sums, 1e-5 relative (a bf16 rounding of any operand moves
them by 1e-3 or more); where they are the same operations, bit for bit.
"""
import dataclasses
import math

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import moe as TM
from repro_torch.models.attention import mla_forward, mla_init
from repro_torch.models.layers import YarnScaling, apply_rope
from repro_torch.models.lm import cast_params, decode_step, forward, init_cache, init_params
from repro_torch.obs import router as router_tally
from repro_torch.obs import spans

V3 = "deepseek-v3"


def smoke(dtype=torch.float32, **moe):
    cfg = get_smoke_config(V3)
    return dataclasses.replace(cfg, dtype=dtype, moe=dataclasses.replace(cfg.moe, **moe))


# --------------------------------------------------------------------------- #
# (a) YaRN and the interleaved pairs
# --------------------------------------------------------------------------- #
def hf_yarn(dim, base, factor, beta_fast, beta_slow, orig, mscale, mscale_all_dim):
    """HF ``DeepseekV3YarnRotaryEmbedding`` and ``DeepseekV3Attention``'s
    softmax scale, transcribed line by line."""
    def find_dim(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))) / (2 * math.log(base))

    low = max(math.floor(find_dim(beta_fast)), 0)
    high = min(math.ceil(find_dim(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    freq_inter = 1.0 / (factor * base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    inv_freq_mask = 1.0 - ramp
    inv_freq = freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask

    def get_mscale(scale, m):
        return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0

    return inv_freq, get_mscale(factor, mscale) / get_mscale(factor, mscale_all_dim), get_mscale(factor, mscale_all_dim)


@pytest.mark.parametrize("orig,theta", [(4096, 10000.0), (64, 10000.0), (16, 500.0)])
def test_yarn_frequencies_and_mscale_are_hf_s(orig, theta):
    y = YarnScaling(factor=40.0, beta_fast=32.0, beta_slow=1.0, mscale=1.0, mscale_all_dim=1.0,
                    original_max_position_embeddings=orig)
    inv, cos_scale, all_dim = hf_yarn(64, theta, 40.0, 32.0, 1.0, orig, 1.0, 1.0)
    assert torch.equal(y.inv_freq(64, theta, device="cpu"), inv)
    assert y.cos_sin_scale() == cos_scale == 1.0
    assert y.softmax_scale_factor() == all_dim ** 2 and all_dim == 0.1 * math.log(40) + 1  # 1.3689
    mla = get_config(V3).mla
    assert mla.softmax_scale == pytest.approx(192 ** -0.5 * (0.1 * math.log(40) + 1) ** 2, rel=1e-15)
    # the ramp blends: the fastest dims keep the base frequencies, the slowest are factor times slower
    base = 1.0 / theta ** (torch.arange(0, 64, 2, dtype=torch.float32) / 64)
    assert inv[0] == base[0] and torch.allclose(inv[-1], base[-1] / 40)


def test_yarn_cos_sin_scale_when_the_mscales_differ():
    y = YarnScaling(factor=8.0, mscale=2.0, mscale_all_dim=1.0)
    _, cos_scale, _ = hf_yarn(8, 10000.0, 8.0, 32.0, 1.0, 4096, 2.0, 1.0)
    x = torch.randn(1, 5, 2, 8, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(5)[None]
    scaled = apply_rope(x, pos, scaling=y)
    unit = apply_rope(x, pos, scaling=dataclasses.replace(y, mscale=1.0))
    assert cos_scale != 1.0 and torch.allclose(scaled, unit * cos_scale, rtol=1e-6, atol=1e-7)


def test_interleaved_rope_is_contiguous_rope_under_the_weight_permutation():
    """The interleaved pairs (x[2i], x[2i+1]) moved to halves: the same MLA
    with the rope columns of wq_b and wkv_a permuted to halves and
    contiguous RoPE gives the same output."""
    cfg = get_smoke_config(V3).mla
    p = mla_init(torch.Generator().manual_seed(3), cfg, device="cpu")
    dr, dn, h, kl = cfg.d_rope, cfg.d_nope, cfg.n_heads, cfg.kv_lora
    perm = torch.cat([torch.arange(0, dr, 2), torch.arange(1, dr, 2)])
    q = p["wq_b"].view(cfg.q_lora, h, dn + dr).clone()
    q[..., dn:] = q[..., dn:][..., perm]
    kv = p["wkv_a"].clone()
    kv[:, kl:] = kv[:, kl:][:, perm]
    halves = dict(p, wq_b=q.reshape(cfg.q_lora, -1), wkv_a=kv)
    x = torch.randn(2, 32, cfg.d_model, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        inter = mla_forward(x, p, cfg)
        contig = mla_forward(x, halves, dataclasses.replace(cfg, rope_interleave=False))
        plain = mla_forward(x, p, dataclasses.replace(cfg, rope_interleave=False))
    torch.testing.assert_close(inter, contig, rtol=1e-5, atol=1e-6)
    assert (inter - plain).abs().max() > 100 * (inter - contig).abs().max()  # the layout matters


def test_the_default_rope_is_untouched():
    x = torch.randn(2, 7, 3, 16, generator=torch.Generator().manual_seed(1))
    pos = torch.arange(7).expand(2, 7)
    freqs = 1.0 / 10000.0 ** (torch.arange(0, 16, 2, dtype=torch.float32) / 16)
    ang = pos[..., None, None].float() * freqs
    x1, x2 = x.chunk(2, -1)
    want = torch.cat([x1 * ang.cos() - x2 * ang.sin(), x2 * ang.cos() + x1 * ang.sin()], -1)
    assert torch.equal(apply_rope(x, pos), want)


# --------------------------------------------------------------------------- #
# (b) the router
# --------------------------------------------------------------------------- #
def router_loop(logits, bias, cfg):
    """DeepSeek-V3's gate a token at a time, in plain Python."""
    e, per = cfg.n_experts, cfg.n_experts // cfg.n_group
    ids, wts = [], []
    for row in logits.reshape(-1, e):
        s = [1 / (1 + math.exp(-float(v))) for v in row]
        choice = [s[i] + float(bias[i]) for i in range(e)]
        gscore = [sum(sorted(choice[g * per:(g + 1) * per], reverse=True)[:2]) for g in range(cfg.n_group)]
        groups = sorted(range(cfg.n_group), key=lambda g: (-gscore[g], g))[:cfg.topk_group]
        allowed = [i for g in groups for i in range(g * per, (g + 1) * per)]
        picks = sorted(allowed, key=lambda i: (-choice[i], i))[:cfg.top_k]
        tot = sum(s[i] for i in picks)
        ids.append(picks)
        wts.append([s[i] / tot * cfg.routed_scale for i in picks])
    return torch.tensor(ids), torch.tensor(wts, dtype=torch.float64)


def test_router_against_a_loop_over_tokens():
    cfg = smoke().moe
    g = torch.Generator().manual_seed(7)
    logits = torch.randn(3, 20, cfg.n_experts, generator=g)
    bias = torch.randn(cfg.n_experts, generator=g) * 0.3
    # a tie: two equal choices in a kept group; and a token whose scores are all equal (the bias alone chooses)
    logits[0, 0, 9] = logits[0, 0, 10] = 4.0
    bias[9] = bias[10] = 0.0
    logits[0, 1] = 0.0
    topv, topi, s = TM._sigmoid_topk(logits, bias, cfg)
    want_i, want_v = router_loop(logits, bias, cfg)
    assert torch.equal(topi.reshape(-1, cfg.top_k), want_i)
    torch.testing.assert_close(topv.reshape(-1, cfg.top_k).double(), want_v, rtol=1e-6, atol=1e-7)
    assert topi[0, 0].tolist().index(9) < topi[0, 0].tolist().index(10)  # ties to the lower index
    torch.testing.assert_close(topv.sum(-1), torch.full((3, 20), cfg.routed_scale), rtol=1e-6, atol=1e-6)
    assert torch.equal(s, torch.sigmoid(logits))


def test_the_bias_selects_and_does_not_weigh():
    cfg = dataclasses.replace(smoke().moe, n_group=1, topk_group=1, top_k=2)
    logits = torch.tensor([[[3.0, 2.0, 1.0] + [-5.0] * (cfg.n_experts - 3)]])
    bias = torch.zeros(cfg.n_experts)
    bias[2] = 1.5  # expert 2 overtakes 0 and 1 in the choice, keeps its own score as weight
    topv, topi, _ = TM._sigmoid_topk(logits, bias, cfg)
    assert topi[0, 0].tolist() == [2, 0]
    s = torch.sigmoid(torch.tensor([1.0, 3.0]))
    torch.testing.assert_close(topv[0, 0], s / s.sum() * cfg.routed_scale)


def test_groups_exclude_the_other_experts():
    cfg = smoke().moe
    per = cfg.n_experts // cfg.n_group
    logits = torch.full((1, 1, cfg.n_experts), -2.0)
    logits[0, 0, 0] = 9.0                          # group 0's best is the best expert of all ...
    logits[0, 0, per:3 * per] = 1.0                # ... but groups 1 and 2 score higher on their top-2 sums
    logits[0, 0, 3 * per:] = 0.5
    _, topi, _ = TM._sigmoid_topk(logits, torch.zeros(cfg.n_experts), cfg)
    assert all(per <= i < 3 * per for i in topi.flatten().tolist())


def test_softmax_routing_is_the_default():
    cfg = get_config("deepseek-moe-16b").moe
    assert (cfg.scoring, cfg.experts_held, cfg.n_held) == ("softmax", 0, 64)
    p = TM.moe_init(torch.Generator().manual_seed(0), dataclasses.replace(cfg, d_model=8, d_expert=4), device="cpu")
    assert "bias" not in p


# --------------------------------------------------------------------------- #
# (c) the expert share
# --------------------------------------------------------------------------- #
def test_the_shares_sum_to_the_whole_layer_with_capacity_drops():
    """64 experts held 2 a share by 32 shares: the shares' outputs, the
    shared expert counted once, add up to the uncut layer's, capacity
    drops included (each share counts queues over all 64 experts)."""
    base = dataclasses.replace(smoke().moe, n_experts=64, n_group=8, topk_group=4, top_k=8, experts_held=0,
                               expert_offset=0, capacity_factor=1.0)
    whole = TM.moe_init(torch.Generator().manual_seed(11), base, device="cpu")
    x = torch.randn(2, 48, base.d_model, generator=torch.Generator().manual_seed(12))
    with torch.no_grad():
        want, _ = TM.moe_forward(x, whole, base)
        shared = TM._shared(x, whole)
        got = torch.zeros_like(want)
        router_tally.reset("cpu")
        for k in range(32):
            cfg = dataclasses.replace(base, experts_held=2, expert_offset=2 * k)
            part = dict(whole, **{n: whole[n][2 * k:2 * k + 2] for n in ("gate", "up", "down")})
            out, _ = TM.moe_forward(x, part, cfg)
            got += out - shared
        got += shared
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    counts = router_tally.totals("cpu")
    assert counts["picks"] == 32 * 2 * 48 * 8 and counts["held_picks"] == 2 * 48 * 8
    assert counts["held_dropped"] > 0  # capacity 1.0 x 8 x 48 / 64 = 6 picks an expert a row


def test_router_counters_count_picks_on_the_share():
    cfg = smoke().moe
    p = TM.moe_init(torch.Generator().manual_seed(2), cfg, device="cpu")
    x = torch.randn(2, 32, cfg.d_model, generator=torch.Generator().manual_seed(3))
    logits = x.reshape(-1, cfg.d_model) @ p["router"]
    _, topi, _ = TM._sigmoid_topk(logits[None], p["bias"], cfg)
    held = ((topi >= cfg.expert_offset) & (topi < cfg.expert_offset + cfg.experts_held)).sum()
    router_tally.reset("cpu")
    with torch.no_grad():
        TM.moe_forward(x, p, cfg)
    got = router_tally.totals("cpu")
    assert got["picks"] == 2 * 32 * cfg.top_k and got["held_picks"] == int(held)
    assert 0 <= got["held_dropped"] <= got["held_picks"]


# --------------------------------------------------------------------------- #
# the model: config, params, decode through the latent cache
# --------------------------------------------------------------------------- #
def test_port_only_ids_and_their_sizes():
    assert V3 not in ARCH_IDS and "deepseek-v3-ep32" not in ARCH_IDS and len(ARCH_IDS) == 10
    full, ep32 = get_config(V3), get_config("deepseek-v3-ep32")
    assert full.n_params() == 671_026_419_200 and full.n_active_params() == 37_552_297_472
    assert ep32.n_params() == 15_310_188_544
    assert (ep32.n_layers, ep32.first_k_dense, ep32.moe.n_held, ep32.moe.n_experts) == (23, 3, 8, 256)
    # a token sends 8 x 8 / 256 of its picks to the share, on average
    per_expert = 3 * 7168 * 2048
    assert ep32.n_active_params() == ep32.n_params() - round((8 - 8 * 8 / 256) * per_expert * 20)


def test_latent_cache_decode_is_the_forward():
    """Absorbed decode over the latent cache, a slot reset between two
    requests, against the full forward teacher-forced (per-token routing:
    a decode step's token is a dispatch group of its own)."""
    cfg = smoke(group_size=1)
    p = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    w = cast_params(p, torch.float32)
    tok = torch.randint(0, cfg.vocab, (2, 32), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        full, _ = forward(p, cfg, {"tokens": tok})
        cache = init_cache(cfg, 1, 40, torch.float32, device="cpu")
        assert set(cache["attn"][0]) == {"c_kv", "k_rope", "idx"}
        for b in range(2):
            for part in cache.values():
                for layer in part:
                    for t in layer.values():
                        t[0] = 0
            got = torch.cat([decode_step(w, cfg, cache, {"token": tok[b:b + 1, t:t + 1]})[0] for t in range(32)], 1)
            torch.testing.assert_close(got[0], full[b], rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------- #
# (g) the attn.mla span
# --------------------------------------------------------------------------- #
class _FakeLib:
    """The marks' library as ctypes gives it: a launcher per span."""

    def __init__(self):
        self.calls = []
        self.attn_mla_mark_launch = lambda end, stream: self.calls.append(end) or 0
        self.attn_mla_mark_launch.argtypes = None


@pytest.fixture
def fake_card(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(spans, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    return lib


def test_the_span_launches_no_mark_without_a_profiler(fake_card):
    ns, count = spans.totals()["attn.mla"]
    with spans.ATTN_MLA.on(torch.device("cuda")):
        pass
    assert fake_card.calls == [] and spans.totals()["attn.mla"][1] == count + 1
    assert spans.totals()["attn.mla"][0] >= ns


def test_the_span_marks_begin_and_end_while_a_profiler_records(fake_card, monkeypatch):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.ATTN_MLA.on(torch.device("cuda")):
            torch.zeros(2).add_(1)
        with spans.ATTN_MLA.on(torch.device("cpu")):
            pass
    assert fake_card.calls == [0, 1]
    assert sum(e.name == "attn.mla" for e in prof.events()) == 2
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with spans.ATTN_MLA.on(torch.device("cuda")):
            pass
    assert fake_card.calls == [0, 1]  # none under a graph's capture


def test_mla_forward_and_decode_run_inside_the_span():
    cfg = smoke()
    p = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    before = spans.totals()["attn.mla"][1]
    with torch.no_grad():
        forward(p, cfg, {"tokens": torch.zeros((1, 16), dtype=torch.long)})
        decode_step(p, cfg, init_cache(cfg, 1, 8, torch.float32, device="cpu"),
                    {"token": torch.zeros((1, 1), dtype=torch.long)})
    assert spans.totals()["attn.mla"][1] == before + 2 * cfg.n_layers


def test_the_server_serves_the_smoke_model_and_reports_its_router():
    from repro_torch.serving import FaultTolerantServer, ServerConfig

    srv = FaultTolerantServer(ServerConfig(arch=V3, n_slots=2, smax=32, mode="protected", device="cpu", seed=3))
    router_tally.reset("cpu")
    out = srv.run([{"step": 0, "prompt": [1, 2, 3], "max_new_tokens": 4},
                   {"step": 1, "prompt": [4, 5], "max_new_tokens": 3}])
    cfg = get_smoke_config(V3)
    steps = out["steps"] if "steps" in out else srv.step_idx
    assert out["router"]["picks"] == steps * 2 * cfg.moe.top_k * (cfg.n_layers - cfg.first_k_dense)
    assert 0 < out["router"]["held_picks"] < out["router"]["picks"] and out["router"]["held_dropped"] == 0
