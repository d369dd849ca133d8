"""The mla_moe family (DeepSeek-V3) at smoke size on the CPU: the port's
prefill and served decode against the plain reference, the counts against
the calls the smoke model makes, the attention readers on a synthetic
trace, a whole smoke run, and the bursty open loop of the chat-poisson mix.

The program runs in float32 here (its weights are the drawn bf16 values,
as the reference's are), so program and reference differ by the order of
float32 sums only: 1e-4 relative on the logits holds them, and a bf16
activation (errors of 1e-2) or the fp8 control fails it."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from hyca_bench.bridges import mla_moe as bridge
from hyca_bench.counts import mla_moe as counts
from hyca_bench.harness import cell, inputs, port, spec
from hyca_bench.harness.spec import BENCH_DIR
from hyca_bench.reference import mla_moe as ref
from hyca_bench.tests import smoke

DATA = Path(__file__).resolve().parent / "data_mla"
CFG = json.loads((DATA / "configs" / "deepseek-v3-smoke.json").read_text())
M = CFG["model"]
CPU = torch.device("cpu")
SEED = 2**31 + 99
TOL = 1e-4


def float32_cfg() -> dict:
    return dict(CFG, model=dict(M, dtype="float32"))


def rel_err(got, want) -> float:
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())


def weights():
    return inputs.float_weights(bridge, M, SEED, CPU)


def test_the_configuration_is_the_registry_s_share():
    from repro_torch.configs import get_config

    full = json.loads((BENCH_DIR / "configs" / "deepseek-v3-ep32.json").read_text())
    lm = bridge.lm_config(full)
    assert lm == get_config("deepseek-v3-ep32")
    m = full["model"]
    n = sum(int(np.prod(shape)) for part in bridge.parts(m) for _, shape, _ in bridge.part_leaves(m, part))
    assert n == lm.n_params() == 15_310_188_544
    assert (lm.moe.n_experts, lm.moe.n_held, lm.moe.top_k, lm.moe.n_group, lm.moe.topk_group) == (256, 8, 8, 8, 4)


def test_the_published_keys_agree_with_what_runs():
    """The file's top level gives the published config's keys as run, its
    ``reduced`` keys cut (``n_routed_experts`` counting the experts held);
    ``model`` gives the same values in the port's terms, with the router
    over all ``published`` experts."""
    full = json.loads((BENCH_DIR / "configs" / "deepseek-v3-ep32.json").read_text())
    m, pub = full["model"], full["published"]
    assert set(pub) == set(full["reduced"])
    assert (full["n_routed_experts"], m["experts_held"], m["n_routed_experts"]) == (8, 8, pub["n_routed_experts"])
    for key in set(m) & set(full):
        if key != "n_routed_experts":
            assert full[key] == m[key], key
    assert all(pub[k] > full[k] for k in full["reduced"])


def test_make_prefill_against_the_reference():
    """(d) The protected prefill (make_prefill over the server's fault view,
    capacity drops at S = 32) against ``reference.prefill_last``; the
    control is far outside the tolerance."""
    server, _ = port.build_server(float32_cfg(), SEED, CPU, 1, 16)
    tok = torch.randint(0, M["vocab_size"], (2, 32), generator=torch.Generator().manual_seed(1))
    with smoke.few_threads():
        got = port.prefill_step(server)(server.bundle.work, {"tokens": tok})[:, -1, :M["vocab_size"]].float()
        want = ref.prefill_last(M, weights(), [tok])[0]
        low = ref.prefill_last(M, weights(), [tok], quant="fp8")[0]
    assert rel_err(got, want) < TOL < rel_err(low, want)


def test_served_decode_through_the_latent_cache_against_the_reference():
    """(e) Two slots, three requests: each prompt fed a token a step, then
    its own tokens, through the latent cache (``c_kv``, ``k_rope``) with
    the absorbed decode; the third request reuses a slot after
    ``reset_fn``.  Every position's logits against the reference's full
    forward, teacher-forced on the served tokens."""
    server, faults = port.build_server(float32_cfg(), SEED, CPU, 2, 32)
    assert port.unrepaired_faults(server) == 0 and len(faults) == CFG["faults"]["n_faulty_pes"]
    assert set(server.cache["attn"][0]) == {"c_kv", "k_rope", "idx"}
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, M["vocab_size"], size=n).astype(np.int32) for n in (5, 9, 4)]
    news = (6, 3, 7)
    rids = [server.submit(p, n) for p, n in zip(prompts, news)]
    rows: dict[int, list[torch.Tensor]] = {r: [] for r in rids}
    done, resets = {}, []
    real_reset = server.bundle.reset_fn
    server.bundle.reset_fn = lambda cache, slot: resets.append(slot) or real_reset(cache, slot)
    with smoke.few_threads():
        while len(done) < 3:
            before = {s.index: s.request.rid for s in server.scheduler.slots if s.request is not None}
            completed = server.step()
            after = {s.index: s.request.rid for s in server.scheduler.slots if s.request is not None}
            done.update({c.rid: c for c in completed})
            # a slot's request in the step: admitted in it (after), or there before and done in it
            for i, rid in {**before, **after}.items():
                rows[rid].append(server.decode.logits[i, 0, :M["vocab_size"]].float().clone())
        assert len(resets) == 3  # every admission resets its slot, the third a used one
        seqs = [torch.from_numpy(np.concatenate([p, done[r].tokens[:-1]]).astype(np.int64))
                for p, r in zip(prompts, rids)]
        want = ref.teacher_forced(M, weights(), seqs, [0, 0, 0])
        low = ref.teacher_forced(M, weights(), seqs, [0, 0, 0], quant="fp8")
    # the served cache is bf16 whatever the model's dtype (the server's, as the reference package's): each
    # position's logits carry its rounding, about 2e-3, and a pick that the rounding moves across a routing
    # tie moves a position by up to 0.2 and the ones after it by a few 1e-2; the control's are 0.2-0.5
    got = torch.cat([torch.stack(rows[r]) for r in rids])
    w, lo = torch.cat(want), torch.cat(low)
    err, err_low = ((got - w).norm(dim=-1) / w.norm(dim=-1)), ((lo - w).norm(dim=-1) / w.norm(dim=-1))
    assert got.shape == w.shape
    assert err.median() < 0.005 and err.mean() < 0.03 < 0.1 < err_low.median()


def _recorded_calls(monkeypatch, run) -> list[tuple[str, float]]:
    """(kernel, operations) of each protected call ``run`` makes."""
    from repro_torch.core import ftcontext

    seen = []

    def wrap(name, fn):
        def rec(x, w, *args, **kwargs):
            m = x.shape[-2] * (x.shape[0] if x.dim() == 3 else 1)
            n = w.shape[-1]
            n = M["vocab_size"] if n == bridge.padded_vocab(M) else n  # the counts' head: the published vocab
            seen.append((name, 2.0 * m * x.shape[-1] * n))
            return fn(x, w, *args, **kwargs)
        return rec

    monkeypatch.setattr(ftcontext, "ft_matmul", wrap("ft_matmul", ftcontext.ft_matmul))
    monkeypatch.setattr(ftcontext, "ft_matmul_batched", wrap("ft_matmul_batched", ftcontext.ft_matmul_batched))
    run()
    return sorted(seen)


@pytest.mark.parametrize("b,s", [(2, 32), (1, 64)])
def test_counts_are_the_prefill_s_calls(monkeypatch, b, s):
    """(f) Every protected call of a smoke prefill, the router in f32 at
    each dispatch group's rows and the held experts at their capacity
    rows, as ``counts.calls`` lists them, and the pass's attention cores."""
    m = dict(M, dispatch_group=32)   # S = 64: two dispatch groups a row
    cfg = dict(CFG, model=m)
    server, _ = port.build_server(cfg, SEED, CPU, 1, 16)
    tok = torch.zeros((b, s), dtype=torch.long)
    got = _recorded_calls(monkeypatch, lambda: port.prefill_step(server)(server.bundle.work, {"tokens": tok}))
    listed = counts.calls(m, b * s, b)
    want = sorted((c["kernel"], c["flops"]) for c in listed if c["kernel"] != "mla_attn")
    assert got == want
    assert [(c["b"], c["s"]) for c in listed if c["kernel"] == "mla_attn"] == [(b, s)]
    d, e = m["hidden_size"], m["n_routed_experts"]
    router = [c for c in listed if c["bytes"] == (b * 32 * (d + e) + d * e) * 4]   # float32 operands
    assert len(router) == (s // 32) * (m["num_hidden_layers"] - m["first_k_dense_replace"])
    assert router[0]["flops"] == 2.0 * b * 32 * d * e


def test_attention_work_and_model_flops():
    b, s = 2, 16
    h, dn, dr, dv = 8, 16, 8, 16
    core = counts.attn_cores(M, b, s)
    assert core["flops"] == 4 * b * h * s * (s + 1) / 2 * 2 * (dn + dr + dv)
    assert core["bytes"] == 4 * (b * s * h * (dn + dr) + b * s * (16 + dr) + b * s * h * dv) * 2
    assert counts.mla_attn_bound_s(M, b, s) == counts.bound_s(core)
    flops = counts.prefill_flops(M, b, s)
    assert flops == b * s * counts.token_flops(M) + b * counts.head_flops(M) + core["flops"]
    # the routed experts count the picks expected on the share: 4 x 8 / 32 a token
    d, f = 64, 32
    lin = 4 * 2 * (d * 32 + 32 * h * (dn + dr) + d * (16 + dr) + 16 * h * (dn + dv) + h * dv * d)
    moe = 2 * 2 * (d * 32 + 3 * d * f * (4 * 8 / 32 + 1))
    dense = 2 * 2 * 3 * d * 128
    assert counts.token_flops(M) == pytest.approx(lin + moe + dense)


# --------------------------------------------------------------------------- #
# (h) the attention readers on a synthetic trace
# --------------------------------------------------------------------------- #
def _rec(device, layers=2):
    busy = sum(d for _, _, d, _ in device)
    m = dict(M, num_hidden_layers=layers)
    return {"profile": {"device": device, "busy_s": busy / 1e6, "window_s": 1.0},
            "model": m, "counts": counts, "profiled_calls": counts.calls(m, 64, 1)}


def test_attention_readers_on_a_synthetic_trace():
    share, roof = spec.reader("mla_attn_share.prefill"), spec.reader("mla_attn_roofline.prefill")
    dev = [("ft_strip_mma_kernel<1>", 0.0, 100.0, (1, 1, 1)),
           ("span_begin_attn_mla", 100.0, 2.0, (1, 1, 1)),
           ("gemm_a", 102.0, 50.0, ()), ("softmax", 160.0, 30.0, ()),
           ("span_end_attn_mla", 190.0, 2.0, (1, 1, 1)),
           ("ft_strip_mma_kernel<1>", 192.0, 100.0, (1, 1, 1)),
           ("span_begin_attn_mla", 292.0, 2.0, (1, 1, 1)),
           ("gemm_b", 290.0, 40.0, ()),          # overlaps the begin mark: counted from its end on
           ("span_end_attn_mla", 340.0, 2.0, (1, 1, 1))]
    rec = _rec(dev)
    inside = 50.0 + 30.0 + (330.0 - 294.0)
    busy = rec["profile"]["busy_s"]
    assert share(rec, "mla_attn_share.prefill") == pytest.approx(100 * inside / 1e6 / busy)
    bound = counts.mla_attn_bound_s(dict(M, num_hidden_layers=2), 1, 64)
    assert roof(rec, "mla_attn_roofline.prefill") == pytest.approx(100 * bound / (inside / 1e6))


@pytest.mark.parametrize("drop", [1, 3])
def test_attention_readers_refuse_unpaired_marks(drop):
    dev = [("span_begin_attn_mla", 0.0, 1.0, ()), ("k", 1.0, 5.0, ()), ("span_end_attn_mla", 6.0, 1.0, ()),
           ("span_begin_attn_mla", 8.0, 1.0, ()), ("k", 9.0, 5.0, ()), ("span_end_attn_mla", 14.0, 1.0, ())]
    del dev[drop]
    rec = _rec(dev)
    if drop == 1:   # a kernel lost: still paired, read
        assert spec.reader("mla_attn_share.prefill")(rec, "x") is not None
    else:           # a mark lost
        assert spec.reader("mla_attn_share.prefill")(rec, "x") is None
        assert spec.reader("mla_attn_roofline.prefill")(rec, "x") is None


def test_attention_readers_find_nothing_without_marks():
    rec = _rec([("k", 0.0, 5.0, ())])
    assert spec.reader("mla_attn_share.prefill")(rec, "x") is None
    assert spec.reader("mla_attn_roofline.prefill")(rec, "x") is None
    rec3 = _rec([("span_begin_attn_mla", 0.0, 1.0, ()), ("span_end_attn_mla", 6.0, 1.0, ())], layers=2)
    assert spec.reader("mla_attn_share.prefill")(rec3, "x") is None  # one pair for two layers: a pair lost
    assert spec.reader("mla_attn_share.prefill")({"profile": None}, "x") is None


# --------------------------------------------------------------------------- #
# a whole smoke run of the cell, and the control
# --------------------------------------------------------------------------- #
def smoke_spec() -> spec.Spec:
    return spec.Spec(DATA / "BENCHMARK.json", DATA)


def test_a_smoke_run_of_the_prefill_long_cell():
    with smoke.few_threads():
        out = cell.run(smoke_spec(), "deepseek-v3.prefill-long", SEED, 1.0, True, CPU)
    assert out["correct"] and out["checks"]["unrepaired_faults"]["value"] == 0
    assert "mfu.prefill" in out["metrics"] and "mla_attn_share.prefill" not in out["metrics"]  # no marks on a CPU
    found, calls = out["samples"]["ft_launches"]["ft_matmul"]
    assert calls > 0 and found == 0


def test_the_control_is_not_correct():
    from hyca_bench import control

    with smoke.few_threads():
        r = control.readings(smoke_spec(), "deepseek-v3.prefill-long", SEED, 0.5, CPU)
    assert r["program"]["correct"] and not r["control_fp8"]["correct"]
    assert r["program"]["rms_err_mean"] * 5 < r["control_fp8"]["rms_err_mean"]


# --------------------------------------------------------------------------- #
# the bursty open loop
# --------------------------------------------------------------------------- #
MIX = json.loads((BENCH_DIR / "traffic" / "chat-poisson.json").read_text())


def test_gamma_arrivals_are_one_schedule_with_bursts():
    mod = spec.module("arrivals", MIX["arrival"]["process"])
    a, b = mod.Arrivals(MIX["arrival"], 1), mod.Arrivals(MIX["arrival"], 2**31 + 12345)
    ta, tb = a.due(100.0, 0), b.due(100.0, 0)
    assert ta == tb == [100.0]               # the first request at the window's start
    ta += a.due(100.0 + 2000.0, 3)
    tb += b.due(100.0 + 2000.0, 0)
    assert ta == tb                          # the schedule does not depend on the seed or completions
    gaps = np.diff(ta)
    rate = MIX["arrival"]["rate"]
    assert abs(len(ta) / 2000.0 / rate - 1) < 0.1
    assert 1.6 < gaps.std() / gaps.mean() < 2.4  # CV 2: shape 0.25
    assert a.due(100.0 + 2000.0, 0) == []


def test_the_chat_poisson_mix_keeps_the_chat_mix_s_sizes():
    chat = json.loads((BENCH_DIR / "traffic" / "chat.json").read_text())
    assert {k: v for k, v in MIX.items() if k not in ("arrival", "why")} == {
        k: v for k, v in chat.items() if k not in ("arrival", "why")}
    limits = json.loads((BENCH_DIR / "limits" / "granite-moe-3b.chat-poisson.json").read_text())
    assert limits == json.loads((BENCH_DIR / "limits" / "granite-moe-3b.chat.json").read_text())


def test_the_chat_driver_runs_an_open_loop():
    """The smoke chat mix under the gamma process: requests sent on
    schedule, answered correct."""
    d = json.loads((Path(smoke.DATA) / "traffic" / "chat-smoke.json").read_text())
    mix = dict(d, arrival={"process": "gamma", "rate": 8.0, "shape": 0.25, "schedule_seed": 5})
    s = smoke.spec()
    s.traffic = lambda name: mix
    with smoke.few_threads():
        out = cell.run(s, "granite.chat", SEED, 1.5, False, CPU)
    assert out["correct"] and out["attempted"] >= 5 and out["failed"] == 0
