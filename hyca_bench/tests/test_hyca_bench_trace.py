"""The reduction of a Chrome trace to the traced window's record, and the
readers that take device metrics from it, on synthetic events."""
import pytest

from hyca_bench.counts import moe as counts
from hyca_bench.harness import spec, trace


def x(cat, name, ts, dur, grid=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if grid is not None:
        e["args"] = {"grid": grid}
    return e


EVENTS = [
    x("user_annotation", trace.WINDOW, 1000.0, 1000.0),
    x("user_annotation", "scan_step", 1000.0, 100.0),
    x("user_annotation", "step_fn", 1400.0, 200.0),
    x("kernel", "void (anonymous namespace)::ft_strip_mma_kernel(__nv_bfloat16 const*)", 1100.0, 200.0, [8, 8, 1]),
    x("kernel", "void (anonymous namespace)::ft_strip_mma_kernel(__nv_bfloat16 const*)", 1250.0, 100.0, [8, 8, 48]),
    x("kernel", "void (anonymous namespace)::ft_kfast_kernel<__nv_bfloat16, __nv_bfloat16>(int)", 1700.0, 100.0,
      [4, 8, 1]),
    x("gpu_memcpy", "Memcpy DtoH", 1900.0, 200.0),   # clipped to the window's end
    x("cpu_op", "aten::mm", 1000.0, 900.0),
]


def test_reduce_clips_unions_and_names_gaps():
    rec = trace.reduce(EVENTS)
    assert rec["window_s"] == pytest.approx(1e-3)
    # device busy: [1100, 1350] + [1700, 1800] + [1900, 2000]
    assert rec["busy_s"] == pytest.approx(450e-6)
    idle = dict(rec["idle"])
    assert rec["idle"][0] == ("scan_step", pytest.approx(100e-6))   # [1000, 1100]
    assert idle["step_fn"] == pytest.approx(350e-6)                 # [1350, 1700], middle inside step_fn
    assert idle["host"] == pytest.approx(100e-6)                    # [1800, 1900]
    b = trace.breakdown(rec)
    assert b["device_ops"][0][1] == pytest.approx(300e-6) and len(b["idle_gaps"]) == 3
    assert trace.reduce([e for e in EVENTS if e["name"] != trace.WINDOW]) == {}


def test_device_readers():
    m = {"hidden_size": 64, "head_dim": 16, "num_attention_heads": 4, "num_key_value_heads": 2,
         "first_k_dense_replace": 0, "num_hidden_layers": 1, "num_local_experts": 8, "num_experts_per_tok": 2,
         "intermediate_size": 32, "n_shared_experts": 0, "vocab_size": 500}
    calls = [{"kernel": "ft_matmul", "flops": 2e9, "bytes": 3.35e6}, {"kernel": "ft_matmul", "flops": 0, "bytes": 0},
             {"kernel": "ft_matmul_batched", "flops": 989e6, "bytes": 0}]
    rec = {"profile": trace.reduce(EVENTS), "profiled_calls": calls, "counts": counts, "model": m}
    # two ft_matmul launches found (200 + 100 us) for two calls whose bound is 2.02 us
    assert spec.reader("ft_matmul_roofline.serve")(rec, "") == pytest.approx(100 * 2.0222e-6 / 300e-6, rel=1e-3)
    assert spec.reader("ft_matmul_batched_roofline.serve")(rec, "") == pytest.approx(100 * 1e-6 / 100e-6)
    assert spec.reader("device_idle_share.serve")(rec, "") == pytest.approx(55.0)
    assert spec.reader("ft_matmul_roofline.serve")({"profile": None}, "") is None


def test_rooflines_compare_launches_with_calls():
    """One launch a call: the sum of their times.  More launches than calls,
    or more than 1% of the calls without a launch: no reading."""
    prof = trace.reduce(EVENTS)   # two ft_matmul launches (200 + 100 us), one batched
    call = {"kernel": "ft_matmul", "flops": 2e9, "bytes": 0}
    read = spec.reader("ft_matmul_roofline.prefill")

    def rec(n_calls):
        return {"profile": prof, "profiled_calls": [call] * n_calls, "counts": counts}

    bound = counts.bound_s(call)
    assert read(rec(2), "") == pytest.approx(100 * 2 * bound / 300e-6)
    assert trace.launches(rec(2)) == {"ft_matmul": [2, 2], "ft_matmul_batched": [1, 0]}
    assert read(rec(1), "") is None         # a call split into two launches
    assert read(rec(3), "") is None         # a third of the calls lost
    # 1 of 200 lost: the found launches' mean times the calls; 4 of 203: none
    many = {"device": [("ft_strip_mma_kernel(int)", 0.0, 1.0, (8, 8, 1))] * 199}
    assert read({"profile": many, "profiled_calls": [call] * 200, "counts": counts}, "") == pytest.approx(
        100 * 200 * bound / (1e-6 * 200))
    assert read({"profile": many, "profiled_calls": [call] * 203, "counts": counts}, "") is None
