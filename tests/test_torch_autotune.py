"""The ``ft_matmul`` plan autotuner (``repro_torch.kernels.autotune``) and
the explicit-plan path of ``ft_matmul``, on the CPU.

The search times the CUDA kernel, so here it runs with a stub timer; the
cache, the plan check and the lookup are host code.  Every test points
``REPRO_AUTOTUNE_DIR`` at a temporary directory: a persisted cache never
reaches another test.
"""
import json
from pathlib import Path

import pytest
import torch

from repro_torch.core.engine import FaultState, HyCAConfig
from repro_torch.core.ftcontext import build_ftcontext
from repro_torch.kernels import autotune as TA
from repro_torch.kernels.ft_matmul import (
    KFAST_COLS, STRIP, TILE_COLS, TILE_PLAN, FTPlan, ft_matmul, ft_matmul_ref, ft_plan, plan_candidates, validate_plan,
    w_layout,
)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_DIR", str(tmp_path / "autotune"))
    TA.reset_cache()
    yield tmp_path / "autotune" / "ft_matmul.json"
    TA.reset_cache()


def test_cache_path_round_trip_and_reset(isolated, monkeypatch):
    assert TA.cache_path() == str(isolated)
    assert TA.load_cache() == {}
    entry = {"plan": {"layout": "n_fast", "split": 4, "bn": STRIP}, "ms": 0.01, "candidates": {"4": 0.01}}
    TA.save_cache({"4x64x64:bfloat16:n_fast:cuda": entry})
    assert json.loads(isolated.read_text()) == {"4x64x64:bfloat16:n_fast:cuda": entry}
    TA.reset_cache()
    assert TA.load_cache() == {"4x64x64:bfloat16:n_fast:cuda": entry}
    # entries no kernel takes, and a corrupt file, load as absent
    isolated.write_text(json.dumps({"a": {"plan": {"layout": "n_fast", "split": 3, "bn": STRIP}},
                                    "b": {"block": [8, 128, 128]}, "c": entry}))
    assert TA.load_cache(reload=True) == {"c": entry}
    isolated.write_text("{not json")
    assert TA.load_cache(reload=True) == {}
    monkeypatch.delenv("REPRO_AUTOTUNE_DIR")
    default = Path(TA.cache_path())
    assert default == ROOT / "build" / "repro_torch" / "autotune" / "ft_matmul.json"
    assert "experiments" not in default.parts


def test_validate_plan_refusals():
    w = torch.zeros(64, 128, dtype=torch.bfloat16)
    assert w_layout(w) == "n_fast" and w_layout(w.T.contiguous().T) == "k_fast"
    for s in (1, 2, 4, 8):
        assert validate_plan(FTPlan("n_fast", s, STRIP), w) == FTPlan("n_fast", s, STRIP)
    with pytest.raises(ValueError, match="takes the 'n_fast' layout"):
        validate_plan(FTPlan("k_fast", 1, KFAST_COLS), w)
    with pytest.raises(ValueError, match="takes"):
        validate_plan(FTPlan("n_fast", 3, STRIP), w)
    with pytest.raises(ValueError, match="takes"):
        validate_plan(FTPlan("n_fast", 16, STRIP), w)
    with pytest.raises(ValueError, match="takes"):
        validate_plan(FTPlan("n_fast", 2, KFAST_COLS), w)
    with pytest.raises(ValueError, match="takes"):
        validate_plan(FTPlan("k_fast", 2, KFAST_COLS), w.T.contiguous().T)
    with pytest.raises(TypeError):
        validate_plan((8, 128, 128), w)
    assert plan_candidates("k_fast") == (FTPlan("k_fast", 1, KFAST_COLS),)
    assert [p.split for p in plan_candidates("scalar")] == [1, 2, 4, 8]
    # the tile plan: a bf16 n_fast w only
    assert validate_plan(TILE_PLAN, w) == TILE_PLAN == FTPlan("n_fast", 1, TILE_COLS)
    assert plan_candidates("n_fast")[-1] == TILE_PLAN
    assert TILE_PLAN not in plan_candidates("n_fast", torch.float32) + plan_candidates("scalar")
    with pytest.raises(ValueError, match="takes"):
        validate_plan(TILE_PLAN, w.float())
    with pytest.raises(ValueError, match="takes"):
        validate_plan(FTPlan("n_fast", 2, TILE_COLS), w)


def test_explicit_plan_on_the_cpu_is_checked_then_plain():
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-4, 5, (4, 64), generator=g).float()
    w = torch.randint(-4, 5, (64, 128), generator=g).float()
    keep, zero = torch.full((8, 8), -1, dtype=torch.int32), torch.zeros((8, 8), dtype=torch.int32)
    want = ft_matmul_ref(x, w, keep, zero)
    assert torch.equal(ft_matmul(x, w, keep, zero, plan=FTPlan("n_fast", 8, STRIP)), want)
    with pytest.raises(ValueError):
        ft_matmul(x, w, keep, zero, plan=FTPlan("scalar", 1, STRIP))
    with pytest.raises(ValueError):  # an f32 w takes no tile plan
        ft_matmul(x, w, keep, zero, plan=TILE_PLAN)
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    assert torch.equal(ft_matmul(xb, wb, keep, zero, plan=TILE_PLAN), ft_matmul_ref(xb, wb, keep, zero))
    assert ft_matmul.launches == ft_matmul.tile_launches == 0


def test_resolve_plan_miss_hit_and_the_search_with_a_stub_timer():
    m, n, k = 4, 2816, 1024
    rule = ft_plan(1, m, n, k, torch.bfloat16, "n_fast")
    assert TA.resolve_plan(m, n, k, torch.bfloat16, "n_fast") == rule  # a miss: the fixed rule
    times = {"1": 0.030, "2": 0.012, "4": 0.012, "8": 0.020, "tile": 0.025}
    seen = []

    def stub(plan):
        seen.append(plan)
        return times["tile" if plan == TILE_PLAN else str(plan.split)]

    plan, ms, by_split = TA.autotune_plan(m, n, k, time_fn=stub)
    assert seen == list(plan_candidates("n_fast")) and TILE_PLAN in seen  # the candidates include the tile plan
    assert plan == FTPlan("n_fast", 2, STRIP) and ms == 0.012  # the first of equal times
    assert by_split == {"1": 0.030, "2": 0.012, "4": 0.012, "8": 0.020, "tile": 0.025}
    assert TA.resolve_plan(m, n, k, torch.bfloat16, "n_fast") == plan
    assert TA.resolve_plan(m, n, k, torch.float32, "n_fast") == ft_plan(1, m, n, k, torch.float32, "n_fast")
    TA.reset_cache()  # persisted: a new process reads it back
    assert TA.load_cache()[TA.key(m, n, k, torch.bfloat16, "n_fast")]["plan"] == {
        "layout": "n_fast", "split": 2, "bn": STRIP}
    kplan, _, kt = TA.autotune_plan(4, 151936, 1024, layout="k_fast", time_fn=lambda p: 0.1, persist=False)
    assert kplan == FTPlan("k_fast", 1, KFAST_COLS) and kt == {"1": 0.1}
    # at a prefill shape the tile plan wins and is cached; an f32 w never sees it
    tplan, _, tt = TA.autotune_plan(8192, 2048, 2048, time_fn=lambda p: 0.5 if p == TILE_PLAN else 4.0, persist=False)
    assert tplan == TILE_PLAN and tt["tile"] == 0.5
    assert TA.resolve_plan(8192, 2048, 2048, torch.bfloat16, "n_fast") == TILE_PLAN
    fplan, _, ft = TA.autotune_plan(8192, 2048, 2048, dtype=torch.float32, time_fn=lambda p: 1.0, persist=False)
    assert fplan.bn == STRIP and "tile" not in ft


def test_the_search_needs_the_card(monkeypatch):
    with pytest.raises(RuntimeError, match="needs the card"):
        TA.autotune_plan(4, 64, 64)
    with pytest.raises(RuntimeError, match="needs the card"):
        TA.autotune_plan(4, 64, 64, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs the card"):
        TA.main(["4", "64", "64"])


def test_operands_take_each_layout():
    for layout in ("n_fast", "k_fast", "scalar"):
        x, ws = TA.operands(4, 256, 128, torch.bfloat16, layout, "cpu", copies=2)
        assert x.shape == (4, 128) and len(ws) == 2
        assert all(w.shape == (128, 256) and w_layout(w) == layout for w in ws)


def test_auto_context_reads_the_cache_only_for_card_tensors():
    """A cached plan never changes a CPU result, nor a default context's."""
    TA.autotune_plan(4, 64, 32, time_fn=lambda p: 1.0 / p.split)  # caches split 8
    state = FaultState(torch.tensor([[0, 1]] + [[-1, -1]] * 3, dtype=torch.int32),
                       torch.tensor([30, 0, 0, 0], dtype=torch.int32), torch.tensor([1, 0, 0, 0], dtype=torch.int32))
    hyca = HyCAConfig(rows=4, cols=4, mode="unprotected")
    auto = build_ftcontext(state, hyca, dispatch="fused", fused_block="auto")
    none = build_ftcontext(state, hyca, dispatch="fused")
    x = torch.randint(-4, 5, (4, 32)).float()
    w = torch.randint(-4, 5, (32, 64)).float()
    assert torch.equal(auto.matmul(x, w, site="ffn"), none.matmul(x, w, site="ffn"))
    with pytest.raises(ValueError, match="fused_block='auto'"):
        build_ftcontext(state, hyca, autotune_shapes=[(4, 64, 32)])
