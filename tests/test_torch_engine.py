"""The port's engine held against the JAX engine, bit for bit.

Same inputs (made with numpy from a seed) through ``repro.core.engine`` and
``repro_torch.core.engine``.  Operands are integer-valued, so every float32
accumulate is exact and the outputs must agree in every bit, faulted
elements included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as J
from repro.core.redundancy import DPPUConfig as JDPPU
from repro_torch.core import engine as T
from repro_torch.core.redundancy import DPPUConfig as TDPPU

ROWS, COLS = 4, 4


def _cfgs(mode, dppu=2):
    return (J.HyCAConfig(ROWS, COLS, JDPPU(size=dppu, group_size=dppu), mode),
            T.HyCAConfig(ROWS, COLS, TDPPU(size=dppu, group_size=dppu), mode))


def _states(fpt, bits, vals):
    fpt = np.asarray(fpt, np.int32)
    bits = np.asarray(bits, np.int32)
    vals = np.asarray(vals, np.int32)
    return (J.FaultState(jnp.asarray(fpt), jnp.asarray(bits), jnp.asarray(vals)),
            T.FaultState(torch.from_numpy(fpt), torch.from_numpy(bits), torch.from_numpy(vals)))


# leftmost-sorted FPT with padding: a real fault at PE(0, 0), stuck bit 31
# on stuck-at-1 and stuck-at-0 entries, and more faults than DPPU capacity
FPT = [[0, 0], [2, 0], [1, 1], [3, 2], [0, 3], [-1, -1], [-1, -1]]
BITS = [31, 30, 31, 22, 3, 0, 0]
VALS = [1, 1, 0, 0, 1, 0, 0]


def _plans():
    col_map = np.array([2, 0, 3, 1], np.int32)
    prune = np.zeros((ROWS, COLS), bool)
    prune[1, 2] = prune[3, 0] = True
    return (J.RepairPlan(jnp.asarray(col_map), jnp.asarray(prune)),
            T.RepairPlan(torch.from_numpy(col_map), torch.from_numpy(prune)))


def _operands(dtype, m=9, k=12, n=10, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(-8, 8, (m, k))
    w = rng.integers(-8, 8, (k, n))
    return x.astype(dtype), w.astype(dtype)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("mode", ["off", "protected", "unprotected"])
@pytest.mark.parametrize("with_plan", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_hyca_matmul_bitwise(mode, with_plan, dtype):
    jc, tc = _cfgs(mode)
    js, ts = _states(FPT, BITS, VALS)
    jp, tp = _plans() if with_plan else (None, None)
    x, w = _operands(dtype)
    a = J.hyca_matmul(jnp.asarray(x), jnp.asarray(w), js, cfg=jc, plan=jp)
    b = T.hyca_matmul(torch.from_numpy(x), torch.from_numpy(w), ts, cfg=tc, plan=tp)
    assert np.array_equal(_bits(a), _bits(b.numpy()))
    if mode == "unprotected":
        # the faults are visible: the outputs differ from the clean product
        assert not np.array_equal(np.asarray(a), (x.astype(np.int64) @ w).astype(dtype))


@pytest.mark.parametrize("n_repair", [0, 1, 2, 5, 100])
def test_hyca_matmul_over_capacity_clamp(n_repair):
    jc, tc = _cfgs("protected", dppu=2)
    js, ts = _states(FPT, BITS, VALS)
    x, w = _operands(np.float32, seed=1)
    a = J.hyca_matmul(jnp.asarray(x), jnp.asarray(w), js, cfg=jc, n_repair=n_repair)
    b = T.hyca_matmul(torch.from_numpy(x), torch.from_numpy(w), ts, cfg=tc, n_repair=n_repair)
    assert np.array_equal(_bits(a), _bits(b.numpy()))


def test_hyca_matmul_nd_input():
    jc, tc = _cfgs("unprotected")
    js, ts = _states(FPT, BITS, VALS)
    rng = np.random.default_rng(2)
    x = rng.integers(-8, 8, (2, 3, 12)).astype(np.float32)
    w = rng.integers(-8, 8, (12, 6)).astype(np.float32)
    a = J.hyca_matmul(jnp.asarray(x), jnp.asarray(w), js, cfg=jc)
    b = T.hyca_matmul(torch.from_numpy(x), torch.from_numpy(w), ts, cfg=tc)
    assert b.shape == (2, 3, 6)
    assert np.array_equal(_bits(a), _bits(b.numpy()))


@pytest.mark.parametrize("mode", ["protected", "unprotected"])
@pytest.mark.parametrize("with_plan", [False, True])
def test_fault_meta_grid_and_epilogue(mode, with_plan):
    jc, tc = _cfgs(mode)
    js, ts = _states(FPT, BITS, VALS)
    jp, tp = _plans() if with_plan else (None, None)
    jm = J.fault_meta_grid(js, jc, jp)
    tm = T.fault_meta_grid(ts, tc, tp)
    assert np.array_equal(np.asarray(jm), tm.numpy())
    for dtype in (np.float32, np.int32):
        out, _ = _operands(dtype, m=7, k=10, seed=3)
        a = J.apply_fault_epilogue(jnp.asarray(out), jm, ROWS, COLS)
        b = T.apply_fault_epilogue(torch.from_numpy(out), tm, ROWS, COLS)
        assert np.array_equal(_bits(a), _bits(b.numpy()))
    # one pass of the epilogue == the two-pass engine
    x, w = _operands(np.float32, seed=4)
    two = T.hyca_matmul(torch.from_numpy(x), torch.from_numpy(w), ts, cfg=tc, plan=tp)
    one = T.apply_fault_epilogue(torch.from_numpy(x) @ torch.from_numpy(w), tm, ROWS, COLS)
    assert torch.equal(two.view(torch.int32), one.view(torch.int32))


def test_stuck_bit_31_is_the_sign_bit():
    _, tc = _cfgs("unprotected")
    _, ts = _states([[0, 0]], [31], [1])
    x = torch.ones((1, 1))
    w = torch.full((1, 1), 3.0)
    out = T.hyca_matmul(x, w, ts, cfg=tc)
    assert out.item() == -3.0
    and_g, or_g = T.fault_mask_grids(T.fault_meta_grid(ts, tc))
    assert or_g[0, 0].item() == -2**31


def test_pe_grids_origin_fault_survives_padding():
    """A real fault at PE(0, 0) with padded FPT entries: padding must be
    dropped, never aliased onto the origin."""
    fpt = [[-1, -1], [0, 0], [-1, -1], [2, 3], [-1, -1]]
    bits, vals = [7, 30, 9, 4, 11], [1, 1, 0, 0, 1]
    js, ts = _states(fpt, bits, vals)
    for a, b in zip(J._pe_grids(js, ROWS, COLS), T._pe_grids(ts, ROWS, COLS)):
        assert np.array_equal(np.asarray(a), b.numpy())
    bit, val, faulty = T._pe_grids(ts, ROWS, COLS)
    assert faulty[0, 0] and bit[0, 0] == 30 and val[0, 0] == 1 and int(faulty.sum()) == 2
    for k in range(6):
        assert np.array_equal(np.asarray(J.repaired_grid(js, ROWS, COLS, k)),
                              T.repaired_grid(ts, ROWS, COLS, k).numpy())
    # merging over a padded table keeps the origin fault
    origin = torch.zeros((ROWS, COLS), dtype=torch.bool)
    origin[0, 0] = True
    m = T.empty_fault_state(16).merge(origin)
    m = m.merge(torch.zeros((ROWS, COLS), dtype=torch.bool))
    assert [tuple(r) for r in m.fpt.tolist() if r[0] >= 0] == [(0, 0)]


@pytest.mark.parametrize("max_faults", [3, 8, 16, 24])
def test_fault_state_merge(max_faults):
    """Dedup, leftmost-first sort, overflow truncation (max_faults < faults)
    and an FPT with more slots than the grid has PEs (max_faults > 16)."""
    rng = np.random.default_rng(max_faults)
    fm = rng.random((ROWS, COLS)) < 0.3
    js0 = J.fault_state_from_map(fm, max_faults=max_faults, rng=np.random.default_rng(1))
    ts0 = T.fault_state_from_map(fm, max_faults=max_faults, rng=np.random.default_rng(1))
    det = rng.random((ROWS, COLS)) < 0.4
    det[np.nonzero(fm)[0][:1], np.nonzero(fm)[1][:1]] = True  # re-detect a known PE
    sb = rng.integers(0, 32, (ROWS, COLS)).astype(np.int32)
    sv = rng.integers(0, 2, (ROWS, COLS)).astype(np.int32)
    a = js0.merge(jnp.asarray(det), stuck_bit=jnp.asarray(sb), stuck_val=jnp.asarray(sv))
    b = ts0.merge(torch.from_numpy(det), stuck_bit=torch.from_numpy(sb), stuck_val=torch.from_numpy(sv))
    for x, y in ((a.fpt, b.fpt), (a.stuck_bit, b.stuck_bit), (a.stuck_val, b.stuck_val)):
        assert np.array_equal(np.asarray(x), y.numpy())
    assert b.max_faults == max_faults
    live = [tuple(r) for r in b.fpt.tolist() if r[0] >= 0]
    assert len(live) == len(set(live))
    assert live == sorted(live, key=lambda rc: (rc[1], rc[0]))


@pytest.mark.parametrize("seed", [0, 7])
def test_fault_state_from_map_signatures(seed):
    fm = np.random.default_rng(seed).random((8, 8)) < 0.2
    a = J.fault_state_from_map(fm, max_faults=64, rng=np.random.default_rng(seed))
    b = T.fault_state_from_map(fm, max_faults=64, rng=np.random.default_rng(seed))
    for x, y in ((a.fpt, b.fpt), (a.stuck_bit, b.stuck_bit), (a.stuck_val, b.stuck_val)):
        assert np.array_equal(np.asarray(x), y.numpy())
    assert b.fpt.dtype == torch.int32
    assert T.surviving_columns(b, T.HyCAConfig(8, 8, TDPPU(size=2, group_size=2))) == \
        J.surviving_columns(a, J.HyCAConfig(8, 8, JDPPU(size=2, group_size=2)))


def test_validation_rejects_out_of_bounds():
    _, ts = _states([[0, 4], [-1, -1]], [1, 0], [1, 0])
    with pytest.raises(ValueError, match="out of bounds"):
        T.validate_fault_state(ts, ROWS, COLS)
    bad = T.RepairPlan(torch.tensor([0, 0, 1, 2], dtype=torch.int32), torch.zeros((ROWS, COLS), dtype=torch.bool))
    with pytest.raises(ValueError, match="permutation"):
        T.validate_repair_plan(bad, ROWS, COLS)
    ident = T.identity_plan(ROWS, COLS)
    _, tc = _cfgs("unprotected")
    _, ts = _states(FPT, BITS, VALS)
    x, w = _operands(np.float32, seed=5)
    a = T.hyca_matmul(torch.from_numpy(x), torch.from_numpy(w), ts, cfg=tc, plan=ident)
    b = T.hyca_matmul(torch.from_numpy(x), torch.from_numpy(w), ts, cfg=tc)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
