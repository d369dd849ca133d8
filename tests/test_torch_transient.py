"""The port's transient stack held against the JAX package's.

The same numpy-seeded inputs go through both packages: SEU injection
(``flip_bits``, the plan samplers), the ABFT lanes (``abft_encode``,
``abft_checksums``, ``hyca_matmul_abft``, ``FTContext.abft_matmul``), the
syndrome decision (``abft_check``, ``abft_syndromes_ref``), the
detector-coverage campaign, ``transient_records`` and the FaultManager's
ABFT canary on the served path.  Integer paths are exact (int32 wraps in
both), flips and plans bitwise; float lanes on random operands agree within
LANE_TOL of their magnitude, and on integer-valued operands bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.core import engine as JE
from repro.core import ftcontext as JF
from repro.core.redundancy import DPPUConfig as JDPPU
from repro.kernels.ref import abft_syndromes_ref as j_syndromes
from repro.obs.events import EventLog as JLog
from repro.obs.events import transient_records as j_records
from repro.serving import FaultTolerantServer as JServer
from repro.serving import ModelBundle as JBundle
from repro.serving import ServerConfig as JConfig
from repro.serving.fault_manager import FaultInjector as JInjector
from repro.serving.fault_manager import FaultManager as JManager
from repro.serving.fault_manager import FaultManagerConfig as JManagerConfig
from repro.transient import abft as JA
from repro.transient import coverage as JC
from repro.transient import seu as JS
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.core import engine as TE
from repro_torch.core import ftcontext as TF
from repro_torch.core.redundancy import DPPUConfig as TDPPU
from repro_torch.kernels.ref import abft_syndromes_ref
from repro_torch.models.lm import params_from_numpy
from repro_torch.obs.events import EventLog, transient_records
from repro_torch.serving import FaultTolerantServer, ModelBundle, ServerConfig
from repro_torch.serving.fault_manager import FaultInjector, FaultManager, FaultManagerConfig
from repro_torch.transient import (
    CoverageSpec,
    FlipPlan,
    FlipSchedule,
    abft_check,
    emit_flip_events,
    flip_bits,
    run_coverage,
    sample_flip_plans,
    sample_kv_flips,
)
from repro_torch.transient.seu import word_bits

# random f32 operands: |port lane - JAX lane| <= LANE_TOL * (|colsum x| @ |w|)
# (or |x| @ |wc|): two f32 reductions in different orders differ by a few
# ulps of that magnitude at these widths
LANE_TOL = 1e-5
ROWS, COLS, DPPU = 4, 4, 3
FAULTS = [(0, 0, 31, 1), (2, 1, 30, 1), (1, 2, 20, 0), (3, 3, 24, 1), (0, 3, 6, 0)]

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32, "int8": torch.int8}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int32": jnp.int32, "int8": jnp.int8}


def _bits(t: torch.Tensor) -> np.ndarray:
    """The stored bit pattern of a tensor as signed words of its width."""
    wdt = {1: torch.int8, 2: torch.int16, 4: torch.int32}[t.element_size()]
    return t.contiguous().view(wdt).numpy()


def _jbits(a) -> np.ndarray:
    wdt = {1: jnp.int8, 2: jnp.int16, 4: jnp.int32}[np.dtype(a.dtype).itemsize]
    return np.asarray(jax.lax.bitcast_convert_type(a, wdt))


def _leaf(name: str, seed: int = 0, shape=(6, 8)):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(shape) * 10).astype(np.float32)
    if name.startswith("int"):
        a = np.clip(np.round(a), -100, 100)
    return torch.from_numpy(a).to(TORCH_DTYPES[name]), jnp.asarray(a, JAX_DTYPES[name])


# --------------------------------------------------------------------------- #
# SEU injection
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(TORCH_DTYPES))
def test_flip_bits_matches_jax_and_is_an_involution(name):
    t, j = _leaf(name)
    nbits = word_bits(TORCH_DTYPES[name])
    assert nbits == JS.word_bits(JAX_DTYPES[name]) == t.element_size() * 8
    rng = np.random.default_rng(1)
    idx = rng.choice(48, size=9, replace=False).astype(np.int32)
    bit = rng.integers(0, nbits, size=9).astype(np.int32)
    bit[0] = nbits - 1  # the sign bit of the word
    before = _bits(t).copy()
    once = flip_bits(t, torch.from_numpy(idx), torch.from_numpy(bit))
    assert once.dtype == t.dtype and once.shape == t.shape
    np.testing.assert_array_equal(_bits(once), _jbits(JS.flip_bits(j, jnp.asarray(idx), jnp.asarray(bit))))
    np.testing.assert_array_equal(_bits(t), before)               # pure
    assert not np.array_equal(_bits(once), before)
    np.testing.assert_array_equal(_bits(flip_bits(once, idx, bit)), before)  # involution


@pytest.mark.parametrize("name", list(TORCH_DTYPES))
def test_flip_bits_padding_and_out_of_range_are_dropped(name):
    """-1 padding (which torch indexing would read as the last word) and
    indices past the leaf touch nothing, beside a real flip."""
    t, j = _leaf(name, seed=2)
    idx = np.array([-1, 5, -1, 48, -1], np.int32)
    bit = np.array([3, word_bits(TORCH_DTYPES[name]) - 1, 0, 1, 2], np.int32)
    got = flip_bits(t, idx, bit)
    np.testing.assert_array_equal(_bits(got), _jbits(JS.flip_bits(j, jnp.asarray(idx), jnp.asarray(bit))))
    delta = (_bits(got) ^ _bits(t)).reshape(-1)
    assert np.flatnonzero(delta).tolist() == [5]
    assert np.array_equal(_bits(flip_bits(t, np.full(4, -1, np.int32), np.zeros(4, np.int32))), _bits(t))


def test_flip_bits_bit31_is_the_sign_of_an_int32_word():
    x = torch.arange(64, dtype=torch.int32)
    delta = _bits(flip_bits(x, [3, 17, 40], [0, 13, 31])) ^ _bits(x)
    expect = np.zeros(64, np.int32)
    for i, b in zip([3, 17, 40], [0, 13, 31]):
        expect[i] = np.int32(np.uint32(1) << np.uint32(b))
    np.testing.assert_array_equal(delta, expect)
    assert int(flip_bits(x, [40], [31])[40]) == 40 - 2**31
    with pytest.raises(ValueError, match="8/16/32-bit"):
        flip_bits(torch.zeros(4, dtype=torch.float64), [0], [0])


def test_samplers_draw_the_reference_plans():
    for kw in (dict(rate=0.01), dict(n_flips=3), dict(rate=0.02, max_flips=4, nbits=16)):
        a = sample_flip_plans(np.random.default_rng(5), 40, 2048, **kw)
        b = JS.sample_flip_plans(np.random.default_rng(5), 40, 2048, **kw)
        assert np.array_equal(a.idx, b.idx) and np.array_equal(a.bit, b.bit)
        np.testing.assert_array_equal(a.counts(), b.counts())
    live = np.array([0, 5, 16, 3])
    for kw in (dict(rate=0.08), dict(n_flips=2)):
        a = sample_kv_flips(np.random.default_rng(6), 64, (4, 16, 8), live, **kw)
        b = JS.sample_kv_flips(np.random.default_rng(6), 64, (4, 16, 8), live, **kw)
        assert np.array_equal(a.idx, b.idx) and np.array_equal(a.bit, b.bit)
        for row in a.idx:
            for i in row[row >= 0]:
                assert i % (16 * 8) // 8 < live[i // (16 * 8)]
    dead = sample_kv_flips(np.random.default_rng(7), 8, (4, 16, 8), np.zeros(4, int), rate=0.5)
    assert dead.counts().sum() == 0
    with pytest.raises(ValueError, match="exactly one"):
        sample_flip_plans(np.random.default_rng(0), 2, 10)
    with pytest.raises(ValueError, match="shape"):
        FlipPlan(np.zeros((2, 3), np.int32), np.zeros((2, 4), np.int32))
    plan = sample_flip_plans(np.random.default_rng(0), 4, 64, n_flips=1)
    FlipSchedule(site="kv", steps=np.arange(4), plan=plan)
    with pytest.raises(ValueError, match="steps"):
        FlipSchedule(site="kv", steps=np.arange(3), plan=plan)


def test_transient_records_match_the_reference():
    plan = sample_flip_plans(np.random.default_rng(3), 3, 64, n_flips=2)
    logs = (EventLog(), JLog())
    for log, emit in zip(logs, (emit_flip_events, JS.emit_flip_events)):
        log.step = 0
        assert emit(log, "weights", 2, plan, config=0) == 2
        emit(log, "kv", 10, plan, config=1)
        log.emit("abft.alarm", step=5, site="probe", n_flagged=1, syndrome_max=17)
        emit(log, "activations", 5, plan, config=2)
        log.emit("abft.alarm", step=7, site="probe", n_flagged=2, syndrome_max=3)
    got, want = transient_records(logs[0]), j_records(logs[1])
    assert got == want
    assert [r["latency"] for r in got] == [3, 3, None, None, 0, 0]


# --------------------------------------------------------------------------- #
# ABFT lanes and the syndrome decision
# --------------------------------------------------------------------------- #
def _states(faults, max_faults=16):
    fpt = np.full((max_faults, 2), -1, np.int32)
    bits = np.zeros(max_faults, np.int32)
    vals = np.zeros(max_faults, np.int32)
    for i, (r, c, b, v) in enumerate(sorted(faults, key=lambda f: (f[1], f[0]))):
        fpt[i], bits[i], vals[i] = (r, c), b, v
    return (JE.FaultState(jnp.asarray(fpt), jnp.asarray(bits), jnp.asarray(vals)),
            TE.FaultState(torch.from_numpy(fpt), torch.from_numpy(bits), torch.from_numpy(vals)))


def _cfgs(mode, rows=ROWS, cols=COLS, dppu=DPPU):
    return (JE.HyCAConfig(rows, cols, JDPPU(size=dppu, group_size=dppu), mode),
            TE.HyCAConfig(rows, cols, TDPPU(size=dppu, group_size=dppu), mode))


def _plans():
    col_map = np.array([1, 3, 0, 2], np.int32)
    prune = np.zeros((ROWS, COLS), bool)
    prune[3, 3] = True
    return (JE.RepairPlan(jnp.asarray(col_map), jnp.asarray(prune)),
            TE.RepairPlan(torch.from_numpy(col_map), torch.from_numpy(prune)))


def _eq(a, b):
    """Bitwise equality of a torch tensor and a JAX array (None == None)."""
    if a is None or b is None:
        return a is None and b is None
    b = np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.numpy().view(np.uint8), b.view(np.uint8))


def test_abft_encode_wraps_like_int32():
    """Three words of 2**30 in one row sum to -2**30 in int32, as in JAX."""
    w = np.array([[2**30, 2**30, 2**30, 1], [1, 2, 3, 4]], np.int32)
    got = TE.abft_encode(torch.from_numpy(w))
    assert got.dtype == torch.int32 and got.tolist() == [-(2**30) + 1, 10]
    assert _eq(got, JE.abft_encode(jnp.asarray(w)))
    wf = np.random.default_rng(0).standard_normal((8, 6)).astype(np.float32)
    np.testing.assert_allclose(TE.abft_encode(torch.from_numpy(wf)).numpy(),
                               np.asarray(JE.abft_encode(jnp.asarray(wf))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["off", "protected", "unprotected"])
@pytest.mark.parametrize("with_plan", [False, True])
def test_hyca_matmul_abft_int32_exact(mode, with_plan):
    rng = np.random.default_rng(3)
    x = rng.integers(-50, 50, size=(2, 5, 12)).astype(np.int32)
    w = rng.integers(-50, 50, size=(12, 10)).astype(np.int32)
    js, ts = _states(FAULTS)
    jc, tc = _cfgs(mode)
    jp, tp = _plans() if with_plan else (None, None)
    jwc, twc = JE.abft_encode(jnp.asarray(w)), TE.abft_encode(torch.from_numpy(w))
    want = JE.hyca_matmul_abft(jnp.asarray(x), jnp.asarray(w), js, cfg=jc, plan=jp, wc=jwc)
    got = TE.hyca_matmul_abft(torch.from_numpy(x), torch.from_numpy(w), ts, cfg=tc, plan=tp, wc=twc)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32 and _eq(a, b)
    res, jres = abft_check(*got), JA.abft_check(*want)
    for k in ("col_flags", "row_flags", "detected"):
        assert _eq(res[k], jres[k]), k
    chk_row, chk_col = TE.abft_checksums(torch.from_numpy(x), torch.from_numpy(w), ts, cfg=tc, plan=tp)
    assert chk_col is None and _eq(chk_row, want[1])


def test_abft_int32_syndrome_wraps_like_the_reference():
    """A stuck-at-1 on bit 31 of a PE that holds two elements of each of its
    output columns and rows moves each of those sums by -2**32: zero in the
    int32 accumulator.  JAX does not flag it, and neither does the port
    (an int64 sum would)."""
    rng = np.random.default_rng(4)
    x = rng.integers(1, 5, size=(8, 12)).astype(np.int32)
    w = rng.integers(1, 5, size=(12, 8)).astype(np.int32)
    js, ts = _states([(1, 2, 31, 1)])
    jc, tc = _cfgs("unprotected")
    want = JE.hyca_matmul_abft(jnp.asarray(x), jnp.asarray(w), js, cfg=jc, wc=JE.abft_encode(jnp.asarray(w)))
    got = TE.hyca_matmul_abft(torch.from_numpy(x), torch.from_numpy(w), ts, cfg=tc,
                              wc=TE.abft_encode(torch.from_numpy(w)))
    assert all(_eq(a, b) for a, b in zip(got, want))
    assert int((got[0] < 0).sum()) == 4  # rows 1, 5 x cols 2, 6
    res, jres = abft_check(*got), JA.abft_check(*want)
    assert not bool(jres["detected"]) and not bool(res["detected"])
    for k in ("col_flags", "row_flags"):
        assert _eq(res[k], jres[k])
    # the f64 oracle sees the -2**32 moves the int32 sums cannot
    col, row = abft_syndromes_ref(x, w, got[0], wc=TE.abft_encode(torch.from_numpy(w)))
    assert sorted(np.flatnonzero(col)) == [2, 6] and sorted(np.flatnonzero(row)) == [1, 5]
    assert set(col[col != 0]) == {2.0**32}


def test_abft_detects_mac_and_weight_flips_with_the_oracle():
    rng = np.random.default_rng(5)
    x = rng.integers(1, 5, size=(8, 12)).astype(np.int32)
    w = rng.integers(1, 5, size=(12, 8)).astype(np.int32)
    # an unprotected stuck-at on PE row 1: the carried column lane (PE row 0)
    # stays clean and flags the faulty PE column's residue class
    js, ts = _states([(1, 2, 12, 1)])
    jc, tc = _cfgs("unprotected")
    got = TE.hyca_matmul_abft(torch.from_numpy(x), torch.from_numpy(w), ts, cfg=tc,
                              wc=TE.abft_encode(torch.from_numpy(w)))
    res = abft_check(*got)
    flagged = np.flatnonzero(res["col_flags"].numpy())
    assert bool(res["detected"]) and flagged.size and np.all(flagged % COLS == 2)
    jres = JA.abft_check(*JE.hyca_matmul_abft(jnp.asarray(x), jnp.asarray(w), js, cfg=jc,
                                              wc=JE.abft_encode(jnp.asarray(w))))
    assert all(_eq(res[k], jres[k]) for k in res)
    # a weight flip after encode: only the encode-time lane sees it
    tw, jw = torch.from_numpy(w), jnp.asarray(w)
    wc = TE.abft_encode(tw)
    w_f = flip_bits(tw, [17], [9])
    out_f = TE._int_matmul(torch.from_numpy(x), w_f)
    chk_row = TE._int_matmul(torch.from_numpy(x).sum(0, keepdim=True), w_f)
    assert not bool(abft_check(out_f, chk_row, None)["detected"])
    seen = abft_check(out_f, chk_row, TE._int_matmul(torch.from_numpy(x), wc.reshape(-1, 1)))
    assert bool(seen["detected"]) and seen["row_flags"].any()
    col, row = abft_syndromes_ref(x, w_f, out_f, wc=wc)
    jcol, jrow = j_syndromes(x, np.asarray(w_f), np.asarray(out_f), wc=np.asarray(JE.abft_encode(jw)))
    np.testing.assert_array_equal(col, jcol)
    np.testing.assert_array_equal(row, jrow)
    np.testing.assert_array_equal(seen["row_flags"].numpy(), row != 0)
    np.testing.assert_array_equal(seen["col_flags"].numpy(), col != 0)


def test_abft_check_float_threshold_and_nan_as_the_reference():
    """Fault-free float lanes stay silent, a large error flags, and a NaN
    output escapes the float flag (the NaN syndrome compares False) — in
    the port exactly as in the reference."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((16, 32)).astype(np.float32)
    w = rng.standard_normal((32, 16)).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    out = tx @ tw
    chk_row, chk_col = TE.abft_checksums(tx, tw, None, cfg=TE.HyCAConfig(), wc=TE.abft_encode(tw))
    jrow, jcol = JE.abft_checksums(jnp.asarray(x), jnp.asarray(w), None, cfg=JE.HyCAConfig(),
                                   wc=JE.abft_encode(jnp.asarray(w)))
    for a, b, scale in ((chk_row, jrow, np.abs(x).sum(0) @ np.abs(w)),
                        (chk_col, jcol, np.abs(x) @ np.abs(w).sum(1))):
        assert np.all(np.abs(a.numpy().ravel() - np.asarray(b).ravel()) <= LANE_TOL * scale.ravel())
    assert not bool(abft_check(out, chk_row, chk_col)["detected"])
    for edit in ((3, 5, 100.0), (2, 7, float("nan"))):
        hit = out.clone()
        hit[edit[0], edit[1]] = edit[2]
        res = abft_check(hit, chk_row, chk_col)
        jres = JA.abft_check(jnp.asarray(hit.numpy()), jrow, jcol)
        for k in res:
            assert _eq(res[k], jres[k]), (edit, k)
    nan = out.clone()
    nan[2, 7] = float("nan")
    assert not bool(abft_check(nan, chk_row, chk_col)["detected"])
    big = out.clone()
    big[3, 5] += 100.0
    assert bool(abft_check(big, chk_row, chk_col)["detected"])


def _int_valued(shape_x, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-8, 8, shape_x).astype(np.float32),
            rng.integers(-8, 8, (shape_x[-1], n)).astype(np.float32))


@pytest.mark.parametrize("dispatch", ["plain", "twopass", "fused"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_ftcontext_abft_matmul_matches_jax(arch, dispatch):
    """Per smoke config: ``out`` is bitwise :meth:`FTContext.matmul`, and with
    integer-valued operands every lane and flag equals JAX's bit for bit,
    fault-free (silent) and with faults past capacity, with and without a
    plan; a context without ``policy.abft`` returns no lanes."""
    d = get_smoke_config(arch).d_model
    assert d == j_smoke(arch).d_model
    x, w = _int_valued((5, d), d, seed=len(arch))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    twc, jwc = TE.abft_encode(tw), JE.abft_encode(jw)
    for faults, mode, with_plan in (([], "protected", False), (FAULTS, "unprotected", False),
                                    (FAULTS, "protected", True)):
        js, ts = _states(faults)
        jc, tc = _cfgs(mode)
        jp, tp = _plans() if with_plan else (None, None)
        pol_t, pol_j = TF.ProtectPolicy(abft=True), JF.ProtectPolicy(abft=True)
        tctx = TF.build_ftcontext(ts, tc, policy=pol_t, dispatch=dispatch, plan=tp)
        jctx = JF.build_ftcontext(js, jc, policy=pol_j, dispatch=dispatch, plan=jp)
        got = tctx.abft_matmul(tx, tw, site="ffn", wc=twc)
        want = jctx.abft_matmul(jx, jw, site="ffn", wc=jwc)
        assert torch.equal(got[0].view(torch.int32), tctx.matmul(tx, tw, site="ffn").view(torch.int32))
        for a, b in zip(got, want):
            assert _eq(a, b), (faults, mode, with_plan)
        res, jres = abft_check(*got), JA.abft_check(*want)
        for k in res:
            assert _eq(res[k], jres[k]), (faults, mode, k)
        if not faults or dispatch == "plain":
            assert not bool(res["detected"])
    plain_policy = TF.build_ftcontext(ts, tc, dispatch=dispatch)
    out, chk_row, chk_col = plain_policy.abft_matmul(tx, tw, site="ffn", wc=twc)
    assert chk_row is None and chk_col is None
    assert torch.equal(out, plain_policy.matmul(tx, tw, site="ffn"))


@pytest.mark.parametrize("dispatch", ["twopass", "fused"])
def test_ftcontext_abft_lanes_on_random_f32_within_tolerance(dispatch):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    js, ts = _states([(1, 2, 25, 1), (3, 1, 22, 0)])
    jc, tc = _cfgs("unprotected")
    tctx = TF.build_ftcontext(ts, tc, policy=TF.ProtectPolicy(abft=True), dispatch=dispatch)
    jctx = JF.build_ftcontext(js, jc, policy=JF.ProtectPolicy(abft=True), dispatch=dispatch)
    got = tctx.abft_matmul(torch.from_numpy(x), torch.from_numpy(w), site="head",
                           wc=TE.abft_encode(torch.from_numpy(w)))
    want = jctx.abft_matmul(jnp.asarray(x), jnp.asarray(w), site="head", wc=JE.abft_encode(jnp.asarray(w)))
    scales = (np.abs(x).sum(0) @ np.abs(w), np.abs(x) @ np.abs(w).sum(1))
    for a, b, scale in zip(got[1:], want[1:], scales):
        a, b = a.numpy().ravel(), np.asarray(b).ravel()
        # a stuck bit on a lane (PE row 0 / col 0 carry none here) would
        # show as a gross difference; these lanes differ only by rounding
        assert np.all(np.abs(a - b) <= LANE_TOL * scale.ravel())
    # the unprotected faults sit on PE rows 1 and 3: the column lane flags
    assert bool(abft_check(*got)["detected"]) and bool(JA.abft_check(*want)["detected"])


# --------------------------------------------------------------------------- #
# the detector-coverage campaign
# --------------------------------------------------------------------------- #
def test_coverage_matrix_equals_jax():
    spec = CoverageSpec(n_configs=24, seed=3)
    got = run_coverage(spec, device="cpu")
    want = JC.run_coverage(JC.CoverageSpec(n_configs=24, seed=3))
    assert got["matrix"] == want["matrix"]
    assert got["classes"] == want["classes"]
    assert got["retraces"] == {"permanent": 1, "transient_mac": 1, "transient_weight": 1}
    cov = {(r["fault_class"], r["detector"]): r["coverage"] for r in got["matrix"]}
    assert cov[("transient_weight", "scan")] == cov[("transient_weight", "verify")] == 0.0
    assert cov[("transient_weight", "abft")] > 0.9
    assert cov[("transient_mac", "abft")] > cov[("transient_mac", "scan")]
    assert cov[("permanent", "scan")] > 0.5


# --------------------------------------------------------------------------- #
# the FaultManager's ABFT canary, alone and on the served path
# --------------------------------------------------------------------------- #
def _events(log):
    return [(e.kind, e.step, e.data) for e in log.events]


def test_fault_manager_canary_matches_jax():
    """The same injector trace through both managers: the same alarms, the
    same events (abft.alarm among the lifecycle), step for step."""
    hyca_j = JE.HyCAConfig(rows=4, cols=4, mode="protected")
    hyca_t = TE.HyCAConfig(rows=4, cols=4, mode="protected")
    ji, ti = JInjector(4, 4, seed=0), FaultInjector(4, 4, seed=0)
    jm = JManager(hyca_j, ji, JManagerConfig(abft=True))
    tm = FaultManager(hyca_t, ti, FaultManagerConfig(abft=True), device="cpu")
    jm.log, tm.log = JLog(), EventLog()
    ji.log, ti.log = jm.log, tm.log
    assert tm.abft_check() is False and jm.abft_check() is False
    assert tm.abft_alarms == 0 and len(tm.log) == 0
    trace = {1: (2, 3, 20, 1), 3: (0, 1, 31, 0), 6: (3, 0, 5, 1), 9: (1, 2, 31, 1)}
    for step in range(14):
        for log in (jm.log, tm.log):
            log.step = step
        if step in trace:
            r, c, b, v = trace[step]
            ji.inject_at(r, c, bit=b, val=v)
            ti.inject_at(r, c, bit=b, val=v)
        assert tm.scan_step() == jm.scan_step()
        assert tm.abft_alarms == jm.abft_alarms
    assert tm.abft_alarms > 0
    assert _events(tm.log) == _events(jm.log)
    assert [e.data for e in tm.log.of_kind("abft.alarm")] == [e.data for e in jm.log.of_kind("abft.alarm")]


ARCH = "qwen1.5-0.5b"
BASE = dict(arch=ARCH, n_slots=4, smax=32, rows=4, cols=4, dppu_size=4, dispatch="fused", seed=0)


def _trace():
    rng = np.random.default_rng(42)
    return [{"step": 0, "prompt": rng.integers(0, 512, size=4), "max_new_tokens": 6} for _ in range(6)]


def _inject_at_2(srv):
    if srv.step_idx == 2:
        srv.injector.inject_at(2, 3, bit=20, val=1)


def test_served_canary_matches_jax_and_moves_no_bit():
    """``abft=True`` on the served path: the events (abft.alarm included) and
    the alarm count equal the JAX server's on the same trace with a fault
    appearing at step 2; the port's tokens and every step's logits equal
    its ``abft=False`` run bit for bit; no alarm before step 2."""
    jb = JBundle(JConfig(mode="off", **BASE), lm=dataclasses.replace(j_smoke(ARCH), dtype=jnp.float32))
    tb = ModelBundle(ServerConfig(mode="off", device="cpu", **BASE),
                     lm=dataclasses.replace(get_smoke_config(ARCH), dtype=torch.float32),
                     params=params_from_numpy(jax.tree.map(np.asarray, jb.params), "cpu"))
    jsrv = JServer(JConfig(mode="protected", abft=True, **BASE), bundle=jb,
                   injector=JInjector(4, 4, seed=BASE["seed"] + 1))
    jsum = jsrv.run(_trace(), max_steps=64, on_step=_inject_at_2)
    runs = {}
    for abft in (True, False):
        srv = FaultTolerantServer(ServerConfig(mode="protected", device="cpu", abft=abft, **BASE), bundle=tb,
                                  injector=FaultInjector(4, 4, seed=BASE["seed"] + 1))
        logits = []
        step = srv.step

        def recording():
            out = step()
            logits.append(srv.decode.logits.clone())
            return out

        srv.step = recording
        summary = srv.run(_trace(), max_steps=64, on_step=_inject_at_2)
        runs[abft] = (srv, summary, logits)
    tsrv, tsum, on_logits = runs[True]
    assert _events(tsrv.log) == _events(jsrv.log)
    assert tsrv.manager.abft_alarms == jsrv.manager.abft_alarms > 0
    assert tsum["abft_alarms"] == jsum["abft_alarms"] == tsrv.manager.abft_alarms
    alarms = [e.step for e in tsrv.log.of_kind("abft.alarm")]
    assert min(alarms) == 2
    off_srv, _, off_logits = runs[False]
    assert off_srv.manager.abft_alarms == 0 and not off_srv.log.of_kind("abft.alarm")
    assert len(on_logits) == len(off_logits)
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(on_logits, off_logits))
    a, b = tsrv.completions_by_rid(), off_srv.completions_by_rid()
    assert a.keys() == b.keys() and all(np.array_equal(a[r], b[r]) for r in a)
    assert [e for e in _events(tsrv.log) if e[0] != "abft.alarm"] == _events(off_srv.log)
