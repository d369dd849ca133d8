"""The port's detection layer held against the JAX package's: the output
block check, the OnlineVerifier and its FPT append, the ScanEngine's suspect
set, and the Section IV-D model (``clb_bytes``, ``layer_covered``,
``coverage``, ``scan_array``, ``scans_to_full_detection``).  Integer checks
are exact; the float check flags the same elements (NaN included) on
operands whose clean differences sit far below the tolerance."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import array_sim as JAS
from repro.core import detection as JD
from repro.core import engine as JE
from repro.core import scan as JSC
from repro.core.perf_model import NETWORKS
from repro.runtime import online_verify as JOV
from repro_torch.core import array_sim as TAS
from repro_torch.core import detection as TD
from repro_torch.core import engine as TE
from repro_torch.core import scan as TSC
from repro_torch.runtime import OnlineVerifier, append_fault


def _unprotected(x, w, faults, rows=8, cols=8):
    """One (M, N) output of both packages' engines with stuck-at faults."""
    fpt = np.array([[r, c] for r, c, _, _ in faults], np.int32)
    bit = np.array([b for _, _, b, _ in faults], np.int32)
    val = np.array([v for _, _, _, v in faults], np.int32)
    js = JE.FaultState(jnp.asarray(fpt), jnp.asarray(bit), jnp.asarray(val))
    ts = TE.FaultState(torch.from_numpy(fpt), torch.from_numpy(bit), torch.from_numpy(val))
    jo = JE.hyca_matmul(jnp.asarray(x), jnp.asarray(w), js, cfg=JE.HyCAConfig(rows, cols, mode="unprotected"))
    to = TE.hyca_matmul(torch.from_numpy(x), torch.from_numpy(w), ts, cfg=TE.HyCAConfig(rows, cols, mode="unprotected"))
    return jo, to


# --------------------------------------------------------------------------- #
# output_block_check
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("window", [4, 8, 64])
def test_output_block_check_int_exact_with_wrap(window):
    """int32 operands whose products wrap the accumulator: PR + BAR wraps as
    the array does, so only the faulty PE's elements flag."""
    rng = np.random.default_rng(0)
    x = rng.integers(2**14, 2**15, size=(16, 24)).astype(np.int32)
    w = rng.integers(2**14, 2**15, size=(24, 16)).astype(np.int32)
    jo, to = _unprotected(x, w, [(2, 5, 3, 1), (6, 1, 31, 0)])
    assert np.array_equal(np.asarray(jo), to.numpy())
    for row0, row1, n_cols in ((0, 8, 16), (2, 3, 8), (5, 16, 11)):
        kw = dict(row0=row0, row1=row1, n_cols=n_cols, window=window, rtol=1e-3)
        got = TSC.output_block_check(torch.from_numpy(x), torch.from_numpy(w), to, **kw)
        want = JSC.output_block_check(jnp.asarray(x), jnp.asarray(w), jo, **kw)
        assert isinstance(got, np.ndarray) and got.dtype == bool
        np.testing.assert_array_equal(got, want)
    full = TSC.output_block_check(torch.from_numpy(x), torch.from_numpy(w), to, row0=0, row1=16,
                                  n_cols=16, window=window, rtol=1e-3)
    assert full.any()
    assert {(i % 8, j % 8) for i, j in zip(*np.nonzero(full))} <= {(2, 5), (6, 1)}


def test_output_block_check_float_flags_nan():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 32)).astype(np.float32)
    w = rng.standard_normal((32, 8)).astype(np.float32)
    clean = (torch.from_numpy(x) @ torch.from_numpy(w)).numpy()
    raw = clean.view(np.int32)
    # exponent bits (30, 23) stuck at the complement of what the clean
    # output holds there: both outputs change by a factor of 2 or more
    faults = [(r, c, b, 1 - int((raw[r, c] >> b) & 1)) for r, c, b in ((3, 4, 30), (5, 2, 23))]
    jo, to = _unprotected(x, w, faults)
    to = to.clone()
    to[1, 6] = float("nan")
    kw = dict(row0=0, row1=8, n_cols=8, window=8, rtol=1e-3)
    got = TSC.output_block_check(torch.from_numpy(x), torch.from_numpy(w), to, **kw)
    want = JSC.output_block_check(jnp.asarray(x), jnp.asarray(w), jnp.asarray(to.numpy()), **kw)
    np.testing.assert_array_equal(got, want)
    assert sorted(zip(*np.nonzero(got))) == [(1, 6), (3, 4), (5, 2)]


def test_scan_engine_suspect_matches_jax():
    hits = np.array([[0, 1, 2, 3], [1, 0, 0, 5], [0, 0, 1, 0], [2, 2, 0, 1]], np.int32)
    for confirm in (1, 2, 3):
        te = TSC.build_scan_engine(4, 4, confirm_hits=confirm, device="cpu")
        je = JSC.build_scan_engine(4, 4, confirm_hits=confirm)
        ts = dataclasses.replace(te.init_state(), hits=torch.from_numpy(hits))
        js = dataclasses.replace(je.init_state(), hits=jnp.asarray(hits))
        np.testing.assert_array_equal(te.suspect(ts).numpy(), np.asarray(je.suspect(js)))
        np.testing.assert_array_equal(te.confirmed(ts).numpy(), np.asarray(je.confirmed(js)))


# --------------------------------------------------------------------------- #
# OnlineVerifier and append_fault
# --------------------------------------------------------------------------- #
def test_verifier_cursors_per_shape_match_jax():
    """Alternating output shapes each keep their own cursor: every PE of
    each occupied grid is visited, in the reference's order."""
    tv, jv = OnlineVerifier(rows=4, cols=4), JOV.OnlineVerifier(rows=4, cols=4)
    assert tv.occupied(2, 9) == jv.occupied(2, 9) == (2, 4)
    assert tv.occupied() == (4, 4) and tv.occupied(0, 0) == (1, 1)
    assert {tv.coord(s) for s in range(16)} == {jv.coord(s) for s in range(16)}
    assert len({tv.coord(s) for s in range(16)}) == 16 and tv.scan_cycles() == jv.scan_cycles() == 20
    rng = np.random.default_rng(2)
    seen_t, seen_j = [], []
    for s in range(24):
        m = 2 if s % 2 else 3
        x = rng.integers(-4, 5, size=(m, 12)).astype(np.float32)
        w = rng.integers(-4, 5, size=(12, 6)).astype(np.float32)
        out = x @ w
        seen_t.append(tv.check(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(out)))
        seen_j.append(jv.check(jnp.asarray(x), jnp.asarray(w), jnp.asarray(out)))
    assert seen_t == seen_j and all(ok for ok, _ in seen_t)
    assert {rc for i, (_, rc) in enumerate(seen_t) if i % 2} == {(r, c) for r in range(2) for c in range(4)}
    assert tv.step == jv.step == 24 and tv._cursors == jv._cursors


@pytest.mark.parametrize("block_rows", [1, 3])
def test_verifier_check_and_check_block_find_the_faulty_pe(block_rows):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    jo, to = _unprotected(x, w, [(2, 5, 28, 1)])
    tv = OnlineVerifier(rows=8, cols=8, block_rows=block_rows)
    jv = JOV.OnlineVerifier(rows=8, cols=8, block_rows=block_rows)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    elem = [tv.check(tx, tw, to) for _ in range(64)]
    assert elem == [jv.check(jnp.asarray(x), jnp.asarray(w), jo) for _ in range(64)]
    assert [rc for ok, rc in elem if not ok] == [(2, 5)]
    blocks = [tv.check_block(tx, tw, to) for _ in range(8)]
    assert blocks == [jv.check_block(jnp.asarray(x), jnp.asarray(w), jo) for _ in range(8)]
    flagged = [f for ok, f in blocks if not ok]
    assert flagged and all(f == [(2, 5)] for f in flagged)
    # an integer output compares exactly
    xi, wi = rng.integers(-8, 8, (8, 16)).astype(np.int32), rng.integers(-8, 8, (16, 8)).astype(np.int32)
    _, oi = _unprotected(xi, wi, [(6, 3, 9, 1)])
    found = {rc for _ in range(8) for rc in OnlineVerifier(rows=8, cols=8, block_rows=8)
             .check_block(torch.from_numpy(xi), torch.from_numpy(wi), oi)[1]}
    assert found <= {(6, 3)}


def _tables(fpt, bits=None, vals=None):
    fpt = np.asarray(fpt, np.int32).reshape(-1, 2)
    bits = np.zeros(len(fpt), np.int32) if bits is None else np.asarray(bits, np.int32)
    vals = np.zeros(len(fpt), np.int32) if vals is None else np.asarray(vals, np.int32)
    return (JE.FaultState(jnp.asarray(fpt), jnp.asarray(bits), jnp.asarray(vals)),
            TE.FaultState(torch.from_numpy(fpt), torch.from_numpy(bits), torch.from_numpy(vals)))


def test_append_fault_dedup_growth_and_order_match_jax():
    js, ts = _tables([[-1, -1]] * 3)
    for rc in [(3, 7), (1, 2), (3, 7), (0, 2), (5, 0), (2, 2), (1, 2)]:
        ts, js = append_fault(ts, *rc), JOV.append_fault(js, *rc)
        for a, b in ((ts.fpt, js.fpt), (ts.stuck_bit, js.stuck_bit), (ts.stuck_val, js.stuck_val)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ts.max_faults == 5 and ts.fpt.dtype == torch.int32
    assert [tuple(r) for r in ts.fpt.tolist()] == [(5, 0), (1, 2), (0, 2), (2, 2), (3, 7)]
    # signatures stay with their entry through the reordering
    js, ts = _tables([[4, 6], [-1, -1]], bits=[30, 0], vals=[1, 0])
    ts, js = append_fault(ts, 0, 1), JOV.append_fault(js, 0, 1)
    np.testing.assert_array_equal(ts.stuck_bit.numpy(), np.asarray(js.stuck_bit))
    assert ts.fpt.tolist() == [[0, 1], [4, 6]] and ts.stuck_bit.tolist() == [0, 30]
    assert append_fault(ts, 4, 6) is ts


# --------------------------------------------------------------------------- #
# the Section IV-D model
# --------------------------------------------------------------------------- #
def test_clb_coverage_and_layer_cycles_match_jax():
    assert TD.clb_bytes(32) == JD.clb_bytes(32) == 512
    assert TD.clb_bytes(16, 2, dppu_groups=4) == JD.clb_bytes(16, 2, dppu_groups=4)
    with pytest.raises(ValueError):
        TD.clb_bytes(32, dppu_groups=0)
    for net, layers in NETWORKS.items():
        tl = [TAS.ConvLayer(**dataclasses.asdict(l)) for l in layers]
        for rows, cols, p in ((32, 32, 1), (16, 64, 1), (32, 32, 32), (8, 8, 4)):
            assert TD.coverage(tl, rows, cols, dppu_groups=p) == JD.coverage(layers, rows, cols, dppu_groups=p), net
            assert [TAS.layer_cycles(a, rows, cols) for a in tl] == [JAS.layer_cycles(b, rows, cols) for b in layers]
            assert [TD.layer_covered(a, rows, cols, dppu_groups=p) for a in tl] == \
                [JD.layer_covered(b, rows, cols, dppu_groups=p) for b in layers]
    assert TD.coverage([TAS.ConvLayer(**dataclasses.asdict(l)) for l in NETWORKS["vgg16"]], 32, 32) == (16, 16)
    assert TD.coverage([], 32, 32) == (0, 0)
    need = TD.detection_cycles(8, 8)
    boundary = TAS.ConvLayer(c_in=need - (2 * 8 + 8 - 2), k=1, out_pixels=1, c_out=8)
    assert TAS.layer_cycles(boundary, 8, 8) == need and TD.layer_covered(boundary, 8, 8)
    short = dataclasses.replace(boundary, c_in=boundary.c_in - 1)
    assert not TD.layer_covered(short, 8, 8)


@pytest.mark.parametrize("visibility,block_rows", [(1.0, None), (0.6, None), (0.8, 4)])
def test_scan_array_matches_jax(visibility, block_rows):
    fmap = np.random.default_rng(4).random((32, 32)) < 0.05
    got = TD.scan_array(np.random.default_rng(5), fmap, fault_visibility=visibility,
                        block_rows=block_rows, device="cpu")
    want = JD.scan_array(np.random.default_rng(5), fmap, fault_visibility=visibility, block_rows=block_rows)
    np.testing.assert_array_equal(got.detected, want.detected)
    assert (got.false_positives, got.false_negatives) == (want.false_positives, want.false_negatives)
    assert got.false_positives == 0
    if visibility == 1.0:
        assert got.false_negatives == 0 and (got.detected == fmap).all()


def test_scans_to_full_detection_matches_jax():
    fmap = np.random.default_rng(6).random((16, 16)) < 0.1
    for vis in (1.0, 0.5):
        got = TD.scans_to_full_detection(np.random.default_rng(7), fmap, vis, device="cpu")
        assert got == JD.scans_to_full_detection(np.random.default_rng(7), fmap, vis)
    assert TD.scans_to_full_detection(np.random.default_rng(7), fmap, 1.0, device="cpu") == 1
