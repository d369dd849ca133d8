"""The port's kernel tier held against the JAX package's.

``os_array_matmul``, ``dppu_recompute``, ``scatter_overwrite``, the AGU
(``fault_grids``, ``fault_grids_device``), the oracles of ``kernels/ref.py``
and the two-pass / fused pipelines of ``kernels/ops.py``.  On the CPU the
port's wrappers compute their plain twins; the CUDA kernels are held against
those on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).  The JAX
side runs as ``tests/test_kernels.py`` runs it: the Pallas kernels with
``interpret=True``.  Inputs come from numpy with a seed.

Tolerances: integer-valued operands make every accumulate exact in any order,
so those cases are compared bit for bit, stuck-at corruption included (also
int8, and a single K step, where both sides take one product).  Otherwise the
two sum K in different orders: rtol = atol = 1e-4, as the JAX tests use, with
faults on mantissa bits 0-9 only.  A stuck bit b turns a one-ulp difference
that carries across it into a jump of up to 2^(b - 23) of the value: 6e-5 at
b = 9, inside the tolerance; at b = 18 it read 0.6%, and at an exponent bit it
is a factor.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro.kernels.dppu_recompute import dppu_recompute as j_dppu_recompute
from repro.kernels.dppu_recompute import scatter_overwrite as j_scatter_overwrite
from repro.kernels.os_array_matmul import os_array_matmul as j_os_array_matmul
from repro_torch.core import engine as TE
from repro_torch.kernels import _build
from repro_torch.kernels import dppu_recompute as TDR
from repro_torch.kernels import ft_matmul as TFM
from repro_torch.kernels import ops as TO
from repro_torch.kernels import os_array_matmul as TOS
from repro_torch.kernels import ref as TR

# (m, k, n, bm, bn, bk) of tests/test_kernels.py
SHAPES = [
    (128, 128, 128, 128, 128, 128),
    (256, 128, 256, 128, 128, 128),
    (256, 256, 512, 128, 256, 128),
    (384, 128, 256, 128, 128, 128),
]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}
RTOL = ATOL = 1e-4


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _operands(seed, m, k, n, dtype, kind):
    """(jax x, jax w, torch x, torch w) of the same values."""
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        x, w = rng.integers(-30, 30, (m, k)), rng.integers(-30, 30, (k, n))
    elif kind == "integer":
        x, w = rng.integers(-4, 5, (m, k)), rng.integers(-4, 5, (k, n))
    else:
        x, w = rng.standard_normal((m, k)), rng.standard_normal((k, n))
    jd, td = DTYPES[dtype]
    jx, jw = jnp.asarray(x.astype(np.float32)).astype(jd), jnp.asarray(w.astype(np.float32)).astype(jd)
    # the same values on both sides: bf16 rounding happens once, in JAX
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(td)
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(td)
    return jx, jw, tx, tw


def _states(seed, n_faults, *, region_rows=32, region_cols=32, max_bit=32):
    """The same FaultState in both packages: ``n_faults`` PEs drawn from the
    top-left region_rows x region_cols corner (where the test's tiles are),
    leftmost-sorted, with seeded stuck-at signatures on bits < max_bit; the
    first four carry bits 31 and 30 stuck-at-1 and -0 where max_bit allows."""
    rng = np.random.default_rng(seed)
    cells = rng.choice(region_rows * region_cols, size=n_faults, replace=False)
    r, c = cells % region_rows, cells // region_rows
    order = np.lexsort((r, c))
    m = max(n_faults, 1)
    fpt = np.full((m, 2), -1, np.int32)
    fpt[:n_faults, 0], fpt[:n_faults, 1] = r[order], c[order]
    bits = rng.integers(0, max_bit, m).astype(np.int32)
    vals = rng.integers(0, 2, m).astype(np.int32)
    if max_bit == 32:
        for i, (b, v) in enumerate([(31, 1), (30, 0), (30, 1), (31, 0)][:n_faults]):
            bits[i], vals[i] = b, v
    js = JE.FaultState(jnp.asarray(fpt), jnp.asarray(bits), jnp.asarray(vals))
    ts = TE.FaultState(torch.from_numpy(fpt.copy()), torch.from_numpy(bits.copy()), torch.from_numpy(vals.copy()))
    return js, ts


# --------------------------------------------------------------------------- #
# os_array_matmul
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def os_array_cases():
    """JAX interpret outputs, computed once: {(shape, dtype, kind): (...)}."""
    out = {}
    for si, (m, k, n, bm, bn, bk) in enumerate(SHAPES):
        for dtype in DTYPES:
            for kind in (("integer",) if dtype == "int8" else ("integer", "random")):
                # faults where this shape has tiles: PE rows < M / bm, columns < N / bn
                js, ts = _states(1, 5, region_rows=3, region_cols=2,
                                 max_bit=32 if kind == "integer" else 10)
                grids = JO.fault_grids(js, 32, 32, 32)
                jx, jw, tx, tw = _operands(10 + si, m, k, n, dtype, kind)
                want = j_os_array_matmul(jx, jw, *grids[:3], bm=bm, bn=bn, bk=bk, rows=32, cols=32,
                                         interpret=True)
                clean = np.asarray(jnp.matmul(jx.astype(jnp.float32), jw.astype(jnp.float32)))
                out[si, dtype, kind] = (np.asarray(want), clean, tx, tw, ts, grids)
    return out


@pytest.mark.parametrize("si", range(len(SHAPES)), ids=[f"{s[0]}x{s[1]}x{s[2]}" for s in SHAPES])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_os_array_matmul_matches_jax(os_array_cases, si, dtype):
    m, k, n, bm, bn, bk = SHAPES[si]
    for kind in (("integer",) if dtype == "int8" else ("integer", "random")):
        want, clean, tx, tw, ts, jgrids = os_array_cases[si, dtype, kind]
        bit, val, faulty, _ = TO.fault_grids(ts, 32, 32, 32)
        got = TOS.os_array_matmul(tx, tw, bit, val, faulty, bm=bm, bn=bn, bk=bk, rows=32, cols=32)
        assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
        got = got.numpy()
        if dtype == "int8" or kind == "integer" or k // bk == 1:
            assert np.array_equal(_bits(got), _bits(want))
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        if kind == "integer":
            # the set of corrupted elements, and it is not empty
            assert np.array_equal(_bits(got) != _bits(clean), _bits(want) != _bits(clean))
            assert (_bits(got) != _bits(clean)).any()
        # the oracle of kernels/ref.py against JAX's, on the same grids
        oracle = TR.os_array_matmul_ref(tx, tw, bit, val, faulty, bm=bm, bn=bn).numpy()
        j_oracle = np.asarray(JR.os_array_matmul_ref(
            jnp.asarray(tx.float().numpy()).astype(DTYPES[dtype][0]),
            jnp.asarray(tw.float().numpy()).astype(DTYPES[dtype][0]), *jgrids[:3], bm=bm, bn=bn))
        if kind == "integer":
            assert np.array_equal(_bits(oracle), _bits(j_oracle))
            assert np.array_equal(_bits(oracle), _bits(got))
        else:
            np.testing.assert_allclose(oracle, j_oracle, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bm,bn", [(1, 1), (2, 8), (16, 4)])
def test_os_array_matmul_placement_is_any_tile(bm, bn):
    """(bm, bn) set fault placement only: the twin against JAX's oracle at
    tiles far from the kernel's block, on integer-valued operands, bitwise."""
    m, k, n = 32, 24, 48
    jx, jw, tx, tw = _operands(3, m, k, n, "f32", "integer")
    js, ts = _states(4, 6, region_rows=4, region_cols=4)
    jgrids = JO.fault_grids(js, 4, 4, 4)
    want = np.asarray(JR.os_array_matmul_ref(jx, jw, *jgrids[:3], bm=bm, bn=bn))
    bit, val, faulty, _ = TO.fault_grids(ts, 4, 4, 4)
    got = TOS.os_array_matmul(tx, tw, bit, val, faulty, bm=bm, bn=bn, bk=k, rows=4, cols=4).numpy()
    assert np.array_equal(_bits(got), _bits(want))


def test_os_array_matmul_at_element_placement_is_ft_matmul():
    """At bm = bn = 1 with faulty & ~repaired as its grid, the faulty array is
    the serving kernel's element-granular epilogue (no plan): bitwise on
    integer-valued operands."""
    _, _, tx, tw = _operands(5, 12, 40, 20, "f32", "integer")
    _, ts = _states(6, 10, region_rows=4, region_cols=4)
    hyca = TE.HyCAConfig(4, 4, TE.DPPUConfig(size=4, group_size=4), mode="protected")
    bit, val, faulty, repaired = TO.fault_grids(ts, 4, 4, hyca.capacity)
    got = TOS.os_array_matmul(tx, tw, bit, val, faulty & ~repaired, bm=1, bn=1, bk=1, rows=4, cols=4)
    and_g, or_g = TE.fault_mask_grids(TE.fault_meta_grid(ts, hyca))
    want = TFM.ft_matmul(tx, tw, and_g, or_g)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not torch.equal(got, tx @ tw)  # some fault shows


# --------------------------------------------------------------------------- #
# dppu_recompute + scatter_overwrite
# --------------------------------------------------------------------------- #
def _tile_fpt(n_faults, gm=2, gn=2):
    rng = np.random.default_rng(3)
    tiles = rng.choice(gm * gn, size=min(n_faults, gm * gn), replace=False)
    fpt = np.full((max(n_faults, 1), 2), -1, np.int32)
    for i, t in enumerate(tiles):
        fpt[i] = (t // gn, t % gn)
    return fpt


@pytest.mark.parametrize("kind", ["integer", "random"])
@pytest.mark.parametrize("n_faults", [0, 1, 3, 8])
def test_dppu_recompute_and_scatter_match_jax(n_faults, kind):
    """The whole (F, bm, bn) output, padded rows (tile (0, 0)) included, and
    the overwritten buffer."""
    bm = bn = bk = 128
    jx, jw, tx, tw = _operands(2, 256, 256, 256, "f32", kind)
    fpt = _tile_fpt(n_faults)
    jfpt = jnp.asarray(fpt)
    want = np.asarray(j_dppu_recompute(jx, jw, jfpt, bm=bm, bn=bn, bk=bk, interpret=True))
    got = TDR.dppu_recompute(tx, tw, torch.from_numpy(fpt), bm=bm, bn=bn, bk=bk)
    assert got.dtype == torch.float32 and tuple(got.shape) == (fpt.shape[0], bm, bn)
    corrupted = np.asarray(jnp.matmul(jx, jw)) + 7.0
    j_fixed = np.asarray(j_scatter_overwrite(jnp.asarray(corrupted), jnp.asarray(want), jfpt, bm=bm, bn=bn))
    j_oracle = np.asarray(JR.dppu_recompute_ref(jx, jw, jnp.asarray(corrupted), jfpt, bm=bm, bn=bn))
    fixed = TDR.scatter_overwrite(torch.from_numpy(corrupted.copy()), got, torch.from_numpy(fpt), bm=bm, bn=bn)
    oracle = TR.dppu_recompute_ref(tx, tw, torch.from_numpy(corrupted), torch.from_numpy(fpt), bm=bm, bn=bn)
    if kind == "integer":
        assert np.array_equal(_bits(got.numpy()), _bits(want))
        assert np.array_equal(_bits(fixed.numpy()), _bits(j_fixed))
        assert np.array_equal(_bits(oracle.numpy()), _bits(j_oracle))
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(fixed.numpy(), j_fixed, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(oracle.numpy(), j_oracle, rtol=RTOL, atol=ATOL)
    # the port's scatter on JAX's tiles is JAX's scatter, bit for bit
    same = TDR.scatter_overwrite(torch.from_numpy(corrupted.copy()), torch.from_numpy(want),
                                 torch.from_numpy(fpt), bm=bm, bn=bn)
    assert np.array_equal(_bits(same.numpy()), _bits(j_fixed))
    # untouched tiles keep the corruption
    assert (fixed.numpy() == corrupted).sum() == (4 - min(n_faults, 4)) * bm * bn


def test_scatter_overwrite_writes_in_place_and_skips_padding():
    out = torch.zeros((4, 6))
    tiles = torch.arange(3 * 2 * 3, dtype=torch.float32).reshape(3, 2, 3) + 1
    fpt = torch.tensor([[1, 0], [-1, -1], [0, 1]], dtype=torch.int32)
    res = TDR.scatter_overwrite(out, tiles, fpt, bm=2, bn=3)
    assert res is out
    assert torch.equal(out[2:4, 0:3], tiles[0]) and torch.equal(out[0:2, 3:6], tiles[2])
    assert int((out == 0).sum()) == 12


def test_dppu_recompute_rejects_bad_tables():
    x, w = torch.ones((8, 4)), torch.ones((4, 6))
    with pytest.raises(ValueError, match="outside"):
        TDR.dppu_recompute(x, w, torch.tensor([[4, 0]]), bm=2, bn=3, bk=4)
    with pytest.raises(ValueError, match=r"\(F, 2\)"):
        TDR.dppu_recompute(x, w, torch.tensor([1, 0]), bm=2, bn=3, bk=4)
    with pytest.raises(ValueError, match="tiled"):
        TDR.dppu_recompute(x, w, torch.tensor([[0, 0]]), bm=3, bn=3, bk=4)
    with pytest.raises(ValueError, match="tiled"):
        TOS.os_array_matmul(x, w, *TO.fault_grids(_states(0, 1)[1], 32, 32, 32)[:3], bm=8, bn=6, bk=3)


# --------------------------------------------------------------------------- #
# the AGU
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n_faults,capacity", [(5, 32), (32, 32), (40, 32), (12, 4)])
def test_fault_grids_match_jax(n_faults, capacity):
    """The port's one AGU against both of JAX's (the host loop and the
    traced scatter), at and over capacity."""
    js, ts = _states(7, n_faults)
    want_host = JO.fault_grids(js, 32, 32, capacity)
    want_device = JO.fault_grids_device(js, 32, 32, capacity)
    got = TO.fault_grids(ts, 32, 32, capacity)
    assert TO.fault_grids_device is TO.fault_grids
    for wh, wd, g, dt in zip(want_host, want_device, got, (torch.int32, torch.int32, torch.bool, torch.bool)):
        assert g.dtype == dt
        assert np.array_equal(np.asarray(wh), g.numpy())
        assert np.array_equal(np.asarray(wd), g.numpy())
    assert int(got[3].sum()) == min(n_faults, capacity)


# --------------------------------------------------------------------------- #
# the slice as a whole
# --------------------------------------------------------------------------- #
PIPE = dict(bm=8, bn=128, bk=128)  # M = 256 -> 32 tile rows, N = 256 -> 2 tile columns


@pytest.fixture(scope="module")
def pipeline_cases():
    """JAX's three pipelines at 256x128 @ 128x256, with every fault on a PE
    that owns a tile (columns 0-1), computed once."""
    out = {}
    for dtype in ("f32", "bf16"):
        jx, jw, tx, tw = _operands(4, 256, 128, 256, dtype, "integer")
        for n_faults in (0, 4, 16, 40):
            js, ts = _states(5 + n_faults, n_faults, region_cols=2)
            cfg = JE.HyCAConfig(mode="protected")
            res = {f: np.asarray(getattr(JO, f)(jx, jw, js, cfg, interpret=True, **PIPE))
                   for f in ("faulty_array_matmul", "hyca_protected_matmul_twopass",
                             "hyca_protected_matmul_fused")}
            clean = np.asarray(jnp.matmul(jx.astype(jnp.float32), jw.astype(jnp.float32)))
            out[dtype, n_faults] = (res, clean, tx, tw, ts)
    return out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n_faults", [0, 4, 16, 40])
def test_pipelines_match_jax(pipeline_cases, dtype, n_faults):
    """Bitwise on integer-valued operands.  At or under the DPPU's capacity
    (32) the twopass output is the clean product; at 40 exactly the tiles of
    the 8 unrepaired PEs differ."""
    res, clean, tx, tw, ts = pipeline_cases[dtype, n_faults]
    cfg = TE.HyCAConfig(mode="protected")
    got = {f: getattr(TO, f)(tx, tw, ts, cfg, **PIPE).numpy() for f in res}
    for f, want in res.items():
        assert np.array_equal(_bits(got[f]), _bits(want)), f
    two, fused, faulty = (got[f] for f in ("hyca_protected_matmul_twopass", "hyca_protected_matmul_fused",
                                           "faulty_array_matmul"))
    assert np.array_equal(_bits(two), _bits(fused))
    clean_bits = _bits(clean)
    assert (_bits(faulty) != clean_bits).any() == (n_faults > 0)
    # independent oracle: an output differs iff its PE is beyond the DPPU's
    # capacity in the FPT and its stuck bit is not already at the stuck value
    pe_r = (np.arange(clean.shape[0]) // PIPE["bm"] % 32)[:, None]
    pe_c = (np.arange(clean.shape[1]) // PIPE["bn"] % 32)[None, :]
    expect = np.zeros(clean.shape, bool)
    unrepaired = 0
    for (r, c), b, v in zip(ts.fpt.tolist()[32:], ts.stuck_bit.tolist()[32:], ts.stuck_val.tolist()[32:]):
        if r >= 0:
            unrepaired += 1
            expect |= (pe_r == r) & (pe_c == c) & (((clean_bits >> b) & 1) != v)
    assert unrepaired == max(n_faults - 32, 0)
    assert np.array_equal(_bits(two) != clean_bits, expect)
    assert expect.any() == (n_faults > 32)


@pytest.mark.parametrize("n_faults", [0, 16, 40])
def test_twopass_tile_table_is_jax_order(n_faults):
    """The tile-level FPT the twopass hands the DPPU, in JAX's order
    (``repro/kernels/ops.py``), on a tile grid where each PE owns several
    tiles."""
    _, ts = _states(8, n_faults, region_cols=4)
    cfg = TE.HyCAConfig(mode="protected")
    gm, gn = 70, 40
    want = []
    for i, (r, c) in enumerate(ts.fpt.tolist()):
        if r >= 0 and i < cfg.capacity:
            want += [(ti, tj) for ti in range(r, gm, 32) for tj in range(c, gn, 32)]
    assert TO.tile_fault_table(ts, cfg, gm, gn) == want
    assert len(want) >= min(n_faults, 32) * 2


def test_ref_ft_matmul_matches_jax_with_prune():
    """The tile-granular fused oracle (stuck-at per tile, prune per element)."""
    jx, jw, tx, tw = _operands(9, 64, 32, 48, "f32", "integer")
    js, ts = _states(10, 12, region_rows=4, region_cols=4)
    prune = np.zeros((4, 4), bool)
    prune[1, 2] = prune[3, 0] = True
    jg = JO.fault_grids(js, 4, 4, 6)
    tg = TO.fault_grids(ts, 4, 4, 6)
    want = np.asarray(JR.ft_matmul_ref(jx, jw, *jg, bm=8, bn=16, pe_prune=jnp.asarray(prune)))
    got = TR.ft_matmul_ref(tx, tw, *tg, bm=8, bn=16, pe_prune=torch.from_numpy(prune)).numpy()
    assert np.array_equal(_bits(got), _bits(want))
    c_want = np.asarray(JR.corrupt_f32(jnp.asarray(got), jg[0][0, 0], jg[1][0, 0], jnp.asarray(True)))
    c_got = TR.corrupt_f32(torch.from_numpy(got), tg[0][0, 0], tg[1][0, 0], torch.tensor(True)).numpy()
    assert np.array_equal(_bits(c_got), _bits(c_want))


def test_kernel_tier_on_cpu_builds_and_counts_nothing(monkeypatch):
    """CPU tensors take the plain twins: no library is built or loaded, and
    the launch counters stay where they were."""
    def refuse(*a, **kw):
        raise AssertionError("a CPU call must not build or load a CUDA library")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "_start", refuse)
    before = (TOS.os_array_matmul.launches, TDR.dppu_recompute.launches)
    _, ts = _states(11, 40, region_cols=2)
    _, _, tx, tw = _operands(12, 256, 128, 256, "bf16", "integer")
    TO.hyca_protected_matmul_twopass(tx, tw, ts, TE.HyCAConfig(mode="protected"), **PIPE)
    TO.hyca_protected_matmul_fused(tx, tw, ts, TE.HyCAConfig(mode="protected"), **PIPE)
    assert (TOS.os_array_matmul.launches, TDR.dppu_recompute.launches) == before == (0, 0)


def test_kernel_tier_raises_off_cpu_and_cuda():
    """A tensor neither on the CPU nor on a card gets an error, never a plain
    computation."""
    _, ts = _states(13, 2)
    grids = TO.fault_grids(ts, 32, 32, 32)
    x, w = torch.ones((128, 128), device="meta"), torch.ones((128, 128), device="meta")
    with pytest.raises(ValueError, match="cuda"):
        TOS.os_array_matmul(x, w, *grids[:3])
    with pytest.raises(ValueError, match="cuda"):
        TDR.dppu_recompute(x, w, torch.tensor([[0, 0]], dtype=torch.int32))


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("case", ["row_major_w", "table_T", "x_stride", "x_not_k_major", "x_base",
                                  "w_no_unit_stride", "w_k_stride", "w_n_stride", "w_base"])
def test_tma_layout_takes_the_main_path_layouts_and_raises_on_the_rest(case):
    """``check_tma_layout``: the bf16 tensor-core path reads x (M, K) K-major
    and w either row-major (K, N) (q/up/down) or as the transposed view of an
    (N, K) table (the head), 16-byte aligned with 16-byte strides; anything
    else raises a ValueError that names what is wrong."""
    x, table = _bf16(64, 1024), _bf16(512, 1024)
    ok = {"row_major_w": (x, _bf16(1024, 512)), "table_T": (x, table.T)}
    if case in ok:
        TOS.check_tma_layout("op", *ok[case])
        return
    bad = {
        "x_stride": (_bf16(64, 100), _bf16(100, 512), r"x stride 100 \(200 bytes\)"),
        "x_not_k_major": (_bf16(1024, 64).T, _bf16(1024, 512), r"x needs unit stride along K"),
        "x_base": (_bf16(64, 1032)[:, 1:1025], _bf16(1024, 512), r"x base is not 16-byte aligned"),
        "w_no_unit_stride": (x, _bf16(2048, 1024)[::2, ::2], r"w needs unit stride along K or N"),
        "w_k_stride": (x, _bf16(1024, 516)[:, :512], r"w stride 516 \(1032 bytes\)"),
        "w_n_stride": (x, _bf16(512, 1028)[:, :1024].T, r"w stride 1028 \(2056 bytes\)"),
        "w_base": (x, _bf16(1024, 520)[:, 1:513], r"w base is not 16-byte aligned"),
    }
    xa, wa, msg = bad[case]
    with pytest.raises(ValueError, match=msg):
        TOS.check_tma_layout("op", xa, wa)
