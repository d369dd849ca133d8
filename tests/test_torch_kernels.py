"""The port's kernel modules held against the JAX kernels.

On the CPU ``ft_matmul`` and ``probe_check`` compute their plain versions;
the CUDA kernels themselves are checked against those on the card by
``chip_smoke.py`` and by ``tests/test_torch_cuda.py``.
The JAX side runs as its own tests run it here: Pallas kernels with
``interpret=True``, the fused dispatch on its ``ref`` backend.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.core.ftcontext import build_ftcontext as j_build
from repro.core.redundancy import DPPUConfig as JDPPU
from repro.kernels import dppu_recompute as JDR
from repro.kernels import ft_matmul as JFM
from repro_torch.core import engine as TE
from repro_torch.core.ftcontext import build_ftcontext as t_build
from repro_torch.core.redundancy import DPPUConfig as TDPPU
from repro_torch.kernels import _build
from repro_torch.kernels import dppu_recompute as TDR
from repro_torch.kernels import ft_matmul as TFM
from repro_torch.kernels import mla_prefill as TMP

ROWS, COLS = 4, 4
# (row, col, stuck bit, stuck value): bit 31 stuck-at-1 and -0, an exponent
# bit stuck-at-0, mantissa bits, and a real fault at the origin
FAULTS = [(0, 0, 31, 1), (2, 0, 20, 1), (1, 1, 31, 0), (3, 2, 27, 0), (0, 3, 5, 1)]


def _state(mode="unprotected", dppu=2):
    fpt = np.full((8, 2), -1, np.int32)
    bits = np.zeros(8, np.int32)
    vals = np.zeros(8, np.int32)
    for i, (r, c, b, v) in enumerate(sorted(FAULTS, key=lambda f: (f[1], f[0]))):
        fpt[i], bits[i], vals[i] = (r, c), b, v
    js = JE.FaultState(jnp.asarray(fpt), jnp.asarray(bits), jnp.asarray(vals))
    ts = TE.FaultState(torch.from_numpy(fpt), torch.from_numpy(bits), torch.from_numpy(vals))
    jc = JE.HyCAConfig(ROWS, COLS, JDPPU(size=dppu, group_size=dppu), mode)
    tc = TE.HyCAConfig(ROWS, COLS, TDPPU(size=dppu, group_size=dppu), mode)
    return js, ts, jc, tc


def _plans():
    col_map = np.array([3, 1, 0, 2], np.int32)
    prune = np.zeros((ROWS, COLS), bool)
    prune[2, 1] = prune[1, 3] = True
    return (JE.RepairPlan(jnp.asarray(col_map), jnp.asarray(prune)),
            TE.RepairPlan(torch.from_numpy(col_map), torch.from_numpy(prune)))


@pytest.mark.parametrize("mode", ["protected", "unprotected"])
@pytest.mark.parametrize("with_plan", [False, True])
def test_ft_matmul_ref_matches_pallas_interpret_bitwise(mode, with_plan):
    """Element-granular placement is the Pallas kernel at bm = bn = 1; on
    integer-valued f32 operands every accumulate is exact, so the two agree
    in every bit."""
    js, ts, jc, tc = _state(mode)
    jp, tp = _plans() if with_plan else (None, None)
    m, k, n = 8, 32, 16
    rng = np.random.default_rng(0)
    x = rng.integers(-8, 8, (m, k)).astype(np.float32)
    w = rng.integers(-8, 8, (k, n)).astype(np.float32)
    jftc = j_build(js, jc, dispatch="fused", fused_block=(8, 128, 128), plan=jp)
    bit, val, eff, prune = jftc._kernel_grids(jp)
    pmask = jftc._prune_mask(jp, prune, 1, 1, m, n)
    want = JFM.ft_matmul(jnp.asarray(x), jnp.asarray(w), bit, val, eff, pmask,
                         bm=1, bn=1, bk=k, rows=ROWS, cols=COLS, interpret=True)
    tftc = t_build(ts, tc, dispatch="fused", plan=tp)
    and_g, or_g = tftc.mask_grids(tp)
    got = TFM.ft_matmul(torch.from_numpy(x), torch.from_numpy(w), and_g, or_g)
    assert got.dtype == torch.float32
    assert np.array_equal(np.asarray(want).view(np.int32), got.view(torch.int32).numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strided_w", [False, True])
def test_ft_matmul_ref_matches_jax_fused_ref_backend(dtype, strided_w):
    """Random operands against the JAX fused dispatch's ``ref`` backend
    (f32 accumulate + packed-meta epilogue).  Tolerance: the two sum in
    different orders, so |Δ| <= 1e-5·|v| + 1e-6 (relative where a stuck
    exponent bit scales a value).  ``strided_w`` feeds ``w`` as the
    transposed view of an (N, K) table, as the LM head does."""
    js, ts, jc, tc = _state("unprotected")
    jp, tp = _plans()
    m, k, n = 6, 64, 24
    rng = np.random.default_rng(1)
    x_t = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(dtype)
    table = torch.from_numpy((rng.standard_normal((n, k)) * 0.1).astype(np.float32)).to(dtype)
    w_t = table.T if strided_w else table.T.contiguous()
    assert w_t.is_contiguous() != strided_w
    # the same (bf16-representable) values on the JAX side
    jx = jnp.asarray(x_t.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    jtable = jnp.asarray(table.float().numpy()).astype(jx.dtype)
    jftc = j_build(js, jc, dispatch="fused", plan=jp)
    assert jftc.fused_backend == "ref"
    want = np.asarray(jftc._fused(jx, jtable.T, jp))
    and_g, or_g = t_build(ts, tc, dispatch="fused", plan=tp).mask_grids(tp)
    got = TFM.ft_matmul_ref(x_t, w_t, and_g, or_g).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, equal_nan=True)
    # the forced bits are present in every faulted element of both
    mi = (np.arange(m) % ROWS)[:, None]
    ni = (np.arange(n) % COLS)[None, :]
    a, o = and_g.numpy()[mi, ni], or_g.numpy()[mi, ni]
    bits = got.view(np.int32)
    assert np.array_equal((bits & a) | o, bits)


@pytest.mark.parametrize("faulty", [False, True])
@pytest.mark.parametrize("block", [1, 2, 4])
def test_probe_check_matches_jax_exactly(faulty, block):
    from repro.serving.fault_manager import FaultInjector

    inj = FaultInjector(ROWS, COLS, seed=3)
    if faulty:
        for r, c, b, v in [(0, 0, 31, 1), (1, 2, 30, 1), (2, 3, 0, 0), (3, 1, 12, 1)]:
            inj.inject_at(r, c, bit=b, val=v)
    px, pw = inj.probe_operands(sweep=1)
    n_flagged = 0
    for r0 in range(0, ROWS, block):
        for sign in (1, -1):
            pxb = px[r0:r0 + block]
            ar = inj.corrupted_probe(pxb, sign * pw, row0=r0)
            j_kernel = np.asarray(JDR.probe_check(jnp.asarray(pxb), jnp.asarray(sign * pw),
                                                  jnp.asarray(ar), bk=8, interpret=True))
            j_ref = np.asarray(JDR.probe_check_ref(jnp.asarray(pxb), jnp.asarray(sign * pw),
                                                   jnp.asarray(ar), window=8))
            t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (pxb, sign * pw, ar)]
            t_ref = TDR.probe_check_ref(*t, window=8)
            t_kernel = TDR.probe_check(*t)
            assert t_kernel.dtype == torch.int32 and t_ref.dtype == torch.bool
            assert np.array_equal(j_ref, t_ref.numpy())
            assert np.array_equal(j_kernel, t_kernel.numpy())
            n_flagged += int(t_ref.sum())
    assert (n_flagged > 0) == faulty


def test_cpu_calls_build_nothing_and_count_nothing(monkeypatch):
    """Importing the kernel modules and calling them on CPU tensors neither
    builds nor loads a library, and leaves the launch counters alone."""
    def refuse(*a, **kw):
        raise AssertionError("a CPU call must not build or load a CUDA library")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "_start", refuse)
    before = (TFM.ft_matmul.launches, TDR.probe_check.launches, TMP.mla_prefill.launches)
    _, ts, _, tc = _state()
    and_g, or_g = TE.fault_mask_grids(TE.fault_meta_grid(ts, tc))
    TFM.ft_matmul(torch.ones((3, 5)), torch.ones((5, 7)), and_g, or_g)
    TDR.probe_check(torch.ones((2, 8), dtype=torch.int32), torch.ones((8, 4), dtype=torch.int32),
                    torch.zeros((2, 4), dtype=torch.int32))
    q, kv = torch.ones((1, 4, 2, 192)), torch.ones((1, 4, 2, 256))
    TMP.mla_prefill(q[..., :128], q[..., 128:], kv[..., :128], torch.ones((1, 4, 64)), kv[..., 128:], 0.1)
    assert (TFM.ft_matmul.launches, TDR.probe_check.launches, TMP.mla_prefill.launches) == before == (0, 0, 0)
    assert _build._LIBS == {}
    assert sorted(_build.sources()) == ["dppu_recompute", "ft_matmul", "mla_prefill", "os_array_matmul", "probe_check"]


def test_wrappers_raise_off_cpu_and_cuda():
    """A tensor that is neither on the CPU nor on a card gets an error, never
    a silent plain computation."""
    _, ts, _, tc = _state()
    and_g, or_g = (g.to("meta") for g in TE.fault_mask_grids(TE.fault_meta_grid(ts, tc)))
    with pytest.raises(ValueError, match="cuda"):
        TFM.ft_matmul(torch.ones((2, 3), device="meta"), torch.ones((3, 4), device="meta"), and_g, or_g)
    with pytest.raises(ValueError, match="cuda"):
        TDR.probe_check(*(torch.ones(s, dtype=torch.int32, device="meta") for s in ((1, 8), (8, 4), (1, 4))))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_probe_check_pair_matches_two_jax_probes_exactly(seed):
    """``probe_check_pair`` (the scan step's one launch) equals the OR of two
    ``probe_check_ref`` calls and of two JAX ``probe_check`` calls in
    interpret mode, the second half against ``-pw``, with stuck-at faults on
    every accumulator bit 0-31 in both readbacks; it flags exactly the PEs
    whose readback a fault changed."""
    rng = np.random.default_rng(seed)
    block, k, cols = 4, 8, 16
    px = rng.integers(-4, 8, size=(block, k)).astype(np.int32)
    pw = rng.integers(-4, 8, size=(k, cols)).astype(np.int32)
    ar, ar_neg = px @ pw, px @ -pw
    for bit in range(32):
        mask = np.uint32(1 << bit).view(np.int32)
        for readback in (ar, ar_neg):
            i, j = rng.integers(block), rng.integers(cols)
            readback[i, j] = readback[i, j] | mask if rng.integers(2) else readback[i, j] & ~mask
    changed = (ar != px @ pw) | (ar_neg != px @ -pw)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (px, pw, ar, ar_neg)]
    got = TDR.probe_check_pair(*t)
    ref = TDR.probe_check_ref(t[0], t[1], t[2], window=8) | TDR.probe_check_ref(t[0], -t[1], t[3], window=8)
    jax_flags = [np.asarray(JDR.probe_check(jnp.asarray(px), jnp.asarray(w), jnp.asarray(a), bk=8, interpret=True))
                 for w, a in ((pw, ar), (-pw, ar_neg))]
    assert got.dtype == torch.int32
    assert torch.equal(TDR.probe_check_pair_ref(*t, window=8), ref)
    assert np.array_equal(got.numpy(), ref.numpy().astype(np.int32))
    assert np.array_equal(got.numpy(), (jax_flags[0] | jax_flags[1]).astype(np.int32))
    assert np.array_equal(got.numpy().astype(bool), changed) and changed.any()
