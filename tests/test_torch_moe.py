"""The port's MoE path held against the JAX package.

Same numpy inputs from a seed on both sides.  The JAX side runs as its own
tests run it here: the Pallas ``ft_matmul_batched`` in interpret mode, the
fused dispatch on its ``ref`` backend.  Tolerances:

* integer-valued f32 operands make every accumulate exact, so the kernel
  twin, the einsum dispatches and the epilogue must agree bit for bit;
* on random f32 operands the two sum in different orders: |Δ| <=
  1e-5·(|x|@|w|).  The faults there are on the sign bit and on mantissa
  bits <= 4, which move a one-ulp difference by at most 2^5 ulps; an
  exponent bit would turn it into a jump of the value's size;
* decode logits: bf16 |Δ| <= 2^-4 with a mean |Δ| <= 4e-3 (the reasons are
  in ``test_torch_models.py``), with low-mantissa faults (bits 16-18); f32
  |Δ| <= 1e-4 with a mean |Δ| <= 2e-6, with exponent-bit faults.  Without
  faults the f32 logits differ by ~1.2e-7 (summation order).  The stuck-at-1
  on exponent bit 25 multiplies each element it hits by 16, in each of the
  two layers, so that difference can grow 256-fold: 3.1e-5 is the worst
  seen (granite, all layers protected), and 1e-4 leaves a 3x margin.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.core import engine as JE
from repro.core import ftcontext as JF
from repro.core.redundancy import DPPUConfig as JDPPU
from repro.kernels import ft_matmul as JFM
from repro.models import lm as JL
from repro.models import moe as JM
from repro.serving import FaultTolerantServer as JServer
from repro.serving import ModelBundle as JBundle
from repro.serving import ServerConfig as JConfig
from repro.serving.fault_manager import FaultInjector as JInjector
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import engine as TE
from repro_torch.core import ftcontext as TF
from repro_torch.core.redundancy import DPPUConfig as TDPPU
from repro_torch.kernels import ft_matmul as TFM
from repro_torch.models import lm as TL
from repro_torch.models import moe as TM
from repro_torch.obs.fallbacks import reset_site_fallbacks, site_fallback_total
from repro_torch.serving import FaultTolerantServer, ModelBundle, ServerConfig
from repro_torch.serving.fault_manager import FaultInjector
from repro_torch.serving.scheduler import DECODE

GRANITE, DEEPSEEK = "granite-moe-3b-a800m", "deepseek-moe-16b"
# (row, col, stuck bit, stuck value), 5 faults over capacity 2 or 3
FAULTS = [(0, 0, 31, 1), (2, 1, 30, 1), (1, 2, 20, 0), (3, 3, 24, 1), (0, 3, 6, 0)]
# sign and low-mantissa bits only: for random operands (module docstring)
FAULTS_RAND = [(0, 0, 31, 1), (2, 1, 4, 1), (1, 2, 31, 0), (3, 3, 2, 1), (0, 3, 3, 0)]


def _state(faults, max_faults=16):
    fpt = np.full((max_faults, 2), -1, np.int32)
    bits = np.zeros(max_faults, np.int32)
    vals = np.zeros(max_faults, np.int32)
    for i, (r, c, b, v) in enumerate(sorted(faults, key=lambda f: (f[1], f[0]))):
        fpt[i], bits[i], vals[i] = (r, c), b, v
    return (JE.FaultState(jnp.asarray(fpt), jnp.asarray(bits), jnp.asarray(vals)),
            TE.FaultState(torch.from_numpy(fpt), torch.from_numpy(bits), torch.from_numpy(vals)))


def _plans(rows, cols):
    col_map = np.roll(np.arange(cols, dtype=np.int32), 1)
    prune = np.zeros((rows, cols), bool)
    prune[1, cols - 1] = prune[rows - 1, 0] = True
    return (JE.RepairPlan(jnp.asarray(col_map), jnp.asarray(prune)),
            TE.RepairPlan(torch.from_numpy(col_map), torch.from_numpy(prune)))


def _contexts(faults, mode, dispatch, *, rows=4, cols=4, dppu=3, with_plan=False, fraction=1.0):
    js, ts = _state(faults)
    jp, tp = _plans(rows, cols) if with_plan else (None, None)
    jc = JE.HyCAConfig(rows, cols, JDPPU(size=dppu, group_size=dppu), mode)
    tc = TE.HyCAConfig(rows, cols, TDPPU(size=dppu, group_size=dppu), mode)
    return (JF.build_ftcontext(js, jc, dispatch=dispatch, plan=jp,
                               policy=JF.ProtectPolicy(layer_fraction=fraction)),
            TF.build_ftcontext(ts, tc, dispatch=dispatch, plan=tp,
                               policy=TF.ProtectPolicy(layer_fraction=fraction)))


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


# --------------------------------------------------------------------------- #
# the kernel's plain twin against the Pallas kernel
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("state", ["off", "protected", "unprotected"])
@pytest.mark.parametrize("with_plan", [False, True])
@pytest.mark.parametrize("m", [3, 12])
def test_ft_matmul_batched_ref_matches_pallas_interpret_bitwise(state, with_plan, m):
    """Element placement is the Pallas kernel at bm = bn = 1.  On an 8-row
    array, M = 3 and M = 12 are not multiples of rows: a kernel that folded
    the expert into the PE row would put expert 1's first row on PE row 3
    (or 4), not 0, and fail here."""
    rows, cols, e, k, n = 8, 4, 3, 16, 8
    faults = [] if state == "off" else [(0, 0, 31, 1), (1, 1, 22, 0), (3, 2, 31, 0), (4, 3, 20, 1),
                                        (2, 0, 27, 1), (7, 1, 25, 1)]
    mode = "unprotected" if state == "unprotected" else "protected"
    jftc, tftc = _contexts(faults, mode, "fused", rows=rows, cols=cols, dppu=2, with_plan=with_plan)
    jp, tp = jftc.plan, tftc.plan
    rng = np.random.default_rng(m)
    x = rng.integers(-8, 8, (e, m, k)).astype(np.float32)
    w = rng.integers(-8, 8, (e, k, n)).astype(np.float32)
    bit, val, eff, prune = jftc._kernel_grids(jp)
    pmask = jftc._prune_mask(jp, prune, 1, 1, m, n)
    want = JFM.ft_matmul_batched(jnp.asarray(x), jnp.asarray(w), bit, val, eff, pmask,
                                 bm=1, bn=1, bk=k, rows=rows, cols=cols, interpret=True)
    and_g, or_g = tftc.mask_grids(tp)
    got = TFM.ft_matmul_batched(torch.from_numpy(x), torch.from_numpy(w), and_g, or_g)
    assert got.dtype == torch.float32 and got.shape == (e, m, n)
    assert np.array_equal(_bits(want), got.view(torch.int32).numpy())
    # the PE map repeats per expert: each expert alone is the 2-D kernel twin
    for i in range(e):
        one = TFM.ft_matmul_ref(torch.from_numpy(x[i]), torch.from_numpy(w[i]), and_g, or_g)
        assert torch.equal(one.view(torch.int32), got[i].view(torch.int32))
    if state != "off":
        assert not np.array_equal(_bits(want), _bits(np.matmul(x, w)))


def test_ft_matmul_batched_wrapper_checks(monkeypatch):
    """CPU tensors compute the twin and count no launch; a tensor on neither
    the CPU nor a card raises, and so do bad shapes."""
    from repro_torch.kernels import _build

    def refuse(*a, **kw):
        raise AssertionError("a CPU call must not build or load a CUDA library")

    monkeypatch.setattr(_build, "load", refuse)
    _, ts = _state(FAULTS)
    and_g, or_g = TE.fault_mask_grids(TE.fault_meta_grid(ts, TE.HyCAConfig(4, 4, mode="unprotected")))
    before = TFM.ft_matmul_batched.launches
    TFM.ft_matmul_batched(torch.ones((2, 3, 5)), torch.ones((2, 5, 7)), and_g, or_g)
    assert TFM.ft_matmul_batched.launches == before == 0
    meta = [g.to("meta") for g in (and_g, or_g)]
    with pytest.raises(ValueError, match="cuda"):
        TFM.ft_matmul_batched(torch.ones((2, 3, 5), device="meta"), torch.ones((2, 5, 7), device="meta"), *meta)


# --------------------------------------------------------------------------- #
# FTContext.einsum
# --------------------------------------------------------------------------- #
SPECS = {"becd,edf->becf": ((2, 4, 3, 12), (4, 12, 10)),
         "becf,efd->becd": ((3, 4, 1, 10), (4, 10, 12))}


@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("dispatch", ["plain", "twopass", "fused"])
@pytest.mark.parametrize("mode", ["protected", "unprotected"])
@pytest.mark.parametrize("with_plan", [False, True])
def test_einsum_matches_jax_bitwise(spec, dispatch, mode, with_plan):
    jftc, tftc = _contexts(FAULTS, mode, dispatch, with_plan=with_plan)
    sx, sw = SPECS[spec]
    rng = np.random.default_rng(0)
    x = rng.integers(-8, 8, sx).astype(np.float32)
    w = rng.integers(-8, 8, sw).astype(np.float32)
    a = np.asarray(jftc.einsum(spec, jnp.asarray(x), jnp.asarray(w), site="moe.expert"))
    b = tftc.einsum(spec, torch.from_numpy(x), torch.from_numpy(w), site="moe.expert")
    assert b.dtype == torch.float32 and b.shape == a.shape
    assert np.array_equal(_bits(a), b.numpy().view(np.int32))
    if dispatch != "plain":
        assert not np.array_equal(_bits(a), _bits(np.einsum(spec, x, w)))
    # bf16 operands (small integers are exact in bf16): the result is bf16.
    # The JAX fused einsum cannot run bf16 on the CPU (ROADMAP C3), so its
    # twopass, which it holds bitwise equal to its fused, is the reference
    if dispatch == "fused":
        jftc, _ = _contexts(FAULTS, mode, "twopass", with_plan=with_plan)
    a = np.asarray(jftc.einsum(spec, jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                               site="moe.expert"))
    b = tftc.einsum(spec, torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w).to(torch.bfloat16),
                    site="moe.expert")
    assert b.dtype == torch.bfloat16
    assert np.array_equal(a.astype(np.float32), b.float().numpy())


@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("dispatch", ["twopass", "fused"])
@pytest.mark.parametrize("mode", ["protected", "unprotected"])
def test_einsum_random_f32_within_tolerance(spec, dispatch, mode):
    jftc, tftc = _contexts(FAULTS_RAND, mode, dispatch, with_plan=True)
    sx, sw = SPECS[spec]
    rng = np.random.default_rng(3)
    x = rng.standard_normal(sx).astype(np.float32)
    w = rng.standard_normal(sw).astype(np.float32)
    a = np.asarray(jftc.einsum(spec, jnp.asarray(x), jnp.asarray(w), site="moe.expert"), np.float64)
    b = tftc.einsum(spec, torch.from_numpy(x), torch.from_numpy(w), site="moe.expert").double().numpy()
    scale = np.einsum(spec, np.abs(x).astype(np.float64), np.abs(w).astype(np.float64))
    assert (np.abs(a - b) <= 1e-5 * scale).all()


def test_einsum_validates_spec_first_and_respects_policy():
    _, tftc = _contexts(FAULTS, "unprotected", "fused")
    for ctx in (tftc, TF.FTContext(None, tftc.hyca, dispatch="plain")):
        with pytest.raises(ValueError, match="expert-matmul patterns"):
            ctx.einsum("bd,df->bf", None, None, site="moe.expert")
    x, w = torch.ones((1, 2, 1, 3)), torch.ones((2, 3, 4))
    only = TF.FTContext(tftc.state, tftc.hyca, TF.ProtectPolicy(sites=frozenset({"ffn"})), "fused")
    assert torch.equal(only.einsum("becd,edf->becf", x, w, site="moe.expert"),
                       torch.einsum("becd,edf->becf", x, w))


def test_einsum_int_dtype_falls_back_and_is_recorded():
    reset_site_fallbacks()
    jftc, tftc = _contexts(FAULTS, "unprotected", "fused")
    rng = np.random.default_rng(2)
    x = rng.integers(-100, 100, (2, 3, 2, 16)).astype(np.int8)
    w = rng.integers(-100, 100, (3, 16, 8)).astype(np.int8)
    with pytest.warns(RuntimeWarning, match="int-dtype-kernel"):
        b = tftc.einsum("becd,edf->becf", torch.from_numpy(x), torch.from_numpy(w), site="moe.expert")
    a = np.asarray(jftc.einsum("becd,edf->becf", jnp.asarray(x), jnp.asarray(w), site="moe.expert"))
    assert b.dtype == torch.int8
    assert np.array_equal(a, b.numpy())
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # warned once per (site, reason)
        tftc.einsum("becd,edf->becf", torch.from_numpy(x), torch.from_numpy(w), site="moe.expert")
    assert site_fallback_total() == {("moe.expert", "int-dtype-kernel"): 2}
    reset_site_fallbacks()


# --------------------------------------------------------------------------- #
# routing
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("top_k,capacity", [(2, 1), (3, 2), (8, 1)])
def test_topk_dispatch_matches_jax(tied, top_k, capacity):
    """Same gates, same dispatch bit for bit, same combine.  Tied gates (a
    few levels over 12 experts) put equal values across the k-th boundary:
    the lower expert index must win, as in ``jax.lax.top_k``."""
    rng = np.random.default_rng(top_k)
    shape = (3, 4, 12)
    if tied:
        gates = np.array([0.05, 0.1, 0.2], np.float32)[rng.integers(0, 3, shape)]
    else:
        gates = rng.dirichlet(np.ones(12), shape[:2]).astype(np.float32)
    jd, jc = JM._topk_dispatch(jnp.asarray(gates), top_k, capacity)
    td, tc = TM._topk_dispatch(torch.from_numpy(gates), top_k, capacity)
    assert td.shape == (3, 4, 12, capacity)
    assert np.array_equal(_bits(jd), td.numpy().view(np.int32))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=0)
    if tied:  # the tie really sits on the boundary somewhere
        srt = np.sort(gates, -1)[..., ::-1]
        assert (srt[..., top_k - 1] == srt[..., top_k]).any()


def _moe_params(cfg, seed=0):
    jp = JM.moe_init(jax.random.key(seed), cfg)
    return jp, {k: (TL.tree_map(lambda a: torch.from_numpy(np.array(a)), v) if isinstance(v, dict)
                    else torch.from_numpy(np.array(v))) for k, v in jp.items()}


@pytest.mark.parametrize("arch", [GRANITE, DEEPSEEK])
@pytest.mark.parametrize("seq,group", [(1, 2048), (4, 2)])
@pytest.mark.parametrize("pad_to", [0, 12])
def test_moe_forward_matches_jax(arch, seq, group, pad_to):
    """moe_forward in f32 under a fused context carrying over-capacity
    faults: out within 2e-5 (summation order), aux within 1e-6.  seq 4 in
    groups of 2 runs the group loop; pad_to 12 pads 8 experts to 12, whose
    router logits are masked."""
    jcfg = dataclasses.replace(j_smoke(arch).moe, group_size=group, pad_to=pad_to)
    tcfg = TM.MoEConfig(**dataclasses.asdict(jcfg))
    jp, tp = _moe_params(jcfg)
    jftc, tftc = _contexts(FAULTS, "protected", "fused")
    x = np.random.default_rng(4).standard_normal((3, seq, jcfg.d_model)).astype(np.float32)
    jo, ja = JM.moe_forward(jnp.asarray(x), jp, jcfg, ftc=jftc)
    to, ta = TM.moe_forward(torch.from_numpy(x), tp, tcfg, ftc=tftc)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=2e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


def test_padded_experts_are_never_routed(monkeypatch):
    """granite's 40 experts padded to 48: at decode (capacity 1) every token
    takes 8 real experts and no padded one, though all 48 are computed."""
    cfg = get_config(GRANITE).moe
    assert (cfg.n_experts, cfg.n_padded, cfg.top_k, cfg.d_expert) == (40, 48, 8, 512)
    small = dataclasses.replace(cfg, d_model=16, d_expert=8)
    p = TM.moe_init(torch.Generator().manual_seed(0), small, device="cpu")
    assert p["gate"].shape == (48, 16, 8) and p["down"].shape == (48, 8, 16)
    seen = []
    real = TM._topk_dispatch

    def recording(gates, top_k, capacity):
        out = real(gates, top_k, capacity)
        seen.append(out[0])
        return out

    monkeypatch.setattr(TM, "_topk_dispatch", recording)
    out, _ = TM.moe_forward(torch.randn((4, 1, 16), generator=torch.Generator().manual_seed(1)), p, small)
    (d,) = seen
    assert out.shape == (4, 1, 16) and d.shape == (4, 1, 48, 1)
    assert d[:, :, 40:].sum() == 0 and d.sum() == 4 * 8


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #
FAULTS_DECODE = {torch.float32: [(0, 1, 22, 1), (1, 2, 30, 0), (2, 3, 25, 1)],
                 torch.bfloat16: [(0, 1, 18, 1), (1, 2, 17, 0), (2, 3, 16, 1)]}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-4}
MEAN_TOL = {torch.float32: 2e-6, torch.bfloat16: 4e-3}


@pytest.fixture(scope="module")
def jax_params():
    return {arch: JL.init_params(jax.random.key(0), j_smoke(arch)) for arch in (GRANITE, DEEPSEEK)}


def _numpy_tree(params):
    return jax.tree.map(np.asarray, params)


def test_params_from_numpy_with_dense_blocks(jax_params):
    tree = _numpy_tree(jax_params[DEEPSEEK])
    p = TL.params_from_numpy(tree, "cpu")
    cfg = get_smoke_config(DEEPSEEK)
    assert len(p["blocks"]) == cfg.n_layers - cfg.first_k_dense and len(p["dense_blocks"]) == 1
    assert p["dense_blocks"][0]["ffn"]["up"].shape == (cfg.d_model, cfg.dense_d_ff)
    assert p["blocks"][0]["moe"]["gate"].shape == (8, cfg.d_model, 32)
    back = {k: v.numpy() for k, v in p.items() if k not in ("blocks", "dense_blocks")}
    for key in ("blocks", "dense_blocks"):
        back[key] = jax.tree.map(lambda *xs: np.stack(xs), *[
            jax.tree.map(lambda t: t.numpy(), blk) for blk in p[key]])
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the port's own init has the same layout
    mine = TL.init_params(torch.Generator().manual_seed(0), cfg)
    shapes = jax.tree.map(lambda t: tuple(t.shape), {k: v for k, v in p.items()})
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == shapes
    cache = TL.init_cache(cfg, 2, 8, device="cpu")
    assert len(cache["attn"]) == 2 and len(cache["attn_dense"]) == 1


def _decode_contexts(faults, mode="protected", layer_fraction=1.0, dispatch="fused"):
    js, ts = _state(faults)
    jc = JE.HyCAConfig(4, 4, JDPPU(size=1, group_size=1), mode)
    tc = TE.HyCAConfig(4, 4, TDPPU(size=1, group_size=1), mode)
    return (JF.build_ftcontext(js, jc, dispatch=dispatch, policy=JF.ProtectPolicy(layer_fraction=layer_fraction)),
            TF.build_ftcontext(ts, tc, dispatch=dispatch, policy=TF.ProtectPolicy(layer_fraction=layer_fraction)))


@pytest.mark.parametrize("arch", [GRANITE, DEEPSEEK])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layer_fraction", [1.0, 0.5])
def test_decode_step_matches_jax(jax_params, arch, dtype, layer_fraction):
    """Six cached decode steps with over-capacity faults (capacity 1, three
    faults on PE rows < the batch of 3), the port's fused dispatch: logits
    and every cache part within the module's tolerances.

    The KV cache has the model's dtype: a bf16 cache in the f32 run rounds
    a one-ulp f32 difference into a one-bf16-ulp jump now and then, which a
    stuck exponent bit then amplifies past 2e-5 (seen on deepseek).  The
    JAX reference runs its fused dispatch in f32 and its twopass in bf16,
    which its fused cannot run on the CPU (ROADMAP C3)."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jcfg = dataclasses.replace(j_smoke(arch), dtype=jdt)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    jp = jax_params[arch]
    tparams = TL.cast_params(TL.params_from_numpy(_numpy_tree(jp), "cpu"), dtype)
    faults = FAULTS_DECODE[dtype]
    jftc, tftc = _decode_contexts(faults, layer_fraction=layer_fraction)
    if dtype == torch.bfloat16:
        jftc, _ = _decode_contexts(faults, layer_fraction=layer_fraction, dispatch="twopass")
    jcache = JL.init_cache(jcfg, 3, 16, jdt)
    tcache = TL.init_cache(tcfg, 3, 16, dtype, device="cpu")
    jstep = jax.jit(JL.decode_step, static_argnums=(1,))
    rng = np.random.default_rng(1)
    for _ in range(6):
        tok = rng.integers(0, tcfg.vocab, (3, 1)).astype(np.int32)
        jl, jcache = jstep(jp, jcfg, jcache, {"token": jnp.asarray(tok)}, ftc=jftc)
        tl, tcache = TL.decode_step(tparams, tcfg, tcache, {"token": torch.from_numpy(tok)}, ftc=tftc)
        assert tl.shape == (3, 1, tcfg.padded_vocab) and tl.dtype == dtype
        a = np.asarray(jl.astype(jnp.float32))[..., :tcfg.vocab]
        b = tl.float().numpy()[..., :tcfg.vocab]
        np.testing.assert_allclose(b, a, rtol=0, atol=TOL[dtype])
        assert np.abs(b - a).mean() <= MEAN_TOL[dtype]
    assert tcache.keys() == jcache.keys()
    for part in tcache:
        for i, layer in enumerate(tcache[part]):
            for name in ("k", "v"):
                np.testing.assert_allclose(layer[name].float().numpy(),
                                           np.asarray(jcache[part][name][i].astype(jnp.float32)),
                                           rtol=0, atol=TOL[dtype])
            assert np.array_equal(layer["idx"].numpy(), np.asarray(jcache[part]["idx"][i]))


@pytest.mark.parametrize("arch", [GRANITE, DEEPSEEK])
@pytest.mark.parametrize("dispatch", ["plain", "twopass", "fused"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_protected_within_capacity_is_bitexact_with_off(jax_params, arch, dispatch, dtype):
    """At most capacity faults (exponent bits included), protected: every
    dispatch gives the off run's logits bit for bit over three steps; the
    same faults unprotected reach the logits."""
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    tparams = TL.cast_params(TL.params_from_numpy(_numpy_tree(jax_params[arch]), "cpu"), dtype)
    faults = [(0, 1, 30, 1), (2, 2, 31, 0)]
    js, ts = _state(faults)
    hyca = TE.HyCAConfig(4, 4, TDPPU(size=3, group_size=3), "protected")
    assert hyca.capacity == 2
    prot = TF.build_ftcontext(ts, hyca, dispatch=dispatch)
    off = prot.with_state(TE.empty_fault_state(16))
    bad = TF.build_ftcontext(ts, dataclasses.replace(hyca, mode="unprotected"), dispatch=dispatch)
    outs = {}
    for name, ctx in (("prot", prot), ("off", off), ("bad", bad)):
        cache = TL.init_cache(tcfg, 3, 8, device="cpu")
        logits = []
        for tok in ([[5], [6], [7]], [[1], [2], [3]], [[9], [8], [4]]):
            lg, cache = TL.decode_step(tparams, tcfg, cache, {"token": torch.tensor(tok)}, ftc=ctx)
            logits.append(lg)
        outs[name] = torch.cat(logits)
    assert torch.equal(outs["prot"], outs["off"])
    assert (dispatch == "plain") == torch.equal(outs["bad"], outs["off"])


# --------------------------------------------------------------------------- #
# the server
# --------------------------------------------------------------------------- #
BASE = dict(arch=GRANITE, n_slots=4, smax=32, rows=4, cols=4, dppu_size=4, dispatch="fused", seed=0)
BIST = [(0, 1, 30, 1), (1, 2, 31, 0), (3, 3, 20, 1)]  # 3 <= capacity 4
GAP = 1e-4


def _trace():
    rng = np.random.default_rng(42)
    return [{"step": 0, "prompt": rng.integers(0, 512, size=4), "max_new_tokens": 6} for _ in range(6)]


@pytest.fixture(scope="module")
def bundles():
    jb = JBundle(JConfig(mode="off", **BASE), lm=dataclasses.replace(j_smoke(GRANITE), dtype=jnp.float32))
    tb = ModelBundle(ServerConfig(mode="off", device="cpu", **BASE),
                     lm=dataclasses.replace(get_smoke_config(GRANITE), dtype=torch.float32),
                     params=TL.params_from_numpy(_numpy_tree(jb.params), "cpu"))
    return jb, tb


@pytest.mark.parametrize("mode,kw,faults", [
    ("protected", {"fault_rate": 0.25}, BIST),
    ("unprotected", {}, [(2, 0, 22, 1)]),
], ids=["protected", "unprotected"])
def test_server_matches_jax(bundles, mode, kw, faults):
    """The granite smoke server against the JAX server on one trace: the
    same events, scan flags, fault sets, summary and tokens.  Every sampled
    row's top-2 logit gap exceeds 1e-4, so a token mismatch is never a tie."""
    jb, tb = bundles
    jinj = JInjector(4, 4, seed=BASE["seed"] + 1)
    tinj = FaultInjector(4, 4, seed=BASE["seed"] + 1)
    for r, c, b, v in faults:
        jinj.inject_at(r, c, bit=b, val=v)
        tinj.inject_at(r, c, bit=b, val=v)
    jsrv = JServer(JConfig(mode=mode, **BASE, **kw), bundle=jb, injector=jinj)
    jsum = jsrv.run(_trace(), max_steps=64)
    tsrv = FaultTolerantServer(ServerConfig(mode=mode, device="cpu", **BASE, **kw), bundle=tb, injector=tinj)
    seen = []
    step_fn = tb.step_fn

    def recording(*a, **k):
        logits, cache = step_fn(*a, **k)
        used = [s.request is not None and (s.phase == DECODE or s.pos == s.request.prompt_len - 1)
                for s in tsrv.scheduler.slots]
        seen.append((logits[:, -1, :512].clone(), used))
        return logits, cache

    tb.step_fn = recording
    try:
        tsum = tsrv.run(_trace(), max_steps=64)
    finally:
        del tb.step_fn
    assert [(e.kind, e.step, e.data) for e in tsrv.log.events] == \
        [(e.kind, e.step, e.data) for e in jsrv.log.events]
    assert [r.scan_ok for r in tsrv.metrics.steps] == [r.scan_ok for r in jsrv.metrics.steps]
    for attr in ("confirmed_coords", "repaired_coords", "retired_coords"):
        assert getattr(tsrv.manager, attr)() == getattr(jsrv.manager, attr)()
    volatile = {"wall_s", "tokens_per_s", "host_phase_ms"}
    assert {k: v for k, v in tsum.items() if k not in volatile} == \
        {k: v for k, v in jsum.items() if k not in volatile}
    gaps = [float((top[:, 0] - top[:, 1])[torch.tensor(u)].min())
            for top, u in ((torch.topk(lg, 2, dim=-1).values, u) for lg, u in seen) if any(u)]
    assert gaps and min(gaps) > GAP, f"top-2 logit gap {min(gaps)} within the tolerance"
    jt, tt = jsrv.completions_by_rid(), tsrv.completions_by_rid()
    assert jt.keys() == tt.keys() and len(tt) == 6
    for rid in jt:
        assert np.array_equal(jt[rid], tt[rid]), rid


def test_reset_zeroes_every_cache_part():
    cfg = ServerConfig(arch=DEEPSEEK, device="cpu", n_slots=2, smax=4)
    b = ModelBundle(cfg, lm=get_smoke_config(DEEPSEEK))
    cache = b.fresh_cache()
    for part in cache.values():
        for layer in part:
            for t in layer.values():
                t.fill_(1)
    b.reset_fn(cache, 1)
    for part in ("attn", "attn_dense"):
        for layer in cache[part]:
            for t in layer.values():
                assert (t[1] == 0).all() and (t[0] == 1).all()
