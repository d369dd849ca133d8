"""The port's FTContext held against the JAX FTContext.

Integer-valued operands make every float32 accumulate exact, so plain,
twopass and fused dispatch must match the JAX package bit for bit on the
same fault state and repair plan.
"""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.core import ftcontext as JF
from repro.core.redundancy import DPPUConfig as JDPPU
from repro.models import lm as JL
from repro_torch.core import engine as TE
from repro_torch.core import ftcontext as TF
from repro_torch.core.redundancy import DPPUConfig as TDPPU
from repro_torch.models import lm as TL
from repro_torch.obs.fallbacks import reset_site_fallbacks, site_fallback_total

ROWS, COLS, DPPU = 4, 4, 3
FAULTS = [(0, 0, 31, 1), (2, 1, 30, 1), (1, 2, 20, 0), (3, 3, 24, 1), (0, 3, 6, 0)]


def _state(faults, max_faults=16):
    fpt = np.full((max_faults, 2), -1, np.int32)
    bits = np.zeros(max_faults, np.int32)
    vals = np.zeros(max_faults, np.int32)
    for i, (r, c, b, v) in enumerate(sorted(faults, key=lambda f: (f[1], f[0]))):
        fpt[i], bits[i], vals[i] = (r, c), b, v
    return (JE.FaultState(jnp.asarray(fpt), jnp.asarray(bits), jnp.asarray(vals)),
            TE.FaultState(torch.from_numpy(fpt), torch.from_numpy(bits), torch.from_numpy(vals)))


def _plans():
    col_map = np.array([1, 3, 0, 2], np.int32)
    prune = np.zeros((ROWS, COLS), bool)
    prune[3, 3] = True
    return (JE.RepairPlan(jnp.asarray(col_map), jnp.asarray(prune)),
            TE.RepairPlan(torch.from_numpy(col_map), torch.from_numpy(prune)))


def _contexts(faults, mode, dispatch, with_plan=False, **kw):
    js, ts = _state(faults)
    jp, tp = _plans() if with_plan else (None, None)
    jc = JE.HyCAConfig(ROWS, COLS, JDPPU(size=DPPU, group_size=DPPU), mode)
    tc = TE.HyCAConfig(ROWS, COLS, TDPPU(size=DPPU, group_size=DPPU), mode)
    return (JF.build_ftcontext(js, jc, dispatch=dispatch, plan=jp, **kw),
            TF.build_ftcontext(ts, tc, dispatch=dispatch, plan=tp, **kw))


def _int_operands(shape_x, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(-8, 8, shape_x).astype(np.float32),
            rng.integers(-8, 8, (shape_x[-1], n)).astype(np.float32))


@pytest.mark.parametrize("dispatch", ["plain", "twopass", "fused"])
@pytest.mark.parametrize("mode", ["protected", "unprotected"])
@pytest.mark.parametrize("with_plan", [False, True])
def test_dispatch_matches_jax_bitwise(dispatch, mode, with_plan):
    jftc, tftc = _contexts(FAULTS, mode, dispatch, with_plan)
    x, w = _int_operands((2, 5, 12), 10)
    for site in ("attn.qkv", "head"):
        a = np.asarray(jftc.matmul(jnp.asarray(x), jnp.asarray(w), site=site))
        b = tftc.matmul(torch.from_numpy(x), torch.from_numpy(w), site=site)
        assert b.shape == (2, 5, 10) and b.dtype == torch.float32
        assert np.array_equal(a.view(np.int32), b.numpy().view(np.int32))
    # bf16 operands (small integers are exact in bf16): the result is bf16
    xb, wb = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w).to(torch.bfloat16)
    a = np.asarray(jftc.matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), site="ffn"))
    b = tftc.matmul(xb, wb, site="ffn")
    assert b.dtype == torch.bfloat16
    assert np.array_equal(a.astype(np.float32), b.float().numpy())


@pytest.mark.parametrize("dispatch", ["plain", "twopass", "fused"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_protected_within_capacity_is_bitexact_with_off(dispatch, dtype):
    """Mode as data: the fault-free (empty) table and <= capacity faults run
    the same dispatch and give the same bits, on random operands."""
    capacity = TE.HyCAConfig(ROWS, COLS, TDPPU(size=DPPU, group_size=DPPU)).capacity
    assert capacity == 2
    _, faulty = _contexts(FAULTS[:capacity], "protected", dispatch)
    off = faulty.with_state(TE.empty_fault_state(16))
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 2, 16)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal((16, 24)).astype(np.float32)).to(dtype)
    a = faulty.matmul(x, w, site="ffn")
    b = off.matmul(x, w, site="ffn")
    assert torch.equal(a, b)
    # and the same faults unprotected are visible (stuck bits >= 20 survive bf16)
    bad = dataclasses.replace(faulty, hyca=dataclasses.replace(faulty.hyca, mode="unprotected"))
    if dispatch != "plain":
        assert not torch.equal(bad.matmul(x, w, site="ffn"), b)


@pytest.mark.parametrize("fraction", [0.0, 0.25, 0.5, 0.75, 1.0])
@pytest.mark.parametrize("n_layers", [1, 2, 5, 24])
def test_layer_fraction_splits_match_jax(fraction, n_layers):
    pol = JF.ProtectPolicy(layer_fraction=fraction)
    tpol = TF.ProtectPolicy(layer_fraction=fraction)
    jftc, tftc = _contexts(FAULTS, "protected", "fused")
    jftc = JF.FTContext(jftc.state, jftc.hyca, pol, "fused")
    tftc = TF.FTContext(tftc.state, tftc.hyca, tpol, "fused")
    j = [(lo, hi, fc is not None) for lo, hi, fc in JL._layer_splits(n_layers, jftc)]
    t = [(lo, hi, fc is not None) for lo, hi, fc in TL._layer_splits(n_layers, tftc)]
    assert j == t
    assert tpol.n_protected_layers(n_layers) == pol.n_protected_layers(n_layers)
    assert TL._layer_splits(n_layers, None) == [(0, n_layers, None)]


def test_site_policy_and_validation():
    _, tftc = _contexts(FAULTS, "unprotected", "fused")
    only = TF.FTContext(tftc.state, tftc.hyca, TF.ProtectPolicy(sites=frozenset({"ffn"})), "fused")
    assert only.protects("ffn") and not only.protects("head")
    with pytest.raises(ValueError, match="unknown site"):
        only.protects("nope")
    with pytest.raises(ValueError, match="unknown protection sites"):
        TF.ProtectPolicy(sites=frozenset({"nope"}))
    with pytest.raises(ValueError, match="unknown dispatch"):
        TF.build_ftcontext(None, tftc.hyca, dispatch="pallas")
    _, bad = _state([(0, 0, 1, 1)])
    bad.fpt[0, 1] = COLS
    with pytest.raises(ValueError, match="out of bounds"):
        TF.build_ftcontext(bad, tftc.hyca)
    with pytest.raises(ValueError, match="expert-matmul patterns"):
        tftc.einsum("bd,df->bf", None, None, site="moe.expert")
    # the ABFT lanes are ported: without policy.abft the call is matmul's
    # and carries no lanes, with it both lanes come back
    x, w = _int_operands((3, 12), 10)
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    out, chk_row, chk_col = tftc.abft_matmul(x, w, site="ffn")
    assert chk_row is None and chk_col is None and torch.equal(out, tftc.matmul(x, w, site="ffn"))
    lanes = TF.build_ftcontext(tftc.state, tftc.hyca, policy=TF.ProtectPolicy(abft=True), dispatch="fused")
    out, chk_row, chk_col = lanes.abft_matmul(x, w, site="ffn", wc=TE.abft_encode(w))
    assert chk_row.shape == (1, 10) and chk_col.shape == (3, 1)
    with pytest.raises(NotImplementedError):
        TF.build_ftcontext(None, tftc.hyca, fused_block=(8, 128, 128))
    with pytest.raises(ValueError, match="needs counters"):
        tftc.accumulate()
    with pytest.raises(ValueError, match="call ledger"):
        tftc.increment()


@pytest.mark.parametrize("dispatch", ["plain", "twopass", "fused"])
@pytest.mark.parametrize("mode", ["protected", "unprotected"])
def test_fused_block_auto_is_the_fixed_plan(dispatch, mode):
    """``fused_block="auto"``, the reference's default, builds the context
    ``None`` builds (the fixed launch plan ``ft_plan``): bit-identical
    outputs, equal to JAX's default context; an explicit block and
    ``autotune_shapes`` still raise."""
    jftc, none = _contexts(FAULTS, mode, dispatch)
    _, auto = _contexts(FAULTS, mode, dispatch, fused_block="auto")
    x, w = _int_operands((3, 12), 10, seed=4)
    for site in ("attn.qkv", "ffn", "head"):
        a = auto.matmul(torch.from_numpy(x), torch.from_numpy(w), site=site)
        b = none.matmul(torch.from_numpy(x), torch.from_numpy(w), site=site)
        j = np.asarray(jftc.matmul(jnp.asarray(x), jnp.asarray(w), site=site))
        assert np.array_equal(a.numpy().view(np.int32), b.numpy().view(np.int32))
        assert np.array_equal(a.numpy().view(np.int32), j.view(np.int32))
    with pytest.raises(NotImplementedError, match="ft_plan"):
        TF.build_ftcontext(none.state, none.hyca, fused_block=(8, 128, 128))
    with pytest.raises(NotImplementedError, match="ft_plan"):
        TF.build_ftcontext(none.state, none.hyca, fused_block="auto", autotune_shapes=[(4, 128, 128)])


def test_int_dtype_fused_falls_back_and_is_recorded():
    """Integer operands take the engine's exact int32 path under fused
    dispatch (the kernel accumulates f32) and the fallback is recorded."""
    reset_site_fallbacks()
    jftc, tftc = _contexts(FAULTS, "unprotected", "fused")
    rng = np.random.default_rng(2)
    x = rng.integers(-100, 100, (6, 20)).astype(np.int8)
    w = rng.integers(-100, 100, (20, 8)).astype(np.int8)
    with pytest.warns(RuntimeWarning, match="int-dtype-kernel"):
        b = tftc.matmul(torch.from_numpy(x), torch.from_numpy(w), site="ffn")
    a = np.asarray(jftc.matmul(jnp.asarray(x), jnp.asarray(w), site="ffn"))
    assert b.dtype == torch.int8
    assert np.array_equal(a, b.numpy())
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # warned once per (site, reason)
        tftc.matmul(torch.from_numpy(x), torch.from_numpy(w), site="ffn")
    assert site_fallback_total() == {("ffn", "int-dtype-kernel"): 2}
    reset_site_fallbacks()
