"""Gradients through the port's two-pass engine held against ``jax.grad`` of
the reference engine.

The reference selects between the stuck-at result and the clean output on
floats (``jnp.where(fi, bad, out)``), so a gradient passes through every
output element except a faulty one that the DPPU does not repair (and a
pruned one).  The port must give the same gradient.

Operands and cotangents are small integers, so every product and every sum
of the forward and of both gradients is exact in float32 and in bfloat16:
outputs and gradients must agree bit for bit.  Protected with at most DPPU
capacity faults, the gradients equal those of the clean ``x @ w``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as J
from repro.core.redundancy import DPPUConfig as JDPPU
from repro_torch.core import engine as T
from repro_torch.core.redundancy import DPPUConfig as TDPPU

ROWS = COLS = 4
DPPU = 2
M, K, N = 8, 16, 8
# leftmost-sorted FPTs on the 4x4 array; stuck bits that make visible
# values (the sign bit, exponent bits) and a low mantissa bit
AT_CAPACITY = ([[1, 0], [2, 3]], [30, 31], [1, 0])
OVER_CAPACITY = ([[0, 0], [2, 0], [1, 1], [3, 2], [0, 3]], [31, 30, 31, 22, 3], [1, 1, 0, 0, 1])
CASES = {
    "protected_at_capacity": ("protected", AT_CAPACITY, False),
    "protected_over_capacity": ("protected", OVER_CAPACITY, False),
    "unprotected": ("unprotected", AT_CAPACITY, False),
    "protected_plan_prune": ("protected", OVER_CAPACITY, True),
    "unprotected_plan_prune": ("unprotected", OVER_CAPACITY, True),
}
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _both(mode, faults, with_plan):
    fpt, bits, vals = (np.asarray(a, np.int32) for a in faults)
    jc = J.HyCAConfig(ROWS, COLS, JDPPU(size=DPPU, group_size=DPPU), mode)
    tc = T.HyCAConfig(ROWS, COLS, TDPPU(size=DPPU, group_size=DPPU), mode)
    js = J.FaultState(*(jnp.asarray(a) for a in (fpt, bits, vals)))
    ts = T.FaultState(*(torch.from_numpy(a.copy()) for a in (fpt, bits, vals)))
    jp = tp = None
    if with_plan:
        col_map = np.array([2, 0, 3, 1], np.int32)
        prune = np.zeros((ROWS, COLS), bool)
        prune[1, 2] = prune[3, 0] = prune[0, 1] = True
        jp = J.RepairPlan(jnp.asarray(col_map), jnp.asarray(prune))
        tp = T.RepairPlan(torch.from_numpy(col_map), torch.from_numpy(prune))
    return (jc, js, jp), (tc, ts, tp)


def _operands(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(-4, 5, (M, K)).astype(np.float32)
    w = rng.integers(-4, 5, (K, N)).astype(np.float32)
    cot = rng.integers(-2, 3, (M, N)).astype(np.float32)
    return x, w, cot


def _jax_vjp(x, w, cot, jdt, cfg, state, plan):
    f = lambda a, b: J.hyca_matmul(a, b, state, cfg=cfg, plan=plan)
    out, vjp = jax.vjp(f, jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    gx, gw = vjp(jnp.asarray(cot, out.dtype))
    return np.asarray(out), np.asarray(gx.astype(jnp.float32)), np.asarray(gw.astype(jnp.float32))


def _torch_vjp(x, w, cot, tdt, fn):
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    wt = torch.from_numpy(w).to(tdt).requires_grad_()
    out = fn(xt, wt)
    gx, gw = torch.autograd.grad(out, (xt, wt), grad_outputs=torch.from_numpy(cot).to(out.dtype))
    assert gx.dtype == tdt and gw.dtype == tdt
    return out.detach().numpy(), gx.float().numpy(), gw.float().numpy()


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_hyca_matmul_gradient_matches_jax_grad(case, dtype):
    mode, faults, with_plan = CASES[case]
    (jc, js, jp), (tc, ts, tp) = _both(mode, faults, with_plan)
    _, jdt, tdt = DTYPES[dtype]
    x, w, cot = _operands()
    jout, jgx, jgw = _jax_vjp(x, w, cot, jdt, jc, js, jp)
    tout, tgx, tgw = _torch_vjp(x, w, cot, tdt, lambda a, b: T.hyca_matmul(a, b, ts, cfg=tc, plan=tp))
    # the forward is the engine's, bit for bit, faulted elements included
    assert np.array_equal(_bits(jout), _bits(tout))
    assert np.array_equal(_bits(jgx), _bits(tgx))
    assert np.array_equal(_bits(jgw), _bits(tgw))
    # the gradient is the clean product's, masked where the output is
    # neither clean nor recomputed
    clean_gx, clean_gw = cot @ w.T, x.T @ cot
    if case == "protected_at_capacity":
        assert np.array_equal(tgx, clean_gx) and np.array_equal(tgw, clean_gw)
    else:
        assert not np.array_equal(tgw, clean_gw)
        assert np.any(tgw != 0)


@pytest.mark.parametrize("mode", ["protected", "unprotected"])
def test_hyca_matmul_gradient_mask_is_the_unrepaired_faults(mode):
    """The gradient of each output element is 1 where it is clean or
    recomputed and 0 where a fault corrupts it, from one-hot cotangents:
    ``d out / d x`` summed over the array's elements."""
    (jc, js, _), (tc, ts, _) = _both(mode, OVER_CAPACITY, False)
    x = np.ones((ROWS, 1), np.float32)
    w = np.ones((1, COLS), np.float32)
    cot = np.ones((ROWS, COLS), np.float32)
    _, _, jgw = _jax_vjp(x, w, cot, jnp.float32, jc, js, None)
    _, _, tgw = _torch_vjp(x, w, cot, torch.float32, lambda a, b: T.hyca_matmul(a, b, ts, cfg=tc))
    fpt = np.asarray(OVER_CAPACITY[0])
    unrepaired = fpt if mode == "unprotected" else fpt[DPPU:]
    want = np.full(COLS, ROWS, np.float32)
    for _, c in unrepaired:
        want[c] -= 1
    assert np.array_equal(tgw[0], want) and np.array_equal(jgw[0], want)


def test_hyca_matmul_abft_gradient_matches_jax_grad():
    """``hyca_matmul_abft``'s data output carries the engine's gradient; its
    checksum lanes go through the fused epilogue's bit masks, which carry
    none in the reference and in the port alike."""
    (jc, js, _), (tc, ts, _) = _both("unprotected", OVER_CAPACITY, False)
    x, w, cot = _operands(1)
    jfn = lambda a, b: J.hyca_matmul_abft(a, b, js, cfg=jc)
    (jout, jrow, _), vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w))
    jgx, jgw = vjp((jnp.asarray(cot), jnp.ones_like(jrow), None))
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    tout, trow, _ = T.hyca_matmul_abft(xt, wt, ts, cfg=tc)
    assert np.array_equal(_bits(jout), _bits(tout.detach().numpy()))
    assert np.array_equal(_bits(jrow), _bits(trow.numpy()))
    assert not trow.requires_grad and not np.any(np.asarray(jgx) - np.asarray(
        jax.vjp(lambda a, b: J.hyca_matmul(a, b, js, cfg=jc), jnp.asarray(x), jnp.asarray(w))[1](jnp.asarray(cot))[0]))
    tgx, tgw = torch.autograd.grad(tout, (xt, wt), grad_outputs=torch.from_numpy(cot))
    assert np.array_equal(_bits(jgx), _bits(tgx.numpy()))
    assert np.array_equal(_bits(jgw), _bits(tgw.numpy()))
