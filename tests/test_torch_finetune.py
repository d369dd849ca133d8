"""The campaign-scale retrain held against the JAX package's.

``hyca_matmul_batched`` with one w a config (``w_axis=0``) is held to one
``hyca_matmul`` a config bit for bit on integer operands, and its gradient
to ``jax.grad`` of the reference engine ``vmap``-ed over the configs, bit
for bit on integer-valued f32 operands (every product and sum is exact).
``finetune_vmapped`` is held to the reference's on the same numpy params,
task, fault tables and plans: 4 configs on the 16×16 array with DPPU 8,
every fault stuck-at-1 on bit 30 (as the repair_recovery benchmark), 5 SGD
steps.  The tuned params agree within rtol 1e-5 / atol 1e-6 in f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import campaign as jcp
from repro.core.engine import HyCAConfig as JConfig
from repro.core.engine import hyca_matmul as j_hyca_matmul
from repro.core.redundancy import DPPUConfig as JDPPU
from repro.repair import finetune_vmapped as j_finetune
from repro_torch.bench import repair_recovery as rr
from repro_torch.core import campaign as tcp
from repro_torch.core.engine import FaultState, HyCAConfig, hyca_matmul, hyca_matmul_batched
from repro_torch.core.fault_models import random_fault_maps
from repro_torch.core.redundancy import DPPUConfig
from repro_torch.repair import finetune_vmapped, fold_channel_salience

N_CFG, ROWS, COLS = 4, 16, 16
T_CFG = HyCAConfig(rows=ROWS, cols=COLS, dppu=DPPUConfig(size=8, group_size=8), mode="protected")
J_CFG = JConfig(rows=ROWS, cols=COLS, dppu=JDPPU(size=8, group_size=8), mode="protected")
RTOL, ATOL = 1e-5, 1e-6


def _tables(per: float, stuck30: bool, seed: int = 0):
    """The same batched fault tables and remap plans in both packages."""
    maps = random_fault_maps(np.random.default_rng(seed), N_CFG, ROWS, COLS, per)
    ts = tcp.batched_fault_states(maps, seed=7, device="cpu")
    js = jcp.batched_fault_states(maps, seed=7)
    if stuck30:
        valid = ts.fpt[..., 0] >= 0
        ts = FaultState(ts.fpt, torch.where(valid, 30, 0).to(torch.int32), torch.where(valid, 1, 0).to(torch.int32))
        jvalid = js.fpt[..., 0] >= 0
        js = dataclasses.replace(js, stuck_bit=jnp.where(jvalid, 30, 0).astype(jnp.int32),
                                 stuck_val=jnp.where(jvalid, 1, 0).astype(jnp.int32))
    for a, b in zip((ts.fpt, ts.stuck_bit, ts.stuck_val), (js.fpt, js.stuck_bit, js.stuck_val)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    sal = fold_channel_salience(np.arange(1, 33, dtype=np.float64), COLS)
    tp = tcp.batched_repair_plans(ts, sal, rows=ROWS, cols=COLS, capacity=T_CFG.capacity, device="cpu")
    jp = jcp.batched_repair_plans(js, jnp.asarray(sal), rows=ROWS, cols=COLS, capacity=J_CFG.capacity)
    assert np.array_equal(tp.col_map.numpy(), np.asarray(jp.col_map))
    assert np.array_equal(tp.prune.numpy(), np.asarray(jp.prune))
    return ts, js, tp, jp



@pytest.fixture(autouse=True)
def one_thread():
    """Tiny tensor ops, thousands of them: one intra-op thread runs them
    fastest, and keeps this file from contending with the suite's other
    workers for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.mark.parametrize("x_shared", [True, False], ids=["x-shared", "x-per-config"])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
def test_per_config_w_equals_per_config_hyca_matmul(dtype, x_shared):
    ts, _, tp, _ = _tables(0.06, stuck30=False)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(-8, 8, (2, 24, 40) if x_shared else (N_CFG, 2, 24, 40))).to(dtype)
    w = torch.from_numpy(rng.integers(-8, 8, (N_CFG, 40, 48))).to(dtype)
    out = hyca_matmul_batched(x, w, ts, cfg=T_CFG, plans=tp, x_axis=None if x_shared else 0, w_axis=0)
    for i in range(N_CFG):
        one = hyca_matmul(x if x_shared else x[i], w[i], tcp.take_config(ts, i), cfg=T_CFG,
                          plan=type(tp)(tp.col_map[i], tp.prune[i]))
        assert out.dtype == one.dtype and torch.equal(out[i], one)


@pytest.mark.parametrize("mode", ["protected", "unprotected"])
def test_per_config_w_gradient_equals_jax_grad(mode):
    ts, js, tp, jp = _tables(0.08, stuck30=False)
    t_cfg, j_cfg = dataclasses.replace(T_CFG, mode=mode), dataclasses.replace(J_CFG, mode=mode)
    rng = np.random.default_rng(2)
    x = rng.integers(-4, 4, (24, 40)).astype(np.float32)
    w = rng.integers(-4, 4, (N_CFG, 40, 32)).astype(np.float32)
    c = rng.integers(-3, 4, (24, 32)).astype(np.float32)

    def j_loss(wb):
        outs = jax.vmap(lambda wi, s, p: j_hyca_matmul(jnp.asarray(x), wi, s, cfg=j_cfg, plan=p))(wb, js, jp)
        return jnp.sum(jnp.where(jnp.isfinite(outs), outs, 0.0) * c)

    want = np.asarray(jax.grad(j_loss)(jnp.asarray(w)))
    wt = torch.from_numpy(w).requires_grad_()
    out = hyca_matmul_batched(torch.from_numpy(x), wt, ts, cfg=t_cfg, plans=tp, x_axis=None, w_axis=0)
    loss = (torch.where(torch.isfinite(out), out, torch.zeros_like(out)) * torch.from_numpy(c)).sum()
    (got,) = torch.autograd.grad(loss, wt)
    assert np.abs(want).sum() > 0
    np.testing.assert_array_equal(got.numpy(), want)


def test_finetune_vmapped_equals_reference():
    rng = np.random.default_rng(0)
    make = rr._make_task(rng)
    xtr, ytr = make(256)
    ts, js, tp, jp = _tables(0.10, stuck30=True, seed=3)
    params = {k: v.numpy() for k, v in rr.init_params("cpu").items()}

    def j_loss(p, s, pl):
        h = j_hyca_matmul(jnp.asarray(xtr), p["w1"], s, cfg=J_CFG, plan=pl)
        lg = jnp.maximum(h, 0.0) @ p["w2"]
        return -jnp.mean(jax.nn.log_softmax(lg)[jnp.arange(ytr.size), ytr])

    want = j_finetune(j_loss, jax.tree.map(jnp.asarray, params), js, jp, steps=5, lr=0.3)
    x, y = torch.from_numpy(xtr), torch.from_numpy(ytr).long()

    def t_loss(pb, states, plans):
        return rr.cross_entropy(rr.forward_batched(pb, x, states, plans, T_CFG, per_config=True), y)

    got = finetune_vmapped(t_loss, {k: torch.from_numpy(v) for k, v in params.items()}, ts, tp, steps=5, lr=0.3)
    for k in ("w1", "w2"):
        assert got[k].shape == (N_CFG, *params[k].shape)
        assert np.isfinite(got[k].numpy()).all()
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL, atol=ATOL)
        # every config moved away from the shared start, each its own way
        moved = np.abs(got[k].numpy() - params[k][None]).reshape(N_CFG, -1).max(1)
        assert (moved > 0).all()
    assert not np.array_equal(got["w1"][0].numpy(), got["w1"][1].numpy())


def test_finetune_vmapped_rejects_a_scalar_loss():
    ts, _, tp, _ = _tables(0.05, stuck30=False)
    with pytest.raises(ValueError, match="per-config losses"):
        finetune_vmapped(lambda p, s, pl: p["w"].sum(), {"w": torch.ones(3)}, ts, tp, steps=1, lr=0.1)


def test_repair_recovery_twin_quick_claims():
    out = rr.run(quick=True, device="cpu")
    assert len(out["claims"]) == 7
    assert out["all_ok"], [c for c in out["claims"] if not c["ok"]]
    assert set(out["curves"]) == {"unprotected", "protected", "remap", "retrain"}


def test_repair_recovery_twin_on_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        rr.run(quick=True, device="cuda")
