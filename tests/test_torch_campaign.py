"""The port's FaultCampaign held against the JAX package's.

  * sampling: the numpy sampler's points are the reference's, bit for bit;
  * the batched evaluator (torch ops over the config axis, here on the CPU)
    equals the reference's ``vmap``-ed evaluator and the per-config NumPy
    loop config by config, for all four schemes, ``repair="remap"`` and both
    fault models, DR's union-find scan on square and non-square arrays
    included; every field of ``run_campaign`` equals JAX's;
  * batched fault states, single-fault states, remap plans and identity
    plans equal the reference's leaf for leaf;
  * ``hyca_matmul_batched`` equals ``jax.vmap(hyca_matmul)`` bitwise on int8
    operands, and the fig02 twin's MLP predicts what the reference's
    ``infer_vmapped`` predicts on the same int8 weights;
  * the torch device samplers, which cannot replay JAX's threefry streams,
    are held statistically (rates within binomial CIs, exact counts, bounds,
    clustering), in place of the reference's recompilation tests;
  * the reference's golden-stats suite (``@campaign_stats``) on the port;
  * the campaign and fig10 twins at quick size reproduce the reference's
    result tables exactly, and the other numpy twins every number of the
    reference benchmark's own quick run.
"""
import dataclasses
import inspect
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import campaign as jcp
from repro.core import engine as JE
from repro.core.redundancy import DPPUConfig as JDPPU
from repro_torch.core import campaign as cp
from repro_torch.core import engine as TE
from repro_torch.core import redundancy as red
from repro_torch.core import reliability as rel
from repro_torch.core.fault_models import random_fault_maps
from repro_torch.core.redundancy import DPPUConfig

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


def _spec_pair(**kw):
    dppu = kw.pop("dppu", None)
    return (jcp.CampaignSpec(dppu=None if dppu is None else JDPPU(**dppu), **kw),
            cp.CampaignSpec(dppu=None if dppu is None else DPPUConfig(**dppu), **kw))


# --------------------------------------------------------------------------- #
# sampling
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("model", ["random", "clustered"])
def test_sample_point_identical(model):
    js, ts = _spec_pair(rows=12, cols=8, fault_model=model, n_configs=80, seed=6)
    a, b = jcp.sample_point(js, 0.05), cp.sample_point(ts, 0.05)
    np.testing.assert_array_equal(a.maps, b.maps)
    assert a.spare_faulty.keys() == b.spare_faulty.keys()
    for k in a.spare_faulty:
        np.testing.assert_array_equal(a.spare_faulty[k], b.spare_faulty[k])
    np.testing.assert_array_equal(a.hyca_caps, b.hyca_caps)
    with pytest.raises(ValueError, match="unknown repair"):
        cp.CampaignSpec(repair="retrain")
    with pytest.raises(ValueError, match="unknown sampler"):
        cp.sample_point(dataclasses.replace(ts, sampler="gpu"), 0.05)


# --------------------------------------------------------------------------- #
# the batched evaluator
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("rows,cols", [(8, 8), (16, 8), (8, 16), (12, 8)])
def test_evaluate_batched_equals_jax_and_reference(rows, cols, rng):
    """Per-config (ff, surviving columns): the port on the CPU == the JAX
    ``evaluate_batched`` == the per-config NumPy loop, dense random batches
    with unhealthy spares, non-square arrays (rectangular DR sub-splits)."""
    n = 200
    pers = rng.uniform(0.0, 0.25, size=n)
    maps = rng.random((n, rows, cols)) < pers[:, None, None]
    for scheme in red.SCHEMES:
        if scheme == "HyCA":
            aux = rng.integers(0, cols + 2, size=n).astype(np.int32)
        else:
            aux = rng.random((n, red.n_spares(scheme, rows, cols))) < 0.25
        point = cp.CampaignPoint(0.0, maps, {} if scheme == "HyCA" else {scheme: aux},
                                 aux if scheme == "HyCA" else None)
        for repair in (("none", "remap") if scheme == "HyCA" else ("none",)):
            ff, surv = cp.evaluate_batched(torch.from_numpy(maps), torch.from_numpy(aux), scheme=scheme, repair=repair)
            assert ff.dtype == torch.bool and surv.dtype == torch.int32
            jff, jsurv = jcp.evaluate_batched(jnp.asarray(maps), jnp.asarray(aux), scheme=scheme, repair=repair)
            np.testing.assert_array_equal(ff.numpy(), np.asarray(jff), err_msg=scheme)
            np.testing.assert_array_equal(surv.numpy(), np.asarray(jsurv), err_msg=scheme)
            rff, rsurv = cp.evaluate_reference(point, scheme, repair)
            np.testing.assert_array_equal(ff.numpy(), rff, err_msg=scheme)
            np.testing.assert_array_equal(surv.numpy(), rsurv, err_msg=scheme)
    with pytest.raises(ValueError, match="unknown scheme"):
        cp.evaluate_batched(torch.from_numpy(maps), torch.from_numpy(aux), scheme="XR")


@pytest.mark.parametrize("rows,cols", [(8, 8), (6, 20)])
def test_dr_dead_spares_and_diagonal_faults(rows, cols, rng):
    """DR corner cases: diagonal faults (one spare neighbourhood), dead
    spares on both endpoints, heavy spare mortality, and a fault count well
    past n + 1 per sub-array."""
    n = 300
    maps = rng.random((n, rows, cols)) < 0.15
    for i in range(0, n, 3):
        maps[i, i % rows, i % cols] = True
    spares = rng.random((n, red.n_spares("DR", rows, cols))) < 0.5
    ref = [red.dr_repair(maps[i], spares[i]) for i in range(n)]
    ff, surv = cp.evaluate_batched(torch.from_numpy(maps), torch.from_numpy(spares), scheme="DR")
    np.testing.assert_array_equal(ff.numpy(), [r[0] for r in ref])
    np.testing.assert_array_equal(surv.numpy(), [r[1] for r in ref])


@pytest.mark.parametrize("model", ["random", "clustered"])
@pytest.mark.parametrize("repair", ["none", "remap"])
def test_run_campaign_equals_jax(model, repair):
    """Every field of every result, and the host-loop count, equal JAX's."""
    js, ts = _spec_pair(rows=16, cols=16, fault_model=model, n_configs=150, seed=3, repair=repair,
                        dppu=dict(size=16))
    pers = (0.01, 0.03, 0.06)
    a = jcp.run_campaign(js, pers)
    b = cp.run_campaign(ts, pers, device=CPU)
    assert [r.as_dict() for r in b.results] == [r.as_dict() for r in a.results]
    assert b.table() == a.table()
    assert b.python_iterations == a.python_iterations == len(pers) * len(ts.schemes)
    assert b.get("DR", 0.03) == b.results[2 + len(ts.schemes)]
    with pytest.raises(KeyError):
        b.get("DR", 0.5)
    ref = cp.run_campaign(ts, pers, engine="reference")
    assert [r.as_dict() for r in ref.results] == [r.as_dict() for r in b.results]


@pytest.mark.parametrize("fault_model", ["random", "clustered"])
@pytest.mark.parametrize("seed", [0, 7])
def test_campaign_bit_identical_to_legacy_loop(fault_model, seed):
    n = 150
    spec = cp.CampaignSpec(rows=16, cols=16, fault_model=fault_model, n_configs=n,
                           dppu=DPPUConfig(size=16), seed=seed)
    point = cp.sample_point(spec, 0.03)
    for r in cp.evaluate_point(spec, point, device=CPU):
        legacy = rel.evaluate_scheme(r.scheme, 0.03, rows=16, cols=16, fault_model=fault_model,
                                     n_configs=n, dppu=DPPUConfig(size=16), seed=seed)
        assert r.fully_functional_prob == legacy.fully_functional_prob, r.scheme
        assert r.remaining_power == legacy.remaining_power, r.scheme


def test_statistics_helpers_equal_jax():
    acc = np.random.default_rng(1).uniform(0.4, 1.0, 37)
    assert cp.summarize_accuracy(acc) == jcp.summarize_accuracy(acc)
    for p, n in ((0.0, 10), (0.3, 200), (1.0, 5), (0.5, 0)):
        assert cp.binomial_halfwidth(p, n) == jcp.binomial_halfwidth(p, n)
    assert cp.mean_halfwidth(acc) == jcp.mean_halfwidth(acc) and cp.mean_halfwidth(acc[:1]) == 1.0
    assert [cp.point_seed(0, i) for i in range(4)] == [7919, 15838, 23757, 31676]


# --------------------------------------------------------------------------- #
# batched fault states and plans
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("max_faults", [None, 3, 80])
def test_batched_fault_states_equal_jax(max_faults, rng):
    """Leaf for leaf, including truncation (3 slots) and padding (80 > 64)."""
    maps = random_fault_maps(rng, 12, 8, 8, 0.08)
    a = jcp.batched_fault_states(maps, seed=5, max_faults=max_faults)
    b = cp.batched_fault_states(maps, seed=5, max_faults=max_faults, device=CPU)
    for x, y in zip((a.fpt, a.stuck_bit, a.stuck_val), (b.fpt, b.stuck_bit, b.stuck_val)):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
        assert y.dtype == torch.int32
    for i in (0, 7):
        one = cp.take_config(b, i)
        ref = TE.fault_state_from_map(maps[i], max_faults=max_faults or 64)
        if max_faults != 3:
            np.testing.assert_array_equal(one.fpt.numpy(), ref.fpt.numpy())


def test_merge_batched_equals_per_config_merge(rng):
    """The batched merge is each config's own ``merge``: dedup against an
    existing table, leftmost-first order, -1 padding, overflow."""
    maps = rng.random((6, 8, 8)) < 0.1
    states = cp.batched_fault_states(maps, seed=2, max_faults=10, device=CPU)
    new = torch.from_numpy(rng.random((6, 8, 8)) < 0.1)
    bits = torch.from_numpy(rng.integers(0, 32, (6, 8, 8)).astype(np.int32))
    vals = torch.from_numpy(rng.integers(0, 2, (6, 8, 8)).astype(np.int32))
    out = states.merge_batched(new, stuck_bit=bits, stuck_val=vals)
    for i in range(6):
        one = cp.take_config(states, i).merge(new[i], stuck_bit=bits[i], stuck_val=vals[i])
        for x, y in zip((one.fpt, one.stuck_bit, one.stuck_val), (out.fpt[i], out.stuck_bit[i], out.stuck_val[i])):
            assert torch.equal(x, y)


def test_batched_single_fault_states_equal_jax():
    a = jcp.batched_single_fault_states(np.random.default_rng(3), 40, 8, 16, max_faults=4)
    b = cp.batched_single_fault_states(np.random.default_rng(3), 40, 8, 16, max_faults=4, device=CPU)
    for x, y in zip((a[0].fpt, a[0].stuck_bit, a[0].stuck_val), (b[0].fpt, b[0].stuck_bit, b[0].stuck_val)):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("prune", [True, False])
def test_batched_repair_plans_equal_jax(prune, rng):
    maps = random_fault_maps(rng, 16, 8, 8, 0.12)
    sal = rng.random(8).astype(np.float32)
    sal[3] = sal[5]  # a tie: broken by class index on both sides
    ja = jcp.batched_repair_plans(jcp.batched_fault_states(maps, seed=1), jnp.asarray(sal),
                                  rows=8, cols=8, capacity=4, prune=prune)
    tb = cp.batched_repair_plans(cp.batched_fault_states(maps, seed=1, device=CPU), sal,
                                 rows=8, cols=8, capacity=4, prune=prune, device=CPU)
    np.testing.assert_array_equal(np.asarray(ja.col_map), tb.col_map.numpy())
    np.testing.assert_array_equal(np.asarray(ja.prune), tb.prune.numpy())
    ji, ti = jcp.identity_plans(16, 8, 8), cp.identity_plans(16, 8, 8, device=CPU)
    np.testing.assert_array_equal(np.asarray(ji.col_map), ti.col_map.numpy())
    np.testing.assert_array_equal(np.asarray(ji.prune), ti.prune.numpy())


# --------------------------------------------------------------------------- #
# hyca_matmul_batched against jax.vmap(hyca_matmul)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["protected", "unprotected", "off"])
@pytest.mark.parametrize("with_plans", [False, True])
@pytest.mark.parametrize("shared_x", [False, True])
@pytest.mark.parametrize("dtype", [np.int8, np.int32])
def test_hyca_matmul_batched_equals_vmapped_jax(mode, with_plans, shared_x, dtype, rng):
    """Operands over the full int8 range (accumulates past 2**21), as int8
    (the exact float64 route) and as int32 (the per-config int64 route), 8
    faults a config on average, capacity 4 (so faults go unrepaired), remap
    plans with prune: bit for bit against ``jax.vmap(hyca_matmul)`` and
    against the port's own per-config ``hyca_matmul``."""
    rows = cols = 8
    n = 10
    maps = random_fault_maps(rng, n, rows, cols, 0.12)
    jstates = jcp.batched_fault_states(maps, seed=3)
    tstates = cp.batched_fault_states(maps, seed=3, device=CPU)
    jcfg = JE.HyCAConfig(rows, cols, JDPPU(size=4, group_size=4), mode)
    tcfg = TE.HyCAConfig(rows, cols, DPPUConfig(size=4, group_size=4), mode)
    x = rng.integers(-128, 128, (5, 37) if shared_x else (n, 5, 37)).astype(dtype)
    w = rng.integers(-128, 128, (37, 19)).astype(dtype)
    jplans = tplans = None
    if with_plans:
        sal = rng.random(cols).astype(np.float32)
        jplans = jcp.batched_repair_plans(jstates, jnp.asarray(sal), rows=rows, cols=cols, capacity=4)
        tplans = cp.batched_repair_plans(tstates, sal, rows=rows, cols=cols, capacity=4, device=CPU)

    def one(xi, s, p):
        return JE.hyca_matmul(xi, jnp.asarray(w), s, cfg=jcfg, plan=p)

    in_x = None if shared_x else 0
    if with_plans:
        a = jax.vmap(one, in_axes=(in_x, 0, 0))(jnp.asarray(x), jstates, jplans)
    else:
        a = jax.vmap(lambda xi, s: one(xi, s, None), in_axes=(in_x, 0))(jnp.asarray(x), jstates)
    b = TE.hyca_matmul_batched(torch.from_numpy(x), torch.from_numpy(w), tstates, cfg=tcfg, plans=tplans,
                               x_axis=in_x)
    assert b.dtype == torch.int32 and b.shape == (n, 5, 19)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for i in (0, n - 1):
        plan = None if tplans is None else TE.RepairPlan(tplans.col_map[i], tplans.prune[i])
        xi = torch.from_numpy(x if shared_x else x[i])
        ref = TE.hyca_matmul(xi, torch.from_numpy(w), cp.take_config(tstates, i), cfg=tcfg, plan=plan)
        assert torch.equal(b[i], ref)


def test_hyca_matmul_batched_validates_once(rng):
    maps = random_fault_maps(rng, 3, 4, 4, 0.3)
    states = cp.batched_fault_states(maps, device=CPU)
    cfg = TE.HyCAConfig(4, 4, DPPUConfig(size=2, group_size=2), "protected")
    x = torch.zeros((3, 2, 6), dtype=torch.int8)
    w = torch.zeros((6, 4), dtype=torch.int8)
    bad = TE.FaultState(states.fpt.clone(), states.stuck_bit, states.stuck_val)
    bad.fpt[1, 0] = torch.tensor([0, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match="out of bounds"):
        TE.hyca_matmul_batched(x, w, bad, cfg=cfg)
    plans = cp.identity_plans(3, 4, 4, device=CPU)
    plans.col_map[2, 0] = 1
    with pytest.raises(ValueError, match="permutation"):
        TE.hyca_matmul_batched(x, w, states, cfg=cfg, plans=plans)
    with pytest.raises(ValueError, match="configs"):
        TE.hyca_matmul_batched(x[:2], w, states, cfg=cfg)
    with pytest.raises(ValueError, match="x_axis"):
        TE.hyca_matmul_batched(x, w, states, cfg=cfg, x_axis=1)


def _reference_benchmark(name: str):
    """The reference's benchmark module ``benchmarks.<name>`` (the repository
    root holds the ``benchmarks`` package)."""
    import importlib

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module(f"benchmarks.{name}")


def test_fig02_quant_mlp_equals_jax_infer_vmapped():
    """The fig02 twin's int8 MLP on the reference's int8 weights (bridged
    through numpy): the same predictions as the reference's
    ``infer_vmapped``, protected and unprotected, on 40% of configs over
    capacity; the clean run equals the protected run with an empty table."""
    from repro_torch.bench import fig02_accuracy_vs_per as tfig

    jfig = _reference_benchmark("fig02_accuracy_vs_per")
    rng = np.random.default_rng(0)
    xtr, ytr, centers = tfig._make_data(rng, 512)
    xte, _, _ = tfig._make_data(rng, 96, centers=centers)
    init = np.random.default_rng(1)
    ws = [init.standard_normal((tfig.DIMS[i], tfig.DIMS[i + 1])).astype(np.float32) / np.sqrt(tfig.DIMS[i])
          for i in range(len(tfig.DIMS) - 1)]
    jm = jfig.QuantMLP.from_float(ws, xtr)
    tm = tfig.QuantMLP(jm.w_q, jm.s_w, jm.s_act)
    maps = random_fault_maps(rng, 12, 32, 32, 0.035)
    jstates = jcp.batched_fault_states(maps, seed=4)
    tstates = cp.batched_fault_states(maps, seed=4, device=CPU)
    for mode in ("protected", "unprotected"):
        a = jm.infer_vmapped(xte, jstates, JE.HyCAConfig(mode=mode))
        b = tm.infer_batched(xte, tstates, TE.HyCAConfig(mode=mode))
        np.testing.assert_array_equal(a, b)
        for i in (0, 5):  # the legacy per-config path predicts the same
            np.testing.assert_array_equal(tm.infer(xte, cp.take_config(tstates, i), TE.HyCAConfig(mode=mode)), b[i])
    clean = tm.infer(xte, None, TE.HyCAConfig(mode="off"))
    empty = cp.batched_fault_states(np.zeros((1, 32, 32), bool), device=CPU)
    np.testing.assert_array_equal(tm.infer_batched(xte, empty, TE.HyCAConfig(mode="protected"))[0], clean)


# --------------------------------------------------------------------------- #
# device samplers, held statistically
# --------------------------------------------------------------------------- #
def test_device_random_maps_rate_within_binomial_ci():
    per = 0.02
    n, rows, cols = 400, 16, 16
    maps = cp.device_random_maps(0, n, rows, cols, per, device=CPU)
    assert maps.shape == (n, rows, cols) and maps.dtype == torch.bool
    assert abs(maps.float().mean().item() - per) < cp.binomial_halfwidth(per, n * rows * cols, z=4.0)


@pytest.mark.parametrize("sigma", [0.5, 1.5, 500.0])
def test_device_clustered_maps_count_bounds_and_rate(sigma):
    """Each map carries exactly its Binomial count (the sampler's first draw,
    replayed here from the same seed), stays in bounds at any sigma, and the
    marginal rate sits within the binomial CI."""
    per = 0.03
    n, rows, cols = 200, 16, 16
    maps = cp.device_clustered_maps(1, n, rows, cols, per, cluster_sigma=sigma, device=CPU)
    assert maps.shape == (n, rows, cols) and maps.dtype == torch.bool
    g = torch.Generator().manual_seed(1)
    target = (torch.rand((n, rows * cols), generator=g) < per).sum(dim=1)
    assert torch.equal(maps.reshape(n, -1).sum(dim=1), target)
    assert abs(maps.float().mean().item() - per) < cp.binomial_halfwidth(per, n * rows * cols, z=4.0)
    one = cp.device_clustered_maps(2, 50, 8, 8, 0.05, cluster_size_mean=1.0, cluster_sigma=sigma, device=CPU)
    assert one.shape == (50, 8, 8)


def _mean_pair_dist(maps):
    ds = []
    for m in maps:
        r, c = np.nonzero(m)
        if r.size < 2:
            continue
        d = np.sqrt((r[:, None] - r[None, :]) ** 2 + (c[:, None] - c[None, :]) ** 2)
        ds.append(d[np.triu_indices(r.size, 1)].mean())
    return float(np.mean(ds))


def test_device_clustered_maps_are_spatially_clustered():
    cmaps = cp.device_clustered_maps(2, 150, 32, 32, 0.02, device=CPU).numpy()
    rmaps = cp.device_random_maps(2, 150, 32, 32, 0.02, device=CPU).numpy()
    assert _mean_pair_dist(cmaps) < _mean_pair_dist(rmaps) - 2.0


def test_device_dppu_capacity_matches_numpy_statistics():
    cfg = DPPUConfig(size=32)
    dev = cp.device_dppu_capacity(3, cfg, 0.02, 3000, device=CPU).numpy()
    ref = red.dppu_capacity(np.random.default_rng(3), cfg, 0.02, 3000)
    assert dev.shape == ref.shape and dev.dtype == np.int32
    assert set(np.unique(dev)) <= set(range(0, cfg.size + 1, cfg.group_size))
    assert abs(dev.mean() - ref.mean()) < cp.mean_halfwidth(ref, z=4.0) + cp.mean_halfwidth(dev, z=4.0)


def test_device_sampler_campaign_end_to_end():
    spec = cp.CampaignSpec(rows=16, cols=16, n_configs=300, sampler="device",
                           dppu=DPPUConfig(size=16), seed=4)
    run = cp.run_campaign(spec, [0.01, 0.04], device=CPU)
    t = run.table()
    assert t["HyCA"][0.01] > 0.9
    assert t["HyCA"][0.04] >= t["RR"][0.04]
    point = cp.sample_point(spec, 0.03, device=CPU)
    assert torch.is_tensor(point.maps) and point.hyca_caps.dtype == torch.int32
    for scheme in spec.schemes:  # device-sampled points evaluate in both engines alike
        ff, surv = cp.evaluate_reference(point, scheme)
        aux = point.hyca_caps if scheme == "HyCA" else point.spare_faulty[scheme]
        bff, bsurv = cp.evaluate_batched(point.maps, aux, scheme=scheme)
        np.testing.assert_array_equal(bff.numpy(), ff)
        np.testing.assert_array_equal(bsurv.numpy(), surv)


def test_entry_points_default_to_the_card_and_raise_without_it(monkeypatch):
    for fn in (cp.run_campaign, cp.evaluate_point, cp.sample_point, cp.batched_fault_states,
               cp.batched_single_fault_states, cp.batched_repair_plans, cp.identity_plans,
               cp.device_random_maps, cp.device_clustered_maps, cp.device_dppu_capacity):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = cp.CampaignSpec(rows=4, cols=4, n_configs=3)
    maps = np.zeros((2, 4, 4), bool)
    for call in (lambda: cp.run_campaign(spec, [0.1]),
                 lambda: cp.evaluate_point(spec, cp.sample_point(spec, 0.1)),
                 lambda: cp.batched_fault_states(maps),
                 lambda: cp.identity_plans(2, 4, 4),
                 lambda: cp.device_random_maps(0, 2, 4, 4, 0.1),
                 lambda: cp.run_campaign(dataclasses.replace(spec, sampler="device"), [0.1], engine="reference")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # the host engine needs no card
    assert len(cp.run_campaign(spec, [0.1], engine="reference").results) == 4


# --------------------------------------------------------------------------- #
# golden-stats acceptance suite (the reference's four, on the port)
# --------------------------------------------------------------------------- #
GOLDEN_SEED = 0
GOLDEN_N = 1500
GOLDEN_PERS = (0.01, 0.025, 0.04)


@pytest.fixture(scope="module")
def golden_run():
    spec = cp.CampaignSpec(rows=32, cols=32, fault_model="random", n_configs=GOLDEN_N,
                           dppu=DPPUConfig(size=32), seed=GOLDEN_SEED)
    return cp.run_campaign(spec, GOLDEN_PERS, device=CPU)


@pytest.mark.campaign_stats
@pytest.mark.slow
def test_golden_monotone_ffp_degradation(golden_run):
    for scheme in red.SCHEMES:
        for i in range(len(GOLDEN_PERS) - 1):
            a = golden_run.get(scheme, GOLDEN_PERS[i])
            b = golden_run.get(scheme, GOLDEN_PERS[i + 1])
            assert a.fully_functional_prob >= b.fully_functional_prob - a.ffp_ci95 - b.ffp_ci95, scheme


@pytest.mark.campaign_stats
@pytest.mark.slow
def test_golden_scheme_ordering(golden_run):
    """HyCA >= DR >= CR/RR at every operating point, within campaign CI."""
    for per in GOLDEN_PERS:
        hyca = golden_run.get("HyCA", per)
        dr = golden_run.get("DR", per)
        for lo in ("CR", "RR"):
            low = golden_run.get(lo, per)
            assert dr.fully_functional_prob >= low.fully_functional_prob - dr.ffp_ci95 - low.ffp_ci95, (per, lo)
        assert hyca.fully_functional_prob >= dr.fully_functional_prob - hyca.ffp_ci95 - dr.ffp_ci95, per
        assert hyca.remaining_power >= dr.remaining_power - hyca.remaining_power_ci95 - dr.remaining_power_ci95, per


@pytest.mark.campaign_stats
@pytest.mark.slow
def test_golden_hyca_capacity_cliff(golden_run):
    below = golden_run.get("HyCA", 0.01)
    near = golden_run.get("HyCA", 0.025)
    above = golden_run.get("HyCA", 0.04)
    assert below.fully_functional_prob >= 0.99 - below.ffp_ci95
    assert near.fully_functional_prob >= 0.85 - near.ffp_ci95
    assert above.fully_functional_prob <= 0.10 + above.ffp_ci95
    assert above.remaining_power >= 0.5 - above.remaining_power_ci95


@pytest.mark.campaign_stats
@pytest.mark.slow
def test_golden_protected_accuracy_recovery(rng):
    """Protected forwards equal the clean run for EVERY config with #faults
    <= DPPU capacity, and most configs with a fault are corrupted
    unprotected: the Fig. 2 recovery claim as a batched statistical test."""
    rows = cols = 16
    cfg_p = TE.HyCAConfig(rows=rows, cols=cols, dppu=DPPUConfig(size=16, group_size=8), mode="protected")
    cfg_u = dataclasses.replace(cfg_p, mode="unprotected")
    x = rng.integers(-8, 8, (8, 32)).astype(np.int8)
    w = rng.integers(-8, 8, (32, cols)).astype(np.int8)
    maps = random_fault_maps(rng, 128, rows, cols, 0.02)
    counts = maps.reshape(128, -1).sum(1)
    states = cp.batched_fault_states(maps, seed=9, device=CPU)
    clean = x.astype(np.int32) @ w.astype(np.int32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    out_p = TE.hyca_matmul_batched(xt, wt, states, cfg=cfg_p, x_axis=None).numpy()
    out_u = TE.hyca_matmul_batched(xt, wt, states, cfg=cfg_u, x_axis=None).numpy()
    recovered = [np.array_equal(out_p[i], clean) for i in range(128) if counts[i] <= cfg_p.capacity]
    assert recovered and all(recovered)
    corrupted = [not np.array_equal(out_u[i], clean) for i in range(128) if counts[i] > 0]
    assert np.mean(corrupted) > 0.5


# --------------------------------------------------------------------------- #
# the twins reproduce the reference's result tables
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["campaign", "fig10_ffp"])
def test_twin_quick_tables_equal_reference_results(name, tmp_path, monkeypatch):
    """The twin at quick size, on the CPU, reproduces the ``table`` of the
    reference's result file float for float, and its claims hold."""
    import importlib

    from repro_torch.bench import common

    monkeypatch.setattr(common, "OUT_DIR", str(tmp_path))
    twin = importlib.import_module(f"repro_torch.bench.{name}")
    out = common.run_module(name, twin.run, True, CPU)
    assert out["all_ok"]
    ref = json.loads((ROOT / "experiments" / "bench" / f"{name}.json").read_text())
    assert json.loads(json.dumps(out["table"], default=float)) == ref["table"]
    assert [c["claim"] for c in out["claims"]] == [c["claim"] for c in ref["claims"]]
    assert json.loads((tmp_path / f"{name}.json").read_text())["table"] == ref["table"]


def _comparable(out: dict) -> dict:
    """A twin's result without what differs by package: host seconds, the
    device, the engine name."""
    drop = {"elapsed_s", "device", "engine"}
    return json.loads(json.dumps({k: v for k, v in out.items() if k not in drop and not k.startswith("wall_s")},
                                 default=float))


@pytest.mark.parametrize("name", ["fig03_motivation_ffp", "fig09_area", "fig13_runtime_vs_size",
                                  "fig14_scalability", "fig15_dppu_grouping", "tab01_detection"])
def test_twin_quick_result_equals_reference_benchmark(name):
    """Every number and claim of the twin at quick size equals the reference
    benchmark's own quick run (both deterministic from numpy seeds)."""
    import importlib

    ref = _reference_benchmark(name).run(True)
    twin = importlib.import_module(f"repro_torch.bench.{name}")
    kw = {"device": CPU} if "device" in inspect.signature(twin.run).parameters else {}
    out = twin.run(True, **kw)
    assert out["all_ok"]
    assert _comparable(out) == _comparable(ref)


def test_twin_legacy_engines_equal_reference():
    """The ``engine="legacy"`` paths: fig10's per-config sweep and fig14's
    per-cell loop give the reference's numbers."""
    from repro_torch.bench import fig10_ffp, fig14_scalability

    rfig10 = _reference_benchmark("fig10_ffp")
    rfig14 = _reference_benchmark("fig14_scalability")
    assert fig10_ffp._legacy_tables(40) == rfig10._legacy_tables(40)
    assert fig14_scalability._cell_legacy("clustered", 16, 16, 40) == rfig14._cell_legacy("clustered", 16, 16, 40)
