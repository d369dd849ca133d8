"""The port's repair package (remap and prune) held against the JAX package.

Same numpy fault maps, salience and params on both sides.  Plans are integer
and boolean tables, so they must be identical.  Matmul outputs are compared
on integer-valued f32 operands (every partial sum exact), so plan gather,
prune and stuck-at must agree bit for bit.  ``weight_salience`` is numpy on
the same f32 leaves on both sides, so it must be identical too: near-ties in
salience decide which classes are victims.  Served runs reuse the harness of
``test_torch_serving.py``: tokens equal under its top-2 gap guard, events,
lifecycle sets and summaries identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import repair as JR
from repro.configs import get_smoke_config as j_smoke
from repro.core import engine as JE
from repro.core.redundancy import DPPUConfig as JDPPU
from repro.models import lm as JL
from repro.serving import FaultTolerantServer as JServer
from repro.serving import ModelBundle as JBundle
from repro.serving import ServerConfig as JConfig
from repro.serving.fault_manager import FaultInjector as JInjector
from repro_torch import repair as TR
from repro_torch.configs import get_smoke_config
from repro_torch.core import engine as TE
from repro_torch.core import ftcontext as TF
from repro_torch.core.redundancy import DPPUConfig as TDPPU
from repro_torch.models import lm as TL
from repro_torch.serving import REMAPPED, FaultTolerantServer, ModelBundle, ServerConfig
from repro_torch.serving.fault_manager import FaultInjector

from test_torch_serving import GAP

ROWS = COLS = 8


def _hyca(mode: str, dppu: int = 4):
    return (JE.HyCAConfig(ROWS, COLS, dppu=JDPPU(size=dppu, group_size=min(8, dppu)), mode=mode),
            TE.HyCAConfig(ROWS, COLS, dppu=TDPPU(size=dppu, group_size=min(8, dppu)), mode=mode))


def _states(n_faults: int, seed: int, pad_to: int | None = None, visible: bool = True):
    """The same seeded fault map as a JAX and a port FaultState."""
    rng = np.random.default_rng(seed)
    fmap = np.zeros((ROWS, COLS), bool)
    fmap.reshape(-1)[rng.choice(ROWS * COLS, size=n_faults, replace=False)] = True
    js = JE.fault_state_from_map(fmap, max_faults=pad_to or max(n_faults, 1), rng=np.random.default_rng(seed))
    fpt, bit, val = (np.asarray(a) for a in (js.fpt, js.stuck_bit, js.stuck_val))
    if visible:
        bit, val = np.full_like(bit, 20), np.ones_like(val)
    return (JE.FaultState(jnp.asarray(fpt), jnp.asarray(bit), jnp.asarray(val)),
            TE.FaultState(*(torch.from_numpy(a.copy()) for a in (fpt, bit, val))))


def _same_plan(jp, tp) -> bool:
    return (np.array_equal(np.asarray(jp.col_map), tp.col_map.numpy())
            and np.array_equal(np.asarray(jp.prune), tp.prune.numpy()))


def _int_operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(-4, 5, (m, k)).astype(np.float32), rng.integers(-4, 5, (k, n)).astype(np.float32))


# --------------------------------------------------------------------------- #
# planners
# --------------------------------------------------------------------------- #
PLAN_CASES = {
    "under_capacity": (4, 1, "random"),      # every fault repaired: identity
    "over_capacity": (11, 2, "random"),
    "ties": (13, 3, "ties"),                # equal salience: stable by class
    "many": (30, 4, "random"),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plans_match_jax(case):
    """Host planner, batched device planner and prune plan: identical
    col_map and prune to the JAX package's, seed by seed."""
    n, seed, kind = PLAN_CASES[case]
    jh, th = _hyca("protected")
    for s in range(seed, seed + 6):
        js, ts = _states(n, s, pad_to=32)
        sal = (np.random.default_rng(s).random(COLS) if kind == "random"
               else np.repeat([0.5, 0.25], COLS // 2))
        jp, tp = JR.remap_plan(js, jh, sal), TR.remap_plan(ts, th, sal)
        assert _same_plan(jp, tp), (case, s)
        assert TR.plan_summary(tp, ts, th) == JR.plan_summary(jp, js, jh)
        assert _same_plan(JR.prune_plan(js, jh), TR.prune_plan(ts, th))
        assert TR.pruned_fraction(ts, th) == JR.pruned_fraction(js, jh)
        assert TR.pruned_pe_fraction(ts, th) == JR.pruned_pe_fraction(js, jh)
        assert np.array_equal(TR.unrepaired_fault_columns(ts, th), JR.unrepaired_fault_columns(js, jh))
        broken = sorted(TR.unrepaired_fault_columns(ts, th).tolist())[:1]
        assert _same_plan(JR.remap_plan(js, jh, sal, broken_cols=broken),
                          TR.remap_plan(ts, th, sal, broken_cols=broken))
        if case == "under_capacity":
            assert torch.equal(tp.col_map, torch.arange(COLS, dtype=torch.int32)) and not tp.prune.any()
    # the batched planner: one call over a batch of fault tables
    pairs = [_states(n, s, pad_to=32) for s in range(seed, seed + 6)]
    sal = np.random.default_rng(seed).random(COLS) if kind == "random" else np.repeat([0.5, 0.25], COLS // 2)
    batch = torch.stack([t.fpt for _, t in pairs])
    tb = TR.remap_plan_device(batch, torch.from_numpy(sal), rows=ROWS, cols=COLS, capacity=th.capacity)
    assert tb.col_map.shape == (6, COLS) and tb.prune.shape == (6, ROWS, COLS)
    for i, (js, _) in enumerate(pairs):
        jd = JR.remap_plan_device(js.fpt, jnp.asarray(sal), rows=ROWS, cols=COLS, capacity=jh.capacity)
        assert _same_plan(jd, TE.RepairPlan(tb.col_map[i], tb.prune[i])), (case, i)


def test_bad_plans_rejected():
    _, th = _hyca("protected")
    _, ts = _states(2, 0)
    x = torch.zeros((8, 8))
    bad = TE.RepairPlan(torch.zeros(COLS, dtype=torch.int32), torch.zeros(COLS, dtype=torch.bool))
    with pytest.raises(ValueError, match="permutation"):
        TE.hyca_matmul(x, x, ts, cfg=th, plan=bad)
    with pytest.raises(ValueError, match="permutation"):
        TF.build_ftcontext(ts, th, plan=bad)
    bad_prune = TE.RepairPlan(torch.arange(COLS, dtype=torch.int32), torch.zeros((), dtype=torch.bool))
    with pytest.raises(ValueError, match="PE mask"):
        TE.hyca_matmul(x, x, ts, cfg=th, plan=bad_prune)
    with pytest.raises(ValueError, match=f"\\({COLS},\\)"):
        TR.remap_plan(ts, th, np.ones(COLS + 1))
    ftc = TF.build_ftcontext(ts, th, dispatch="fused", plan=TE.identity_plan(ROWS, COLS))
    with pytest.raises(ValueError, match="permutation"):
        ftc.swap(plan=bad)
    with pytest.raises(ValueError, match="structure"):
        ftc.swap(plan={"ffn": TE.identity_plan(ROWS, COLS)})


# --------------------------------------------------------------------------- #
# engine and dispatch semantics
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["protected", "unprotected"])
@pytest.mark.parametrize("dispatch", ["twopass", "fused"])
def test_plans_in_the_matmul_match_jax(mode, dispatch):
    """Over capacity: an identity plan is bitwise no plan; a remap plan's
    output is bitwise the JAX engine's with the same plan; int8 too."""
    jh, th = _hyca(mode)
    js, ts = _states(10, 3)
    x, w = _int_operands(24, 16, 2 * COLS + 3)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    ident = TE.identity_plan(ROWS, COLS)
    base = TF.build_ftcontext(ts, th, dispatch=dispatch).matmul(tx, tw, site="ffn")
    same = TF.build_ftcontext(ts, th, dispatch=dispatch, plan=ident).matmul(tx, tw, site="ffn")
    assert torch.equal(base.view(torch.int32), same.view(torch.int32))
    sal = np.random.default_rng(0).random(COLS)
    jp, tp = JR.remap_plan(js, jh, sal), TR.remap_plan(ts, th, sal)
    got = TF.build_ftcontext(ts, th, dispatch=dispatch, plan=tp).matmul(tx, tw, site="ffn")
    want = np.asarray(JE.hyca_matmul(jnp.asarray(x), jnp.asarray(w), js, cfg=jh, plan=jp))
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert not torch.equal(got, base)
    xi, wi = (torch.from_numpy(a.astype(np.int8)) for a in (x, w))
    assert torch.equal(TE.hyca_matmul(xi, wi, ts, cfg=th), TE.hyca_matmul(xi, wi, ts, cfg=th, plan=ident))


def test_prune_zeroes_exactly_sacrificed_pes():
    """Exactly the outputs of the plan's sacrificed PEs are zero; everything
    else is the DPPU-repaired output.  A fault the plan has never seen still
    corrupts: software prunes only what it planned to."""
    _, th = _hyca("protected")
    _, ts = _states(10, 5)
    plan = TR.prune_plan(ts, th)
    pr = plan.prune.numpy()
    assert np.array_equal(np.unique(np.nonzero(pr)[1]), TR.unrepaired_fault_columns(ts, th))
    x, w = (torch.from_numpy(a) for a in _int_operands(16, 16, COLS, seed=1))
    clean = torch.matmul(x, w).numpy()
    out = TE.hyca_matmul(x, w, ts, cfg=th, plan=plan).numpy()
    pos = pr[np.arange(16)[:, None] % ROWS, np.arange(COLS)[None, :]]
    assert pos.any() and np.all(out[pos] == 0.0)
    assert np.array_equal(out[~pos], clean[~pos])
    _, ts_new = _states(12, 11, pad_to=12)
    blind = TE.hyca_matmul(x, w, ts_new, cfg=th, plan=plan).numpy()
    assert ((blind != clean) & ~pos).any()


# --------------------------------------------------------------------------- #
# salience
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-moe-3b-a800m"])
def test_weight_salience_matches_jax(arch):
    """On the bridged smoke params: the port reads its per-layer params as
    the stacked tree the JAX function walks, so salience is identical in
    float64, and so is the plan built from it."""
    cfg = dataclasses.replace(j_smoke(arch), dtype=jnp.float32)
    jparams = JL.init_params(jax.random.key(0), cfg)
    tparams = TL.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    js_, ts_ = JR.weight_salience(jparams, COLS), TR.weight_salience(tparams, COLS)
    assert js_.dtype == ts_.dtype == np.float64 and np.array_equal(js_, ts_)
    jh, th = _hyca("protected", dppu=2)
    jst, tst = _states(9, 4)
    assert _same_plan(JR.remap_plan(jst, jh, js_), TR.remap_plan(tst, th, ts_))
    assert TR.fold_channel_salience(np.arange(10.0), 4).tolist() == [12.0, 15.0, 8.0, 10.0]
    sites = {"attn.qkv": [tparams["blocks"][0]["attn"]["wq"]]}
    want = JR.site_weight_salience({"attn.qkv": [jparams["blocks"]["attn"]["wq"][0]]}, COLS)
    assert np.array_equal(TR.site_weight_salience(sites, COLS)["attn.qkv"], want["attn.qkv"])


def test_salience_probe_matches_jax():
    """The probe records the same sites as the JAX probe: bitwise on an
    integer-valued matmul and einsum, and within 1e-4 relative over a smoke
    decode step (the two sum activations in different orders)."""
    jp, tp = JR.SalienceProbe(cols=COLS), TR.SalienceProbe(cols=COLS)
    x, w = _int_operands(4, 16, 24)
    for probe, X, W in ((jp, jnp.asarray(x), jnp.asarray(w)), (tp, torch.from_numpy(x), torch.from_numpy(w))):
        probe.matmul(X, W, site="ffn")
        probe.matmul(X, W, site="attn.qkv")
        probe.einsum("becd,edf->becf", X.reshape(1, 1, 4, 16), W[None], site="moe.expert")
    assert set(tp.site_salience()) == set(jp.site_salience()) == {"ffn", "attn.qkv", "moe.expert"}
    for site in ("ffn", "attn.qkv", "moe.expert"):
        assert np.array_equal(tp.salience(site), jp.salience(site))
    assert np.array_equal(tp.salience(), jp.salience())
    with pytest.raises(ValueError, match="unknown site"):
        tp.matmul(torch.from_numpy(x), torch.from_numpy(w), site="bogus")

    arch = "qwen1.5-0.5b"
    # the JAX probe reads concrete activations: its layers unrolled, not scanned
    jcfg = dataclasses.replace(j_smoke(arch), dtype=jnp.float32, unroll=True)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    jparams = JL.init_params(jax.random.key(0), jcfg)
    tparams = TL.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tok = np.array([[3], [17]], np.int32)
    jp, tp = JR.SalienceProbe(cols=COLS), TR.SalienceProbe(cols=COLS)
    JL.decode_step(jparams, jcfg, JL.init_cache(jcfg, 2, 8), {"token": jnp.asarray(tok)}, ftc=jp)
    TL.decode_step(tparams, tcfg, TL.init_cache(tcfg, 2, 8, device="cpu"), {"token": torch.from_numpy(tok)}, ftc=tp)
    assert set(tp.site_salience()) == set(jp.site_salience())
    for site, v in jp.site_salience().items():
        np.testing.assert_allclose(tp.salience(site), v, rtol=1e-4)


# --------------------------------------------------------------------------- #
# the served remap path against the JAX server
# --------------------------------------------------------------------------- #
ARCH = "qwen1.5-0.5b"
BASE = dict(arch=ARCH, n_slots=4, smax=32, rows=ROWS, cols=COLS, dppu_size=2, dispatch="fused", seed=0)
# 6 visible faults in 6 columns: 2 repaired, 4 over capacity
SIX = [(0, 1, 20, 1), (1, 2, 21, 1), (2, 4, 22, 0), (3, 5, 20, 1), (0, 6, 21, 0), (1, 7, 22, 1)]
SERVED = {
    # power-on BIST: the plan lands at step 0
    "remap_bist": (dict(repair="remap"), SIX, ()),
    # a remap budget of 2 columns: the overflow retires
    "remap_budget_overflow": (dict(repair="remap", max_remap_fraction=0.25), SIX, ()),
    # faults appear at step 2 and the scan confirms them
    "remap_scan": (dict(repair="remap", scan_block=8, max_remap_fraction=1.0), (), ((2, SIX),)),
    "none_retires": (dict(repair="none"), SIX, ()),
}


def _trace():
    rng = np.random.default_rng(42)
    return [{"step": 0, "prompt": rng.integers(0, 512, size=4), "max_new_tokens": 6} for _ in range(6)]


@pytest.fixture(scope="module")
def bundles():
    jb = JBundle(JConfig(mode="off", **BASE), lm=dataclasses.replace(j_smoke(ARCH), dtype=jnp.float32))
    tb = ModelBundle(ServerConfig(mode="off", device="cpu", **BASE),
                     lm=dataclasses.replace(get_smoke_config(ARCH), dtype=torch.float32),
                     params=TL.params_from_numpy(jax.tree.map(np.asarray, jb.params), "cpu"))
    return jb, tb


def _serve(server_cls, cfg, bundle, injector, faults, inject, record=None):
    for r, c, b, v in faults:
        injector.inject_at(r, c, bit=b, val=v)
    srv = server_cls(cfg, bundle=bundle, injector=injector)

    def hook(s):
        for at, more in inject:
            if s.step_idx == at:
                for r, c, b, v in more:
                    s.injector.inject_at(r, c, bit=b, val=v)
        if record is not None:
            record(s)

    return srv, srv.run(_trace(), max_steps=64, on_step=hook)


@pytest.mark.parametrize("name", list(SERVED))
def test_served_remap_matches_jax(bundles, name):
    jb, tb = bundles
    kw, faults, inject = SERVED[name]
    jsrv, jsum = _serve(JServer, JConfig(mode="protected", **BASE, **kw), jb, JInjector(ROWS, COLS, seed=1),
                        faults, inject)
    seen = []
    step_fn = tb.step_fn

    def recording(*a, **k):
        logits, cache = step_fn(*a, **k)
        seen.append(logits[:, -1, :512].clone())
        return logits, cache

    tb.step_fn = recording
    try:
        tsrv, tsum = _serve(FaultTolerantServer, ServerConfig(mode="protected", device="cpu", **BASE, **kw), tb,
                            FaultInjector(ROWS, COLS, seed=1), faults, inject)
    finally:
        del tb.step_fn
    assert [(e.kind, e.step, e.data) for e in tsrv.log.events] == \
        [(e.kind, e.step, e.data) for e in jsrv.log.events]
    for attr in ("confirmed_coords", "repaired_coords", "remapped_coords", "retired_coords"):
        assert getattr(tsrv.manager, attr)() == getattr(jsrv.manager, attr)(), attr
    assert tsrv.repair_events == jsrv.repair_events
    assert _same_plan(jsrv.plan, tsrv.plan)
    volatile = {"wall_s", "tokens_per_s", "host_phase_ms"}
    assert {k: v for k, v in tsum.items() if k not in volatile} == \
        {k: v for k, v in jsum.items() if k not in volatile}
    # tokens: every decode row's top-2 gap clear of the tolerance first
    gaps = [float((t[:, 0] - t[:, 1]).min()) for t in (torch.topk(lg, 2, dim=-1).values for lg in seen)]
    assert min(gaps) > GAP, f"top-2 logit gap {min(gaps)} within the tolerance"
    jt, tt = jsrv.completions_by_rid(), tsrv.completions_by_rid()
    assert jt.keys() == tt.keys()
    for rid in jt:
        assert np.array_equal(jt[rid], tt[rid]), rid
    if kw["repair"] == "remap":
        assert tsrv.manager.n_remapped > 0 and tsrv.repair_events
        pruned = set(np.nonzero(tsrv.plan.prune.numpy().any(axis=0))[0].tolist())
        assert pruned == set(tsrv.manager.remapped_cols)
        assert tsrv.manager.quality_fraction == 1.0 - len(pruned) / COLS
    if name == "remap_bist":
        assert tsum["effective_slots_final"] == 4 and tsrv.manager.counts()[REMAPPED] == 4
    if name in ("remap_budget_overflow", "none_retires"):
        assert tsrv.manager.retired_coords() and tsrv.manager.surviving_cols < COLS
        assert tsum["effective_slots_final"] < 4


def test_remapped_faults_really_corrupt_without_plan(bundles):
    """The served engine runs mode="unprotected", so a REMAPPED fault left in
    the served state is not absorbed by the engine's DPPU window: defuse the
    plan and its corruption reaches the tokens."""
    _, tb = bundles
    trace = [{"step": 0, "prompt": [1, 2, 3], "max_new_tokens": 6}]
    ref = FaultTolerantServer(ServerConfig(mode="off", device="cpu", **BASE), bundle=tb)
    ref.run(list(trace), max_steps=24)
    cfg = ServerConfig(mode="protected", device="cpu", **{**BASE, "dppu_size": 1}, repair="remap", bist=False)
    srv = FaultTolerantServer(cfg, bundle=tb)
    for r, c in [(0, 2), (1, 4), (0, 5), (1, 6)]:
        srv.injector.inject_at(r, c, bit=30, val=1)
    srv.manager.bist()
    assert srv.manager.n_remapped >= 2
    srv._maybe_repair()
    srv.apply_repair(plan=tb.identity_plan)
    srv.run(list(trace), max_steps=24)
    assert not np.array_equal(ref.completions_by_rid()[0], srv.completions_by_rid()[0])


def test_interleaved_servers_swap_state_and_plan(bundles):
    """One bundle serves a remap server, an unprotected one and an off one,
    a step each in turn: every swap keys on the fault state and the plan, so
    each server's logits equal its run alone on the same bundle, bit for
    bit, and the held grids keep their storage."""
    _, tb = bundles
    cfgs = [ServerConfig(mode=m, device="cpu", **BASE, **kw) for m, kw in
            (("protected", dict(repair="remap")), ("unprotected", {}), ("off", {}))]

    def make(cfg):
        inj = FaultInjector(ROWS, COLS, seed=1)
        for r, c, b, v in SIX:
            inj.inject_at(r, c, bit=b, val=v)
        srv = FaultTolerantServer(cfg, bundle=tb, injector=inj)
        for t in _trace():
            srv.submit(t["prompt"], t["max_new_tokens"])
        return srv

    alone = []
    for cfg in cfgs:
        srv = make(cfg)
        out = []
        while srv.queue.depth() or srv.scheduler.active:
            srv.step()
            out.append(srv.decode.logits.clone())
        alone.append(out)
    grids = tb.ftc._grids[0][1]
    ptrs = [g.data_ptr() for g in grids]
    servers = [make(cfg) for cfg in cfgs]
    together = [[] for _ in cfgs]
    swaps = tb.swaps
    while any(s.queue.depth() or s.scheduler.active for s in servers):
        for s, out in zip(servers, together):
            if s.queue.depth() or s.scheduler.active:
                s.step()
                out.append(s.decode.logits.clone())
    assert tb.swaps - swaps >= len(together[0])
    for a, b in zip(alone, together):
        assert len(a) == len(b) and all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))
    assert [g.data_ptr() for g in tb.ftc._grids[0][1]] == ptrs
    assert not torch.equal(alone[0][-1], alone[2][-1])  # the plan's prune shows
