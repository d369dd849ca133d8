"""The port's checkpoint store, memory-fault path, retrain and the
``repair="retrain"`` server, held against the JAX package.

Checkpoints are interchangeable: the port keeps a layer stack as a list of
per-layer dicts and writes it as the reference's stacked leaves, so one
state saved by either package has the same leaf names, shapes, dtypes,
sha256 digests and ``tree_hash``, and restores bit for bit in the other.
Retraining is held against a reference loop composed from ``loss_fn``,
``adamw_update``, ``cosine_warmup`` and ``grad_mask`` (the reference's own
``retrain`` needs its mesh path, which is red: ROADMAP C2), with the
tolerances of ``test_torch_train.py``.
"""
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as JS
from repro.configs import get_smoke_config as j_smoke
from repro.core import engine as JE
from repro.core.ftcontext import build_ftcontext as j_build
from repro.core.redundancy import DPPUConfig as JDPPU
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import lm as JL
from repro.obs.events import EventLog as JEventLog
from repro.obs.events import memory_fault_records as j_records
from repro.optim import adamw as JO
from repro.repair import remap as JRemap
from repro.repair.retrain import RetrainConfig as JRetrainConfig
from repro.repair.retrain import grad_mask as j_grad_mask
from repro.transient import memory as JM
from repro_torch.checkpoint import store as TS
from repro_torch.configs import get_smoke_config
from repro_torch.core import engine as TE
from repro_torch.core.redundancy import DPPUConfig as TDPPU
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as TT
from repro_torch.models import lm as TL
from repro_torch.obs.events import EventLog, memory_fault_records
from repro_torch.optim import adamw as TO
from repro_torch.repair import remap as TRemap
from repro_torch.repair.plan import remap_plan
from repro_torch.repair.retrain import RetrainConfig, retrain
from repro_torch.serving import FaultInjector, FaultTolerantServer, ModelBundle, ServerConfig
from repro_torch.transient import memory as TM
from repro_torch.tree import tree_leaves

from test_torch_train import LOSS_TOL, PARAM_TOL, _jax_step

ARCHS = {"dense": "qwen1.5-0.5b", "moe": "deepseek-moe-16b"}


def _jax_state(family, compress=False):
    cfg = j_smoke(ARCHS[family])
    params = JL.init_params(jax.random.key(1), cfg)
    state = {"params": params, "opt": JO.adamw_init(params)}
    state["opt"]["step"] = jnp.asarray(7, jnp.int32)
    state["opt"]["gnorm"] = jnp.asarray(0.25, jnp.float32)
    state["opt"]["m"] = jax.tree.map(lambda a: a * 0.5, params)
    if compress:
        state["ef"] = jax.tree.map(lambda a: a * -0.1, params)
    return state


def _port_state(jstate):
    """The reference state in the port's layout: every params-shaped tree
    bridged with ``params_from_numpy``, the scalars as 0-d tensors."""
    out = {}
    for k, v in jstate.items():
        if k == "opt":
            out[k] = {kk: (TL.params_from_numpy(jax.tree.map(np.asarray, vv), "cpu") if isinstance(vv, dict)
                           else torch.from_numpy(np.array(vv))) for kk, vv in v.items()}
        else:
            out[k] = TL.params_from_numpy(jax.tree.map(np.asarray, v), "cpu")
    return out


def _same_trees(jtree, ttree) -> bool:
    """The JAX tree and the port tree hold the same bits, leaf for leaf in
    the reference's order."""
    from repro_torch.tree import stacked_leaves

    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = stacked_leaves(ttree)
    if len(jl) != len(tl):
        return False
    for (jp, a), (tp, ts, stacked) in zip(jl, tl):
        b = np.stack([t.numpy() for t in ts]) if stacked else ts[0].numpy()
        a = np.asarray(a)
        if JS._leaf_name(jp) != TS._leaf_name(tp) or a.dtype != b.dtype or not np.array_equal(a, b):
            return False
    return True


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


# --------------------------------------------------------------------------- #
# the store
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("family", sorted(ARCHS))
def test_checkpoint_cross_package_bitwise(tmp_path, family):
    """The same state saved by each package: the same leaf names, shapes,
    dtypes, digests and tree hash; each restores bit for bit in the other."""
    jstate = _jax_state(family, compress=True)
    tstate = _port_state(jstate)
    assert _same_trees(jstate, tstate)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    JS.save(jd, 3, jstate, {"arch": family})
    TS.save(td, 3, tstate, {"arch": family})
    jm, tm = _manifest(jd, 3), _manifest(td, 3)
    assert jm == tm
    assert len(jm["leaves"]) == len(jax.tree.leaves(jstate))
    # JAX -> port: into the port's structure, bit for bit
    got = TS.restore(jd, 3, tstate)
    assert _same_trees(jstate, got)
    assert all(t.device.type == "cpu" for t in tree_leaves(got))
    # port -> JAX
    back = JS.restore(td, 3, jstate)
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) and np.asarray(a).dtype == np.asarray(b).dtype
               for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(back)))


def test_checkpoint_round_trip_atomic_and_gc(tmp_path):
    tstate = _port_state(_jax_state("dense"))
    d = str(tmp_path)
    TS.save(d, 1, tstate)
    # a killed writer's staging directory and a step without a manifest stay invisible
    os.makedirs(tmp_path / ".tmp-step_00000002")
    os.makedirs(tmp_path / "step_00000005")
    assert TS.latest_step(d) == 1
    out = TS.restore(d, 1, tstate)
    assert all(torch.equal(a, b) and a.dtype == b.dtype for a, b in zip(tree_leaves(tstate), tree_leaves(out)))
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        bad = json.load(f)
    bad["tree_hash"] = "0" * 16
    shutil.copytree(tmp_path / "step_00000001", tmp_path / "step_00000003")
    with open(tmp_path / "step_00000003" / "manifest.json", "w") as f:
        json.dump(bad, f)
    assert TS.latest_step(d) == 1
    with pytest.raises(ValueError, match="manifest hash mismatch"):
        TS.restore(d, 3, tstate)
    wrong = dict(tstate, params=dict(tstate["params"], embed=torch.zeros(3, 3)))
    with pytest.raises(ValueError, match="shape"):
        TS.restore(d, 1, wrong)
    mgr = TS.CheckpointManager(str(tmp_path / "mgr"), every=2, keep=2)
    for step in range(1, 8):
        mgr.maybe_save(step, tstate)
    assert sorted(os.listdir(tmp_path / "mgr")) == ["step_00000004", "step_00000006"]
    s, resumed = mgr.resume(tstate, device="cpu")
    assert s == 6 and all(torch.equal(a, b) for a, b in zip(tree_leaves(tstate), tree_leaves(resumed)))
    with pytest.raises(TypeError, match="bfloat16"):
        TS.save(d, 9, {"w": torch.zeros(2, dtype=torch.bfloat16)})


def test_restart_is_bitexact(tmp_path):
    """2 steps, a checkpoint, a restore into a fresh state, 2 more steps:
    bit for bit the straight 4-step run (protected, twopass, compression)."""
    cfg = get_smoke_config("qwen1.5-0.5b")
    tc = TT.TrainConfig(n_micro=2, opt=TO.AdamWConfig(lr=1e-3), warmup=1, total_steps=4,
                        grad_compress_ratio=0.5, hyca_mode="protected")
    hyca = TE.HyCAConfig(32, 32, mode="protected")
    fstate = TT.cli_fault_state(4, 0, device="cpu")
    data = SyntheticLM(DataConfig(seed=0, batch=4, seq_len=8), cfg)
    step = TT.make_train_step(cfg, tc, hyca=hyca)

    def run(state, lo, hi):
        for i in range(lo, hi):
            state, _ = step(state, TT.batch_to(data.batch(i), "cpu"), fstate)
        return state

    def fresh():
        return TT.init_state(torch.Generator().manual_seed(0), cfg, tc)

    straight = run(fresh(), 0, 4)
    half = run(fresh(), 0, 2)
    TS.save(str(tmp_path), 2, half)
    resumed = run(TS.restore(str(tmp_path), 2, fresh()), 2, 4)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(straight), tree_leaves(resumed)))
    assert int(resumed["opt"]["step"]) == 4


# --------------------------------------------------------------------------- #
# the memory-fault path
# --------------------------------------------------------------------------- #
def test_memory_faults_match_jax(tmp_path):
    """Tamper, detect, re-fetch from a pristine copy, then tamper and refuse
    with no source: the same leaves, the same events and the same
    ``memory_fault_records`` as the reference on the same sequence."""
    jstate = _jax_state("dense")
    tstate = _port_state(jstate)
    out = {}
    for name, store, mem, log, records, state in (
            ("jax", JS, JM, JEventLog(), j_records, jstate),
            ("port", TS, TM, EventLog(), memory_fault_records, tstate)):
        d, mirror = str(tmp_path / name), str(tmp_path / (name + "_mirror"))
        store.save(d, 4, state)
        store.save(mirror, 4, state)
        rng = np.random.default_rng(11)
        assert mem.checkpoint_leaves(d, 4) == sorted(_manifest(d, 4)["leaf_sha256"])
        chosen = mem.tamper_checkpoint(d, 4, rng, n_leaves=2, n_bits=3)
        assert sorted(store.corrupt_leaves(d, 4)) == sorted(chosen)
        log.step = 4
        restored = mem.guarded_restore(d, 4, state, log=log, fetch=mem.pristine_fetcher(mirror))
        assert store.corrupt_leaves(d, 4) == []
        chosen2 = mem.tamper_checkpoint(d, 4, rng, n_leaves=1)
        with pytest.raises(ValueError, match="refused"):
            mem.guarded_restore(d, 4, state, log=log)
        with pytest.raises(ValueError, match="hash mismatch"):
            store.restore(d, 4, state)
        out[name] = (chosen, chosen2, records(log), [(e.kind, e.step, e.data) for e in log.events], restored)
    assert out["jax"][:4] == out["port"][:4]
    recs = out["port"][2]
    assert {r["outcome"] for r in recs} == {"refetched", "refused"}
    assert _same_trees(jstate, out["port"][4])


# --------------------------------------------------------------------------- #
# retrain, the retrain server, the salience probe
# --------------------------------------------------------------------------- #
ROWS = COLS = 8
FAULTS = [(0, 1, 20, 1), (1, 2, 21, 1), (2, 4, 22, 0), (3, 5, 20, 1), (0, 6, 21, 0), (1, 7, 22, 1)]


def _fault_states():
    fmap = np.zeros((ROWS, COLS), bool)
    for r, c, _, _ in FAULTS:
        fmap[r, c] = True
    js = JE.fault_state_from_map(fmap, max_faults=16)
    fpt = np.asarray(js.fpt)
    bits, vals = np.zeros(16, np.int32), np.zeros(16, np.int32)
    for i, (r, c) in enumerate(fpt[:len(FAULTS)]):
        _, _, bits[i], vals[i] = next(f for f in FAULTS if f[:2] == (r, c))
    return (JE.FaultState(jnp.asarray(fpt), jnp.asarray(bits), jnp.asarray(vals)),
            TE.FaultState(torch.from_numpy(fpt.copy()), torch.from_numpy(bits), torch.from_numpy(vals)))


@pytest.mark.parametrize("layer_range", [None, (1, 2)])
def test_retrain_matches_composed_jax_loop(layer_range):
    """``retrain`` against the reference's step composed in the test, with
    the remap plan of the same salience, faults past the DPPU, the FFN
    trainable: losses, repaired params, and every frozen leaf bit for bit."""
    jcfg = dataclasses.replace(j_smoke("qwen1.5-0.5b"), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_smoke_config("qwen1.5-0.5b"), dtype=torch.float32)
    jparams = JL.init_params(jax.random.key(0), jcfg)
    tparams = TL.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jst, tst = _fault_states()
    jh = JE.HyCAConfig(ROWS, COLS, JDPPU(size=2, group_size=2), "unprotected")
    th = TE.HyCAConfig(ROWS, COLS, TDPPU(size=2, group_size=2), "unprotected")
    sal = TRemap.weight_salience(tparams, COLS)
    plan = remap_plan(tst, th, sal)
    from repro.repair.plan import remap_plan as j_remap_plan

    jplan = j_remap_plan(jst, jh, JRemap.weight_salience(jparams, COLS))
    assert np.array_equal(np.asarray(jplan.col_map), plan.col_map.numpy())
    rc = RetrainConfig(steps=3, lr=2e-3, batch=4, seq_len=8, layer_range=layer_range)
    new, report = retrain(tparams, tcfg, hyca=th, state=tst, plan=plan, rc=rc)
    # the reference's loop, composed
    tc = TT.TrainConfig(n_micro=1, opt=TO.AdamWConfig(lr=rc.lr), warmup=1, total_steps=rc.steps,
                        hyca_mode="protected", hyca_dispatch="twopass")
    jf = j_build(jst, dataclasses.replace(jh, mode="protected"), dispatch="twopass", plan=jplan)
    jmask = j_grad_mask(jparams, JRetrainConfig(steps=3, lr=2e-3, batch=4, seq_len=8, layer_range=layer_range))
    data = JSyntheticLM(JDataConfig(seed=0, batch=4, seq_len=8), jcfg)
    jp, jopt = jparams, JO.adamw_init(jparams)
    losses = []
    for i in range(rc.steps):
        jp, jopt, _, m = _jax_step(jp, jopt, None, jax.tree.map(jnp.asarray, data.batch(i)), jcfg, tc, jf, jmask)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(report["losses"], losses, rtol=LOSS_TOL["f32"])
    got = TL.params_to_numpy(new)
    origs = jax.tree.leaves(jparams)
    for (path, a), b, orig in zip(jax.tree_util.tree_flatten_with_path(jp)[0], jax.tree.leaves(got), origs):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=PARAM_TOL * rc.lr)
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        orig = np.asarray(orig)
        if "ffn" not in name:
            assert np.array_equal(b, orig), name  # frozen: bit for bit
        elif layer_range is not None:
            assert np.array_equal(b[0], orig[0]) and not np.array_equal(b[1], orig[1]), name
    # the caller's params are left as they were
    assert _same_trees(jparams, tparams)


SERVE = dict(arch="qwen1.5-0.5b", n_slots=4, smax=32, rows=ROWS, cols=COLS, dppu_size=2, dispatch="fused",
             seed=0, device="cpu")


def _trace():
    rng = np.random.default_rng(42)
    return [{"step": 0, "prompt": rng.integers(0, 512, size=4), "max_new_tokens": 6} for _ in range(4)]


def _serve(bundle, repair, faults_at=1, **kw):
    inj = FaultInjector(ROWS, COLS, seed=1)
    srv = FaultTolerantServer(ServerConfig(mode="protected", repair=repair, **SERVE, **kw), bundle=bundle,
                              injector=inj)

    def hook(s):
        if s.step_idx == faults_at:
            for r, c, b, v in FAULTS:
                s.injector.inject_at(r, c, bit=b, val=v)
            s.manager.bist()

    srv.run(_trace(), max_steps=64, on_step=hook)
    return srv


def test_retrain_server_swaps_its_own_params():
    """``repair="retrain"``: the plan and a fine-tune of this server's f32
    masters at the repair step; its step reads its own working copies from
    then on, its sibling on the same bundle serves bitwise what a fresh
    server serves, and the bundle's params are untouched."""
    lm = dataclasses.replace(get_smoke_config("qwen1.5-0.5b"), dtype=torch.float32)
    bundle = ModelBundle(ServerConfig(mode="off", **SERVE), lm=lm)
    masters = [t.clone() for t in tree_leaves(bundle.params)]
    rt = _serve(bundle, "retrain", retrain_steps=2)
    ev = rt.repair_events
    assert len(ev) == 1 and ev[0]["retrained"] and ev[0]["mode"] == "retrain" and ev[0]["step"] == 1
    assert rt.params is not bundle.work and rt.decode.params is rt.params
    assert rt.master_params is not bundle.params
    assert len(rt.retrain_reports) == 1 and len(rt.retrain_reports[0]["losses"]) == 2
    # the fine-tune is retrain() on the bundle's masters, the confirmed
    # faults and the plan the hook swapped in
    want, _ = retrain(bundle.params, lm, hyca=bundle.hyca, state=rt.manager.confirmed_state, plan=rt.plan,
                      rc=RetrainConfig(steps=2, seq_len=min(32, SERVE["smax"]), seed=0))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(want), tree_leaves(rt.master_params)))
    moved = [not torch.equal(a, b) for a, b in zip(masters, tree_leaves(rt.master_params))]
    assert any(moved) and not all(moved)
    # the bundle's params stay, and a sibling serves what a fresh server serves
    assert all(torch.equal(a, b) for a, b in zip(masters, tree_leaves(bundle.params)))
    sib = _serve(bundle, "remap")
    fresh = _serve(ModelBundle(ServerConfig(mode="off", **SERVE), lm=lm,
                               params=TL.params_from_numpy(TL.params_to_numpy(bundle.params), "cpu")), "remap")
    assert sib.decode.params is bundle.work
    st, ft = sib.completions_by_rid(), fresh.completions_by_rid()
    assert st.keys() == ft.keys() and all(np.array_equal(st[r], ft[r]) for r in st)
    assert rt.completions_by_rid().keys() == st.keys()
    # the retrained server read its own working copies of the moved masters
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(rt.params), tree_leaves(bundle.work)))
    # the step refuses params that are not its own
    with pytest.raises(ValueError, match="its own working params"):
        bundle.step_fn(bundle.work, rt.cache, torch.zeros((4, 1), dtype=torch.int32), bundle.empty_state,
                       bundle.identity_plan)


def test_salience_probe_through_forward_matches_jax():
    """The probe threaded through the port's sequence forward records the
    reference's salience at every site (the JAX layers unrolled, so its
    probe reads concrete activations), within 1e-4 relative."""
    jcfg = dataclasses.replace(j_smoke("granite-moe-3b-a800m"), dtype=jnp.float32, unroll=True)
    tcfg = dataclasses.replace(get_smoke_config("granite-moe-3b-a800m"), dtype=torch.float32)
    jparams = JL.init_params(jax.random.key(0), jcfg)
    tparams = TL.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tok = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    jp, tp = JRemap.SalienceProbe(cols=COLS), TRemap.SalienceProbe(cols=COLS)
    JL.forward(jparams, jcfg, {"tokens": jnp.asarray(tok)}, ftc=jp)
    with torch.no_grad():
        TL.forward(tparams, tcfg, {"tokens": torch.from_numpy(tok)}, ftc=tp)
    assert set(tp.site_salience()) == set(jp.site_salience()) == {"attn.qkv", "attn.out", "moe.router",
                                                                   "moe.expert", "head"}
    for site, v in jp.site_salience().items():
        np.testing.assert_allclose(tp.salience(site), v, rtol=1e-4)
    np.testing.assert_allclose(tp.salience(), jp.salience(), rtol=1e-4)


def test_memory_fault_records_on_a_log_match_jax():
    """``memory_fault_records`` on one hand-made event sequence."""
    seq = [(3, "a", "detected"), (3, "b", "detected"), (3, "a", "refetched"), (None, "b", "refused"),
           (5, "c", "detected")]
    logs = (JEventLog(), EventLog())
    for log in logs:
        for step, leaf, action in seq:
            log.step = step
            log.emit("memory.fault", leaf=leaf, action=action)
    assert memory_fault_records(logs[1]) == j_records(logs[0])
    assert [r["outcome"] for r in memory_fault_records(logs[1])] == ["refetched", "refused", "detected"]
