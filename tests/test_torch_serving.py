"""The port's server held against the JAX server on one trace.

Both serve the same 6 requests (prompt 4, gen 6) with the same weights (the
JAX bundle's params through numpy), in f32, with ``dispatch="fused"``: the
JAX package on its ``ref`` backend, the port on the CPU through the plain
versions of its kernels.  The fault lifecycle is host logic and integer
scans, so events, scan flags, confirmed/repaired sets and summary counters
must be identical.  Tokens must be identical too; since the two sum in
different orders (|Δ logits| <= 2e-5, see test_torch_models.py), every
sampled row's top-2 logit gap is asserted to exceed 1e-4 first, so that a
token mismatch is a real fault and never a tie.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.serving import FaultTolerantServer as JServer
from repro.serving import ModelBundle as JBundle
from repro.serving import ServerConfig as JConfig
from repro.serving.fault_manager import FaultInjector as JInjector
from repro_torch.configs import get_smoke_config
from repro_torch.models.lm import params_from_numpy
from repro_torch.serving import FaultTolerantServer, ModelBundle, ServerConfig
from repro_torch.serving.fault_manager import FaultInjector
from repro_torch.serving.scheduler import DECODE

ARCH = "qwen1.5-0.5b"
BASE = dict(arch=ARCH, n_slots=4, smax=32, rows=4, cols=4, dppu_size=4, dispatch="fused", seed=0)
GAP = 1e-4
BIST = [(0, 1, 30, 1), (1, 2, 31, 0), (3, 3, 20, 1)]  # 3 <= capacity 4

SCENARIOS = {
    "off": ("off", {}, []),
    "protected_bist": ("protected", {}, BIST),
    "protected_wearout": ("protected", {"fault_rate": 0.25}, []),
    # power-on by probe sweeps instead of BIST: the batched boot scan
    "protected_boot_scan": ("protected", {"bist": False, "boot_scan": True}, BIST),
    "unprotected": ("unprotected", {"fault_rate": 0.1}, [(2, 0, 22, 1)]),
}


def _trace():
    rng = np.random.default_rng(42)
    return [{"step": 0, "prompt": rng.integers(0, 512, size=4), "max_new_tokens": 6}
            for _ in range(6)]


@pytest.fixture(scope="module")
def bundles():
    jb = JBundle(JConfig(mode="off", **BASE), lm=dataclasses.replace(j_smoke(ARCH), dtype=jnp.float32))
    tb = ModelBundle(ServerConfig(mode="off", device="cpu", **BASE),
                     lm=dataclasses.replace(get_smoke_config(ARCH), dtype=torch.float32),
                     params=params_from_numpy(jax.tree.map(np.asarray, jb.params), "cpu"))
    return jb, tb


def _run(server_cls, cfg, bundle, injector, faults):
    for r, c, b, v in faults:
        injector.inject_at(r, c, bit=b, val=v)
    srv = server_cls(cfg, bundle=bundle, injector=injector)
    return srv, srv.run(_trace(), max_steps=64)


def _run_port(cfg, bundle, faults):
    """The port's run, recording every step's logits and which rows'
    samples become tokens."""
    injector = FaultInjector(cfg.rows, cfg.cols, seed=cfg.seed + 1)
    for r, c, b, v in faults:
        injector.inject_at(r, c, bit=b, val=v)
    srv = FaultTolerantServer(cfg, bundle=bundle, injector=injector)
    seen = []
    step_fn = bundle.step_fn

    def recording(*a, **kw):
        logits, cache = step_fn(*a, **kw)
        used = [s.request is not None and (s.phase == DECODE or s.pos == s.request.prompt_len - 1)
                for s in srv.scheduler.slots]
        seen.append((logits[:, -1, :512].clone(), used))
        return logits, cache

    bundle.step_fn = recording
    try:
        summary = srv.run(_trace(), max_steps=64)
    finally:
        del bundle.step_fn
    return srv, summary, seen


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_server_matches_jax(bundles, name):
    jb, tb = bundles
    mode, kw, faults = SCENARIOS[name]
    jsrv, jsum = _run(JServer, JConfig(mode=mode, **BASE, **kw), jb,
                      JInjector(4, 4, seed=BASE["seed"] + 1), faults)
    tsrv, tsum, seen = _run_port(ServerConfig(mode=mode, device="cpu", **BASE, **kw), tb, faults)

    # the fault lifecycle: events (kind, step, payload), scan flags, sets
    assert [(e.kind, e.step, e.data) for e in tsrv.log.events] == \
        [(e.kind, e.step, e.data) for e in jsrv.log.events]
    assert [r.scan_ok for r in tsrv.metrics.steps] == [r.scan_ok for r in jsrv.metrics.steps]
    for attr in ("confirmed_coords", "repaired_coords", "retired_coords"):
        assert getattr(tsrv.manager, attr)() == getattr(jsrv.manager, attr)()
    assert tsrv.injector.coords() == jsrv.injector.coords()
    assert np.array_equal(tsrv.manager.hits, jsrv.manager.hits)
    volatile = {"wall_s", "tokens_per_s"}
    assert {k: v for k, v in tsum.items() if k not in volatile} == \
        {k: v for k, v in jsum.items() if k not in volatile}

    # tokens: no sampled row may sit within the tolerance of a tie
    gaps = [float((top[:, 0] - top[:, 1])[used].min())
            for top, used in ((torch.topk(lg, 2, dim=-1).values, torch.tensor(u)) for lg, u in seen)
            if any(used)]
    assert gaps and min(gaps) > GAP, f"top-2 logit gap {min(gaps)} within the tolerance"
    jt, tt = jsrv.completions_by_rid(), tsrv.completions_by_rid()
    assert jt.keys() == tt.keys() and len(tt) == 6
    for rid in jt:
        assert np.array_equal(jt[rid], tt[rid]), rid
    if faults and mode == "protected":
        assert tsrv.manager.n_confirmed == len(faults)


def test_protected_within_capacity_serves_off_tokens(bundles):
    _, tb = bundles
    off, _, _ = _run_port(ServerConfig(mode="off", device="cpu", **BASE), tb, [])
    prot, _, _ = _run_port(ServerConfig(mode="protected", device="cpu", **BASE), tb, BIST)
    bad, _, _ = _run_port(ServerConfig(mode="unprotected", device="cpu", **BASE), tb, BIST)
    a, b, c = off.completions_by_rid(), prot.completions_by_rid(), bad.completions_by_rid()
    assert all(np.array_equal(a[r], b[r]) for r in a)
    assert any(not np.array_equal(a[r], c[r]) for r in a)


def test_fused_grids_built_once_per_fault_state_swap(bundles, monkeypatch):
    """The bundle keeps one FTContext while the server hands it the same
    fault table, so the fused AND/OR grids are built once per swap of the
    table, not once per step."""
    import repro_torch.core.ftcontext as TF

    _, tb = bundles
    builds = []
    real = TF.fault_meta_grid

    def counting(*a, **kw):
        builds.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(TF, "fault_meta_grid", counting)
    swaps, last = [], None
    step_fn = tb.step_fn

    def recording(params, cache, tok, fstate, plan):
        nonlocal last
        if fstate is not last:
            swaps.append(fstate)
            last = fstate
        return step_fn(params, cache, tok, fstate, plan)

    tb._step_ftc = None
    tb.step_fn = recording
    try:
        mode, kw, faults = SCENARIOS["protected_wearout"]
        srv, _ = _run(FaultTolerantServer, ServerConfig(mode=mode, device="cpu", **BASE, **kw), tb,
                      FaultInjector(4, 4, seed=BASE["seed"] + 1), faults)
    finally:
        del tb.step_fn
    steps = len(srv.metrics.steps)
    assert 2 <= len(swaps) < steps
    assert len(builds) == len(swaps)
