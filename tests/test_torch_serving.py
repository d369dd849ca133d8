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
    volatile = {"wall_s", "tokens_per_s", "host_phase_ms"}
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


def _cache_tensors(cache):
    return [t for part in cache.values() for layer in part for t in layer.values()]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_static_buffer_step_matches_jax(bundles, name):
    """Every step runs through the server's own step object and its static
    buffers: the token, logits and sampled buffers, every KV-cache tensor
    (lengths included) and the fused mask grids keep their storage for the
    whole run, which is what a captured CUDA graph reads.  On the CPU the
    step runs eagerly and never captures.  The tokens equal the JAX
    server's on the same trace."""
    jb, tb = bundles
    mode, kw, faults = SCENARIOS[name]
    jsrv, _ = _run(JServer, JConfig(mode=mode, **BASE, **kw), jb, JInjector(4, 4, seed=BASE["seed"] + 1), faults)

    cfg = ServerConfig(mode=mode, device="cpu", **BASE, **kw)
    injector = FaultInjector(cfg.rows, cfg.cols, seed=cfg.seed + 1)
    for r, c, b, v in faults:
        injector.inject_at(r, c, bit=b, val=v)
    srv = FaultTolerantServer(cfg, bundle=tb, injector=injector)
    step, cache = srv.decode, srv.cache
    assert step is tb.captured_step(cache) and not step.capture

    def storage():
        return ([t.data_ptr() for t in _cache_tensors(srv.cache)],
                [t.data_ptr() for t in (step.tokens, step.logits, step.sampled, *tb.ftc.mask_grids(tb.identity_plan))])

    before = storage()
    seen = []
    step_fn = tb.step_fn

    def recording(*a, **kw):
        logits, out_cache = step_fn(*a, **kw)
        seen.append((logits is step.logits, out_cache is cache, storage()))
        return logits, out_cache

    tb.step_fn = recording
    try:
        srv.run(_trace(), max_steps=64)
    finally:
        del tb.step_fn
    assert seen and all(a and b and ptrs == before for a, b, ptrs in seen)
    assert step.graph is None and step.captures == step.replays == 0
    jt, tt = jsrv.completions_by_rid(), srv.completions_by_rid()
    assert jt.keys() == tt.keys() and len(tt) == 6
    for rid in jt:
        assert np.array_equal(jt[rid], tt[rid]), rid


def test_fault_state_swap_rewrites_grid_buffers_in_place(bundles):
    """A fault that appears mid-run swaps the server's fault table into the
    bundle's context: the fused AND/OR pair keeps its tensors and now holds
    exactly the grids built afresh from the new fault table."""
    from repro_torch.core.engine import fault_mask_grids, fault_meta_grid

    _, tb = bundles
    and_g, or_g = tb.ftc.mask_grids(tb.identity_plan)
    ptrs = (and_g.data_ptr(), or_g.data_ptr())
    clean = fault_mask_grids(fault_meta_grid(tb.empty_state, tb.hyca, tb.identity_plan))
    srv = FaultTolerantServer(ServerConfig(mode="unprotected", device="cpu", **BASE), bundle=tb,
                              injector=FaultInjector(4, 4, seed=BASE["seed"] + 1))
    swaps = []

    def inject(s):
        if s.step_idx == 3:
            s.injector.inject_at(1, 2, bit=30, val=1)
        swaps.append(tb.swaps)

    srv.run(_trace(), max_steps=64, on_step=inject)
    assert swaps[4] == swaps[3] + 1 == swaps[2] + 1  # the injection swapped, the steps around it did not
    want = fault_mask_grids(fault_meta_grid(srv._current_fstate(), tb.hyca, tb.identity_plan))
    got = tb.ftc.mask_grids(tb.identity_plan)
    assert got[0] is and_g and got[1] is or_g and (and_g.data_ptr(), or_g.data_ptr()) == ptrs
    assert torch.equal(and_g, want[0]) and torch.equal(or_g, want[1])
    assert not (torch.equal(and_g, clean[0]) and torch.equal(or_g, clean[1]))


def test_twopass_step_stays_eager_by_rule():
    """A CUDA graph holds the step under dispatch ``fused`` and ``plain`` on a
    card, never under ``twopass`` (its engine reads the fault table on the
    host on every call) and never on the CPU; asking for a capture there
    raises, and a twopass server serves eagerly."""
    from repro_torch.serving.server import graph_holds

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert graph_holds(cuda, "fused") and graph_holds(cuda, "plain")
    assert not graph_holds(cuda, "twopass") and not graph_holds(cpu, "fused")
    cfg = ServerConfig(**{**BASE, "dispatch": "twopass", "n_slots": 2, "smax": 8}, device="cpu")
    bundle = ModelBundle(cfg, lm=dataclasses.replace(get_smoke_config(ARCH), dtype=torch.float32))
    with pytest.raises(ValueError, match="CUDA graph"):
        bundle.captured_step(bundle.fresh_cache(), capture=True)
    srv = FaultTolerantServer(cfg, bundle=bundle)
    srv.submit([1, 2, 3], max_new_tokens=2)
    srv.step()
    assert not srv.decode.capture and srv.decode.graph is None and srv.decode.captures == 0


def test_decode_step_advances_cache_lengths_in_place():
    """``decode_step`` returns the cache it was given, and every layer's
    ``idx`` keeps its storage while it advances one a step."""
    from repro_torch.models import lm as TL

    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype=torch.float32)
    params = TL.init_params(torch.Generator().manual_seed(0), cfg)
    cache = TL.init_cache(cfg, 2, 8, device="cpu")
    idx = [layer["idx"] for layer in cache["attn"]]
    ptrs = [t.data_ptr() for t in idx]
    for n in range(1, 4):
        _, out = TL.decode_step(params, cfg, cache, {"token": torch.full((2, 1), n)})
        assert out is cache
        assert all(layer["idx"] is t and t.data_ptr() == p and t.tolist() == [n, n]
                   for layer, t, p in zip(cache["attn"], idx, ptrs))
