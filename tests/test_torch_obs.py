"""The port's observability layer held against the JAX package: the engine's
element counts, the call ledger, the counters, the telemetry series and what
the host derives from a served run (spans, replay timeline, exporter text).

Counts are integers and the ledger is shapes, so they must be identical; a
served run compares everything the host records (events without their wall
timestamps, summary, counters, series, spans, timeline, Prometheus text).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.core import engine as JE
from repro.core.redundancy import DPPUConfig as JDPPU
from repro.obs import counters as JC
from repro.obs import export as JX
from repro.obs import replay as JRP
from repro.obs import trace as JT
from repro.serving import FaultTolerantServer as JServer
from repro.serving import ModelBundle as JBundle
from repro.serving import ServerConfig as JConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core import engine as TE
from repro_torch.core import ftcontext as TF
from repro_torch.core.redundancy import DPPUConfig as TDPPU
from repro_torch.models import lm as TL
from repro_torch.obs import counters as TC
from repro_torch.obs import export as TX
from repro_torch.obs import replay as TRP
from repro_torch.obs import trace as TT
from repro_torch.serving import FaultTolerantServer, ModelBundle, ServerConfig

QWEN, GRANITE = "qwen1.5-0.5b", "granite-moe-3b-a800m"


def _state(rows, cols, n, seed, pad_to=8):
    rng = np.random.default_rng(seed)
    fmap = np.zeros((rows, cols), bool)
    fmap.reshape(-1)[rng.choice(rows * cols, size=n, replace=False)] = True
    js = JE.fault_state_from_map(fmap, max_faults=pad_to, rng=rng)
    arrs = [np.asarray(a) for a in (js.fpt, js.stuck_bit, js.stuck_val)]
    return fmap, js, TE.FaultState(*(torch.from_numpy(a.copy()) for a in arrs))


def _plan(rows, cols, seed):
    rng = np.random.default_rng(seed)
    cm, pr = rng.permutation(cols).astype(np.int32), rng.random((rows, cols)) < 0.3
    return cm, pr, JE.RepairPlan(jnp.asarray(cm), jnp.asarray(pr)), TE.RepairPlan(torch.from_numpy(cm),
                                                                                  torch.from_numpy(pr))


# --------------------------------------------------------------------------- #
# counters and the engine's element counts
# --------------------------------------------------------------------------- #
def test_counters_zero_and_to_host():
    c = TC.Counters.zero()
    assert c.values.dtype == torch.int32 and c.to_host() == JC.Counters.zero().to_host()
    h = c.to_host()
    assert h["steps"] == 0 and h["fault_fraction"] == 0.0 and set(h["site_calls"]) == set(TF.SITES)
    assert int(c.steps) == 0 and set(c.site_calls) == set(TF.SITES)


def _brute_force(fmap, repaired, col_map, prune, m, n, rows, cols):
    out = dict.fromkeys(("fault_elems", "recomputed_elems", "corrupted_elems", "pruned_elems",
                         "fault_col_elems"), 0)
    corrupting = fmap & ~repaired & ~prune
    for i in range(m):
        for j in range(n):
            pr, pc = i % rows, int(col_map[j % cols])
            out["fault_elems"] += int(fmap[pr, pc])
            out["recomputed_elems"] += int(fmap[pr, pc] and repaired[pr, pc])
            out["corrupted_elems"] += int(corrupting[pr, pc])
            out["pruned_elems"] += int(prune[pr, pc])
            out["fault_col_elems"] += int(corrupting[:, pc].any())
    return out


@pytest.mark.parametrize("mode", ["protected", "unprotected", "off"])
@pytest.mark.parametrize("with_plan", [False, True])
def test_protected_view_stats_match_jax_and_brute_force(mode, with_plan):
    rows = cols = 4
    m, n = 10, 13  # not multiples of the array's dims
    jh = JE.HyCAConfig(rows, cols, dppu=JDPPU(size=2, group_size=2), mode=mode)
    th = TE.HyCAConfig(rows, cols, dppu=TDPPU(size=2, group_size=2), mode=mode)
    fmap, js, ts = _state(rows, cols, 5, seed=3)
    col_map, prune, jp, tp = _plan(rows, cols, 4) if with_plan else (
        np.arange(cols), np.zeros((rows, cols), bool), None, None)
    got = {k: v for k, v in TE.protected_view_stats(ts, th, tp, m, n).items()}
    assert all(v.dtype == torch.int32 and v.dim() == 0 for v in got.values())
    got = {k: int(v) for k, v in got.items()}
    assert got == {k: int(v) for k, v in JE.protected_view_stats(js, jh, jp, m, n).items()}
    assert got["total_elems"] == m * n
    if mode == "off":
        assert all(v == 0 for k, v in got.items() if k != "total_elems")
        return
    repaired = np.zeros((rows, cols), bool)
    if mode == "protected":
        for r, c in ts.fpt.numpy()[: th.capacity]:
            if r >= 0:
                repaired[r, c] = True
    want = _brute_force(fmap, repaired, col_map, prune, m, n, rows, cols)
    assert {k: got[k] for k in want} == want


# --------------------------------------------------------------------------- #
# the call ledger
# --------------------------------------------------------------------------- #
LEDGER_CASES = {
    "qwen_fused": (QWEN, "fused", 1.0),
    "qwen_twopass_half": (QWEN, "twopass", 0.5),
    "qwen_plain": (QWEN, "plain", 1.0),
    "granite_fused": (GRANITE, "fused", 1.0),
}
SMALL = dict(n_slots=3, smax=16, rows=4, cols=4, dppu_size=2, seed=0)


def _as_tuple(ledger):
    return [(c.site, c.m, c.n, c.count, c.dispatch, c.protected) for c in ledger]


@pytest.fixture(scope="module")
def ledgers():
    """{case: (JAX bundle, port bundle)} with the same params."""
    out = {}
    for case, (arch, dispatch, frac) in LEDGER_CASES.items():
        kw = dict(arch=arch, dispatch=dispatch, protect_fraction=frac, **SMALL)
        jb = JBundle(JConfig(mode="off", counters=True, **kw), lm=dataclasses.replace(j_smoke(arch), dtype=jnp.float32))
        tb = ModelBundle(ServerConfig(mode="off", device="cpu", **kw),
                         lm=dataclasses.replace(get_smoke_config(arch), dtype=torch.float32),
                         params=TL.params_from_numpy(jax.tree.map(np.asarray, jb.params), "cpu"))
        out[case] = (jb, tb)
    return out


@pytest.mark.parametrize("case", list(LEDGER_CASES))
def test_ledger_matches_jax(ledgers, case):
    """The port records one decode step on the meta device; the JAX package
    traces it with eval_shape through its layer scans.  Row for row equal."""
    jb, tb = ledgers[case]
    assert tb.ftc.ledger is None
    assert _as_tuple(tb.ledger) == _as_tuple(jb.ftc.ledger)
    assert tb.ftc.ledger is tb.ledger  # recorded once, attached to the context
    if LEDGER_CASES[case][1] == "plain":
        assert all(not c.protected and c.dispatch == "plain" for c in tb.ledger)


@pytest.mark.parametrize("case", ["qwen_fused", "qwen_plain", "granite_fused"])
@pytest.mark.parametrize("mode", ["protected", "unprotected"])
def test_ledger_stats_match_jax(ledgers, case, mode):
    """Two steps' accumulation over the same ledger, fault state (over
    capacity) and remap plan: identical to the JAX counters, and the
    context's increment tensor is rewritten in place by a swap."""
    jb, tb = ledgers[case]
    jl = tuple(JC.SiteCall(*row) for row in _as_tuple(tb.ledger))
    jh = dataclasses.replace(jb.hyca, mode=mode)
    th = dataclasses.replace(tb.hyca, mode=mode)
    _, js, ts = _state(4, 4, 5, seed=7)
    _, _, jp, tp = _plan(4, 4, 2)
    jc = JC.ledger_stats(jl, JC.ledger_stats(jl, JC.Counters.zero(), js, jp, jh), js, jp, jh)
    tc = TC.ledger_stats(tb.ledger, TC.ledger_stats(tb.ledger, TC.Counters.zero(), ts, tp, th), ts, tp, th)
    assert tc.to_host() == jc.to_host()
    ftc = TF.build_ftcontext(TE.empty_fault_state(8), th, dispatch=tb.cfg.dispatch,
                             plan=TE.identity_plan(4, 4)).with_ledger(tb.ledger)
    inc = ftc.increment()
    ftc.swap(state=ts, plan=tp)
    assert ftc.increment() is inc
    c = ftc.with_counters(TC.Counters.zero())
    assert c.accumulate().to_host() == JC.ledger_stats(jl, JC.Counters.zero(), js, jp, jh).to_host()


def test_elems_on_coords_match_jax(ledgers):
    _, tb = ledgers["qwen_fused"]
    jl = tuple(JC.SiteCall(*row) for row in _as_tuple(tb.ledger))
    for coords in (set(), {(0, 0)}, {(1, 3), (2, 2)}, {(r, c) for r in range(4) for c in range(4)}):
        assert TC.elems_on_coords(tb.ledger, coords, 4, 4) == JC.elems_on_coords(jl, coords, 4, 4)
    full = TC.elems_on_coords(tb.ledger, {(r, c) for r in range(4) for c in range(4)}, 4, 4)
    assert full == sum(c.m * c.n * c.count for c in tb.ledger if c.protected)


# --------------------------------------------------------------------------- #
# a served run with counters and series, against the JAX server
# --------------------------------------------------------------------------- #
SRV = dict(arch=QWEN, n_slots=2, smax=24, rows=4, cols=4, dppu_size=1, scan_block=4, confirm_hits=2,
           dispatch="fused", repair="remap", max_remap_fraction=1.0, seed=0)


def _chaos(s):
    if s.step_idx == 2:
        for col in range(3):          # 3 faults > DPPU capacity 1: remapped
            s.injector.inject_at(1, col, bit=22, val=1)
        s.log.emit("chaos.injected", n=3)


def _trace(n=3):
    rng = np.random.default_rng(7)
    return [{"step": 0, "prompt": rng.integers(0, 512, size=3), "max_new_tokens": 8} for _ in range(n)]


@pytest.fixture(scope="module")
def served():
    """The JAX and the port server on one chaos trace (3 faults past
    capacity at step 2, found by the scan, remapped), counters and series
    on; and the port server again with both off, every step's logits kept."""
    jb = JBundle(JConfig(mode="protected", counters=True, **SRV),
                 lm=dataclasses.replace(j_smoke(QWEN), dtype=jnp.float32))
    tb = ModelBundle(ServerConfig(mode="protected", device="cpu", **SRV),
                     lm=dataclasses.replace(get_smoke_config(QWEN), dtype=torch.float32),
                     params=TL.params_from_numpy(jax.tree.map(np.asarray, jb.params), "cpu"))
    jsrv = JServer(JConfig(mode="protected", counters=True, series=True, **SRV), bundle=jb)
    jsum = jsrv.run(_trace(), max_steps=40, on_step=_chaos)
    runs = {}
    for on in (True, False):
        srv = FaultTolerantServer(ServerConfig(mode="protected", device="cpu", counters=on, series=on, **SRV),
                                  bundle=tb)
        logits = []
        summary = srv.run(_trace(), max_steps=40,
                          on_step=lambda s, lg=logits: (_chaos(s), s.step_idx and lg.append(s.decode.logits.clone())))
        logits.append(srv.decode.logits.clone())
        runs[on] = (srv, summary, logits)
    return jsrv, jsum, runs


def _events(log):
    return [(e.kind, e.step, e.data) for e in log.events]


def test_served_counters_and_series_match_jax(served):
    jsrv, jsum, runs = served
    tsrv, tsum, _ = runs[True]
    assert _events(tsrv.log) == _events(jsrv.log)
    assert tsrv.repair_events and tsrv.repair_events == jsrv.repair_events
    assert tsum == {**jsum, "wall_s": tsum["wall_s"], "tokens_per_s": tsum["tokens_per_s"],
                    "host_phase_ms": tsum["host_phase_ms"]}
    assert tsrv.counters_host() == jsrv.counters_host() == tsum["counters"]
    c = tsum["counters"]
    assert c["steps"] == tsum["steps"] and c["pruned_elems"] > 0 and c["corrupted_elems"] > 0
    assert c["protected_calls"] == c["steps"] * sum(r.count for r in tsrv.bundle.ledger if r.protected)
    th, jh = tsrv.series_host(), jsrv.series_host()
    assert th.keys() == jh.keys() and len(th["tokens"]) == tsum["steps"]
    for k in jh:
        assert th[k].dtype == np.asarray(jh[k]).dtype and np.array_equal(th[k], jh[k]), k
    assert tsrv.series_start_step() == jsrv.series_start_step() == 0
    assert th["tokens"].tolist() == [r.tokens_generated for r in tsrv.metrics.steps]


def test_counters_and_series_off_serve_the_same_bits(served):
    _, _, runs = served
    (on, son, lon), (off, soff, loff) = runs[True], runs[False]
    assert off.counters_host() is None and off.series_host() is None and "counters" not in soff
    wall = ("wall_s", "tokens_per_s", "host_phase_ms")
    assert {k: v for k, v in son.items() if k not in ("counters",) + wall} == \
        {k: v for k, v in soff.items() if k not in wall}
    assert len(lon) == len(loff) == son["steps"]
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(lon, loff))


def test_spans_timeline_and_prometheus_match_jax(served, tmp_path):
    """What the host derives from the two runs' logs and series: spans,
    the replay timeline (with the series joined) and the exporter text."""
    jsrv, jsum, runs = served
    tsrv, tsum, _ = runs[True]
    tspans = [s.to_json() for t in TT.build_traces(tsrv.log) for s in t.spans]
    jspans = [s.to_json() for t in JT.build_traces(jsrv.log) for s in t.spans]
    assert tspans == jspans and any(s["name"] == "repair" for s in tspans)
    ttl = TRP.build_timeline(tsrv.log, tsrv.series_host(), start_step=tsrv.series_start_step())
    jtl = JRP.build_timeline(jsrv.log, jsrv.series_host(), start_step=jsrv.series_start_step())
    assert ttl == jtl and ttl["incidents"][0]["repair_plan_step"] is not None
    assert TRP.render_text(ttl) == JRP.render_text(jtl)
    summary = {k: v for k, v in tsum.items() if k not in ("wall_s", "tokens_per_s", "host_phase_ms")}
    labels = {"arch": QWEN}
    assert TX.prometheus_text(summary, labels=labels) == JX.prometheus_text(summary, labels=labels)
    lists = tsrv.metrics.latency_lists()
    assert lists == jsrv.metrics.latency_lists() and lists["repair_latency_steps"]
    assert TX.histograms_text(lists, labels=labels) == JX.histograms_text(lists, labels=labels)
    # the artifacts: events JSONL, spans JSONL, the series .npz and the replay CLI
    from repro_torch.obs.schema import validate_jsonl
    from repro_torch.obs.series import save_series

    ev = tmp_path / "ev.jsonl"
    tsrv.log.to_jsonl(str(ev))
    assert validate_jsonl(str(ev)) == len(tsrv.log.events)
    sp = tmp_path / "spans.jsonl"
    assert TT.write_spans(str(sp), TT.build_traces(tsrv.log)) == TT.validate_spans_jsonl(str(sp)) == len(tspans)
    npz = save_series(str(tmp_path / "series"), tsrv.series_host(), meta={"start_step": tsrv.series_start_step()})
    out = tmp_path / "tl.json"
    assert TRP.main([str(ev), "--series", npz, "-o", str(out)]) == 0
