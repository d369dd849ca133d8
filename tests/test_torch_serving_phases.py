"""The server's host phase spans (``obs/phases.py``) on the CPU: a smoke
server, eager, protected over a BIST-confirmed fault map.

Under ``torch.profiler`` every step is one ``serve.step`` range holding its
leaf phases in the step's order, none overlapping the next; with no
profiler recording no ``record_function`` is entered, yet the summary's
``host_phase_ms`` still times every phase; the spans move no served token."""
import types

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from repro_torch.obs import phases as phases_mod
from repro_torch.obs.export import prometheus_text
from repro_torch.obs.phases import SERVE_PHASES
from repro_torch.serving import FaultTolerantServer, ModelBundle, ServerConfig
from repro_torch.serving.fault_manager import FaultInjector

CFG = ServerConfig(arch="qwen1.5-0.5b", n_slots=4, smax=32, rows=4, cols=4, dppu_size=4, dispatch="fused",
                   mode="protected", seed=0, device="cpu")
BIST = [(0, 1, 30, 1), (1, 2, 31, 0)]
# the leaves of a step, in its order (``feed`` runs twice: the server's, then step_fn's)
LEAVES = ("scan", "repair", "admit", "feed", "capture", "replay", "sync", "commit", "record")


@pytest.fixture(scope="module")
def bundle():
    return ModelBundle(CFG)


def _server(bundle) -> FaultTolerantServer:
    inj = FaultInjector(CFG.rows, CFG.cols, seed=1)
    for r, c, b, v in BIST:
        inj.inject_at(r, c, bit=b, val=v)
    return FaultTolerantServer(CFG, bundle=bundle, injector=inj)


def _trace():
    rng = np.random.default_rng(7)
    return [{"step": i, "prompt": rng.integers(0, 256, size=3), "max_new_tokens": 4} for i in range(6)]


def _submit(srv, n=4):
    for i in range(n):
        srv.submit(np.full(3, i + 1, np.int32), 3)


def _spans(prof) -> list[tuple[str, float, float]]:
    """(phase, start us, end us) of every ``serve.*`` range, by start."""
    return sorted(((e.name[len("serve."):], e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith("serve.")), key=lambda s: (s[1], -s[2]))


def _profiled_steps(srv, n: int):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _submit(srv)
        for _ in range(n):
            srv.step()
    return _spans(prof)


def _leaves_of(spans, step):
    _, a, b = step
    return [s for s in spans if s[0] in LEAVES and a <= s[1] and s[2] <= b]


def test_profiled_step_holds_its_phases_in_order(bundle):
    srv = _server(bundle)
    spans = _profiled_steps(srv, 3)
    steps = [s for s in spans if s[0] == "step"]
    assert len(steps) == 3 and [s[0] for s in spans].count("submit") == 4
    for a, b in zip(steps, steps[1:]):
        assert a[2] <= b[1]
    for step in steps:
        leaves = _leaves_of(spans, step)
        assert [n for n, _, _ in leaves] == ["scan", "repair", "admit", "feed", "feed", "replay", "sync",
                                             "commit", "record"]
        for x, y in zip(leaves, leaves[1:]):
            assert x[2] <= y[1], (x, y)
    # every leaf lies in a step; submits lie outside every step
    leaves = [s for s in spans if s[0] in LEAVES]
    assert sum(len(_leaves_of(spans, st)) for st in steps) == len(leaves)
    for _, a, b in (s for s in spans if s[0] == "submit"):
        assert all(b <= st[1] or a >= st[2] for st in steps)


def test_capture_span_only_on_a_captured_steps_first_call(bundle):
    """A stand-in graph on the CPU: the step's first call (and the first
    after ``swap_params`` drops the graph) is ``serve.capture``, the rest
    ``serve.replay``."""
    srv = _server(bundle)
    step = srv.decode

    def capture():
        step._body()
        step.graph = types.SimpleNamespace(replay=step._body)

    step.capture = True
    step._warm_up_and_capture = capture
    spans = _profiled_steps(srv, 3)
    calls = [s[0] for s in spans if s[0] in ("capture", "replay")]
    assert calls == ["capture", "replay", "replay"]
    step.swap_params(step.params)
    spans = _profiled_steps(srv, 2)
    assert [s[0] for s in spans if s[0] in ("capture", "replay")] == ["capture", "replay"]


def test_no_profiler_enters_no_record_function(bundle, monkeypatch):
    entered = []
    real = phases_mod.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(phases_mod, "record_function", counting)
    srv = _server(bundle)
    summary = srv.run(_trace(), max_steps=32)
    assert entered == []
    ms = summary["host_phase_ms"]
    assert set(ms) == set(SERVE_PHASES)
    ran = set(SERVE_PHASES) - {"capture"}       # eager on the CPU: no capture
    assert all(ms[p] > 0 for p in ran) and ms["capture"] == 0
    totals = srv.metrics.phases.totals()
    assert totals["step"][1] == summary["steps"] and totals["feed"][1] == 2 * summary["steps"]
    assert totals["submit"][1] == len(_trace())
    assert sum(ms[p] for p in LEAVES) <= ms["step"]
    # the same spans, profiled, do enter it: one range a span
    _profiled_steps(srv, 1)
    assert entered.count("serve.step") == 1 and entered.count("serve.submit") == 4


def test_served_tokens_equal_with_profiler_on_and_off(bundle):
    off = _server(bundle)
    off.run(_trace(), max_steps=32)
    on = _server(bundle)
    with profile(activities=[ProfilerActivity.CPU]):
        on.run(_trace(), max_steps=32)
    got, want = on.completions_by_rid(), off.completions_by_rid()
    assert got.keys() == want.keys() and len(got) == len(_trace())
    assert all(np.array_equal(got[r], want[r]) for r in want)


def test_prometheus_text_carries_host_phase_gauges(bundle):
    srv = _server(bundle)
    summary = srv.run(_trace(), max_steps=32)
    text = prometheus_text(summary, labels={"arch": CFG.arch})
    for p in SERVE_PHASES:
        line = next(ln for ln in text.splitlines() if ln.startswith(f"hyca_host_phase_ms_{p}{{"))
        assert float(line.split()[-1]) == pytest.approx(summary["host_phase_ms"][p], rel=1e-5)
