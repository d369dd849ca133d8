"""The readers of the program's phase spans (``step_idle_share``,
``scan_idle_share``) on hand-built Chrome events passed through
``trace.reduce``."""
import pytest

from hyca_bench.harness import spec, trace
from hyca_bench.metrics.step_idle_share import idle_share

METRICS = ("step_idle_share.serve", "scan_idle_share.serve")


def x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def span(name, a, b):
    return x("user_annotation", name, float(a), float(b - a))


def dev(a, b, cat="kernel"):
    return x(cat, "void ft_strip_mma_kernel(int)", float(a), float(b - a))


# one step of the server inside a 2000 us window, a submit on each side; the
# harness's own step_fn wrapper holds the step_fn half of the feed and the replay
EVENTS = [
    span(trace.WINDOW, 1000, 3000),
    span("serve.submit", 1000, 1050),
    span("serve.step", 1100, 2500),
    span("scan_step", 1120, 1290),
    span("serve.scan", 1100, 1300),
    span("serve.repair", 1300, 1320),
    span("serve.admit", 1320, 1400),
    span("serve.feed", 1400, 1450),
    span("step_fn", 1450, 1900),
    span("serve.feed", 1450, 1500),
    span("serve.replay", 1500, 1600),
    span("serve.sync", 1900, 2300),
    span("serve.commit", 2300, 2400),
    span("serve.record", 2400, 2500),
    span("serve.submit", 2700, 2750),
    dev(1050, 1150),
    dev(1250, 1350),
    dev(1550, 2200),
    dev(2250, 2350, "gpu_memcpy"),
    dev(2800, 2900),
]
# idle between the first record and the last: [1150, 1250], [1350, 1550],
# [2200, 2250], [2350, 2800]
WANT = {
    "scan_idle_share.serve": 100 / 2000 * 100,              # [1150, 1250] inside the scan
    "step_idle_share.serve": (100 + 200 + 50 + 150 + 50) / 2000 * 100,   # + [2350, 2500] and a submit's 50
}


def _rec(events):
    return {"profile": trace.reduce(events)}


@pytest.mark.parametrize("metric", METRICS)
def test_reader_sums_the_exact_overlap(metric):
    assert spec.reader(metric)(_rec(EVENTS), metric) == pytest.approx(WANT[metric])


def test_overlap_is_split_across_phases_not_by_the_gaps_middle():
    """The 200 us gap [1350, 1550] has its middle in the feed: the harness's
    breakdown names all of it by one span, the overlap counts only its 150 us
    under the feed and the replay (50 us lie in the admission)."""
    prof = trace.reduce(EVENTS)
    assert ("serve.feed", pytest.approx(200e-6)) in prof["idle"]
    launch = idle_share({"profile": prof}, ("serve.feed", "serve.replay"))
    assert launch * prof["window_s"] / 100 == pytest.approx(150e-6)
    admit = idle_share({"profile": prof}, ("serve.admit",))
    assert admit * prof["window_s"] / 100 == pytest.approx(50e-6)


@pytest.mark.parametrize("metric", METRICS)
def test_reader_is_none_without_a_step_span(metric):
    read = spec.reader(metric)
    no_step = [e for e in EVENTS if e["name"] != "serve.step"]
    assert read(_rec(no_step), metric) is None
    # a program without phase spans (the harness's wrappers alone), a prefill block, no trace
    harness_only = [e for e in EVENTS if not e["name"].startswith("serve.")]
    assert read(_rec(harness_only), metric) is None
    prefill = [span(trace.WINDOW, 0, 100), span("prefill", 0, 100), dev(10, 20), dev(50, 60)]
    assert read(_rec(prefill), metric) is None
    assert read({"profile": None}, metric) is None and read({}, metric) is None


def test_scan_within_step_within_device_idle():
    rec = _rec(EVENTS)
    got = {m: spec.reader(m)(rec, m) for m in METRICS + ("device_idle_share.serve",)}
    assert got["scan_idle_share.serve"] <= got["step_idle_share.serve"]
    assert got["step_idle_share.serve"] <= got["device_idle_share.serve"]
    assert got["device_idle_share.serve"] == pytest.approx(950 / 2000 * 100)
