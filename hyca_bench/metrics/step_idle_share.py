"""Server loop: the share (%) of the traced window in which the card was
idle while the host was inside the server's step or a submit (the program's
``serve.step`` and ``serve.submit`` spans, ``obs/phases.py``).

The idle intervals are the complement of the union of the device records,
between the first record and the last; each is intersected exactly with the
union of the named spans, and the overlap is summed over the window's
length.  None where the traced block holds no ``serve.step`` span (a program
without phase spans, a prefill cell, a run with ``--trace 0``).  What
``device_idle_share.serve`` holds beyond it is the caller's time between
steps and the window's edges.  It holds the profiler's own cost too: under
the profiler a CUDA graph's launch keeps the host far longer than without
one, and the card idles meanwhile."""

from hyca_bench.harness.trace import _union

SPANS = ("serve.step", "serve.submit")


def idle_share(rec, names) -> float | None:
    """The share (%) of the traced window in which the card was idle while
    the host was inside a span named in ``names``."""
    prof = rec.get("profile")
    if not prof or not prof.get("device") or not any(n == "serve.step" for n, _, _ in prof.get("spans", ())):
        return None
    busy = _union([(a, a + d) for _, a, d, _ in prof["device"]])
    idle = [(b0[1], b1[0]) for b0, b1 in zip(busy, busy[1:])]
    spans = _union([(s, s + d) for n, s, d in prof["spans"] if n in names])
    overlap, j = 0.0, 0
    for a, b in idle:
        while j < len(spans) and spans[j][1] <= a:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < b:
            overlap += min(b, spans[k][1]) - max(a, spans[k][0])
            k += 1
    return 100.0 * overlap / 1e6 / prof["window_s"]


def read(rec, metric):
    return idle_share(rec, SPANS)
