"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a block
of steps, reduced to device activity, idle gaps and the harness's host
spans.

The block is wrapped in one host annotation (:data:`WINDOW`), whose span in
the trace's clock is the traced window; every device record (kernels,
copies, fills) is clipped to it.  ``busy_s`` is the length of the union of
the device records, ``window_s`` the window's length.  Each idle gap is
named by the innermost harness span (``span``) that covers its middle on
the host, else ``host``.  The trace is read from its Chrome export, which
carries each kernel's launch grid."""
from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
import time

import torch

WINDOW = "hyca_bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the kernels both wrappers of kernels/ft_matmul.py launch (csrc/ft_matmul.cu);
# the expert is the grid's z axis, so an ft_matmul call is one z block
FT_KERNELS = re.compile(r"\b(ft_strip_kernel|ft_strip_mma_kernel|ft_kfast_kernel)[<(]")
MAX_SHORTFALL = 0.01    # the share of a block's calls whose launch record may be missing


def span(name: str):
    """A host span the trace names idle gaps by (a ``record_function``)."""
    return torch.profiler.record_function(name)


def wrap(obj, attr: str, name: str, timer: list | None = None) -> None:
    """Replace the bound method ``obj.attr`` on this instance by one that
    runs inside span ``name`` and, given ``timer``, appends its host
    seconds to it."""
    fn = getattr(obj, attr)

    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        with span(name):
            out = fn(*args, **kwargs)
        if timer is not None:
            timer.append(time.perf_counter() - t0)
        return out

    setattr(obj, attr, wrapped)


def warm_up_profiler(device: torch.device) -> None:
    """Start and stop the profiler once, so that its own set-up (CUPTI's)
    falls in the run's set-up and not in the traced window."""
    with _profile(device):
        torch.zeros(1, device=device).add_(1)
        _sync(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profile(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    return profile(activities=acts)


@contextlib.contextmanager
def traced(device: torch.device, out: dict):
    """Profile the block; on exit fill ``out`` with :func:`reduce`'s
    record of it."""
    _sync(device)
    with _profile(device) as prof:
        with span(WINDOW):
            yield
            _sync(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out.update(reduce(events))


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def reduce(events: list[dict]) -> dict:
    """The traced window's record from Chrome-trace events: ``window_s``,
    ``busy_s``, ``device`` [(name, start_us, dur_us, grid)], ``idle``
    [(host span, seconds)] per gap, ``spans`` [(name, start_us, dur_us)]."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        return {}
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    device = []
    for e in xs:
        if e.get("cat") in DEVICE_CATS:
            a, b = max(w0, float(e["ts"])), min(w1, float(e["ts"]) + float(e.get("dur", 0.0)))
            if b > a:
                device.append((e["name"], a, b - a, tuple((e.get("args") or {}).get("grid") or ())))
    spans = [(e["name"], float(e["ts"]), float(e["dur"])) for e in xs
             if e.get("cat") == "user_annotation" and e["name"] != WINDOW]
    busy = _union([(a, a + d) for _, a, d, _ in device])
    gaps, t = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    idle = []
    for a, b in gaps:
        mid = (a + b) / 2
        covering = [(d, n) for n, s, d in spans if s <= mid <= s + d]
        idle.append((min(covering)[1] if covering else "host", (b - a) / 1e6))
    return {"window_s": (w1 - w0) / 1e6, "busy_s": sum(b - a for a, b in busy) / 1e6,
            "device": device, "idle": idle, "spans": spans}


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by what
    the host was doing, each in seconds over the traced window."""
    ops: dict[str, float] = {}
    for name, _, dur, _ in trace.get("device", []):
        ops[name] = ops.get(name, 0.0) + dur / 1e6
    idle: dict[str, float] = {}
    for name, sec in trace.get("idle", []):
        idle[name] = idle.get(name, 0.0) + sec
    def top_of(d):
        return [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": top_of(ops), "idle_gaps": top_of(idle)}


def _launch_times(rec: dict, kernel: str) -> list[float]:
    """Device seconds of each launch of ``kernel`` (``ft_matmul``: grid
    z = 1, ``ft_matmul_batched``: z = E) in the traced block."""
    batched = kernel == "ft_matmul_batched"
    return [dur / 1e6 for name, _, dur, grid in (rec.get("profile") or {}).get("device", ())
            if FT_KERNELS.search(name) and len(grid) == 3 and (grid[2] > 1) == batched]


def launches(rec: dict) -> dict[str, list[int]]:
    """{kernel: [launches found in the trace, calls the block ran]}."""
    return {k: [len(_launch_times(rec, k)), sum(c["kernel"] == k for c in rec.get("profiled_calls", ()))]
            for k in ("ft_matmul", "ft_matmul_batched")}


def roofline_share(rec: dict, kernel: str) -> float | None:
    """The ``counts`` bound time of the traced block's ``kernel`` calls
    (``ft_matmul`` or ``ft_matmul_batched``) over their device time, as a
    share (%).  Each call is one launch: where the trace holds one launch a
    call, the device time is their sum.  The profiler can lose a few
    records: where at most :data:`MAX_SHORTFALL` of the calls have no
    launch, the time is the found launches' mean times the calls.  None
    where more are missing, or where the trace holds more launches than
    calls (a call split, or a launch the counts do not know)."""
    calls = [c for c in rec.get("profiled_calls", ()) if c["kernel"] == kernel]
    found = _launch_times(rec, kernel)
    if not calls or not found or len(found) > len(calls):
        return None
    if len(found) == len(calls):
        device_s = sum(found)
    elif len(calls) - len(found) <= MAX_SHORTFALL * len(calls):
        device_s = sum(found) / len(found) * len(calls)
    else:
        return None
    return 100.0 * sum(rec["counts"].bound_s(c) for c in calls) / device_s
