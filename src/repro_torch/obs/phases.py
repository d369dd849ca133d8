"""Host phase spans of the serving step: what the server's host was doing.

:class:`PhaseClock` times named phases of :class:`FaultTolerantServer`'s
step on the host.  ``with clock.span("scan"):`` has two sinks:

  * always, it adds the block's host nanoseconds (``time.perf_counter_ns``)
    and one count to the phase's totals, which
    ``ServingMetrics.summary()["host_phase_ms"]`` reports as mean host ms a
    step;
  * only while a profiler is recording (``torch.autograd._profiler_enabled``),
    it also opens ``torch.profiler.record_function("serve.<phase>")``, so the
    span lies in the trace on the profiler's own clock, the clock of the
    device records: a gap on the card is named by the phase the host was in.

With no profiler recording a span costs one flag check, two clock reads and
two integer adds: each phase's context manager is made once, with the
clock, and allocates nothing when it is entered.

The serving step's phases (:data:`SERVE_PHASES`); the leaves run one after
another inside ``serve.step``, never overlapping:

  ============  ==============================================================
  ``step``      the whole ``FaultTolerantServer.step``
  ``submit``    ``FaultTolerantServer.submit`` (the caller's, between steps)
  ``scan``      wearout injection and ``FaultManager.scan_step`` (the probe's
                host operands, their copy, the probe kernel, the flags' sync)
  ``repair``    the repair hook and the admission limit
  ``admit``     ``scheduler.admit``, the expired drain, each admitted slot's
                cache reset
  ``feed``      the token feed and fault view; in ``ModelBundle.step_fn`` the
                fault-state / plan swap and the copy into the step's tokens
  ``capture``   ``CapturedStep``'s first call: the eager warm-up and capture
  ``replay``    ``CapturedStep``'s later calls: the graph's replay (the eager
                body where the step is not captured)
  ``sync``      the sampled tokens' copy to the host
  ``commit``    ``scheduler.commit``
  ``record``    the ``StepRecord`` and the series row
  ============  ==============================================================

No span lies inside the captured body, so the graph is the same with or
without them.
"""
from __future__ import annotations

from time import perf_counter_ns

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

SERVE_PHASES = ("step", "submit", "scan", "repair", "admit", "feed", "capture", "replay", "sync",
                "commit", "record")


class _Phase:
    """One phase's reusable context manager and its totals.  A phase does
    not nest in itself."""

    __slots__ = ("name", "ns", "count", "_t0", "_range")

    def __init__(self, name: str):
        self.name = name
        self.ns = self.count = self._t0 = 0
        self._range = None

    def __enter__(self) -> None:
        if _profiler_enabled():
            self._range = record_function(self.name)
            self._range.__enter__()
        self._t0 = perf_counter_ns()

    def __exit__(self, *exc) -> None:
        self.ns += perf_counter_ns() - self._t0
        self.count += 1
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None


class PhaseClock:
    """Host time by phase of one server's step (module docstring)."""

    def __init__(self):
        self._phases = {n: _Phase(f"serve.{n}") for n in SERVE_PHASES}

    def span(self, name: str) -> _Phase:
        """The context manager of phase ``name``."""
        return self._phases[name]

    def totals(self) -> dict[str, tuple[int, int]]:
        """{phase: (host ns, spans)} so far."""
        return {n: (p.ns, p.count) for n, p in self._phases.items()}

    def ms_per_step(self, steps: int) -> dict[str, float]:
        """{phase: host ms over ``steps`` steps, a step}."""
        return {n: p.ns / 1e6 / max(steps, 1) for n, p in self._phases.items()}
