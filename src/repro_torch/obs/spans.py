"""Spans inside the model's step: where a part of the model runs.

A :class:`ModelSpan` marks one part of a layer (:data:`ATTN_MLA`: the
attention core of :func:`~repro_torch.models.attention.mla_forward` and
:func:`~repro_torch.models.attention.mla_decode`).  ``with
span.on(device):`` has three sinks:

  * always, the block's host nanoseconds and one count are added to the
    span's totals (:func:`totals`), as a serving phase's are
    (:mod:`repro_torch.obs.phases`);
  * only while a profiler is recording, a
    ``torch.profiler.record_function`` range of the span's name;
  * only while a profiler is recording, on a CUDA device, and not while a
    CUDA graph is captured: a device mark at entry and at exit, two no-op
    one-thread kernels on the current stream (``csrc/obs/span_mark.cu``:
    ``span_begin_<span>`` and ``span_end_<span>``).  The stream runs in
    order, so the device time between the begin mark's end and the end
    mark's start is the span's work, whatever launched it.

So a run with no profiler launches exactly the kernels it launches without
the span.  The marks' library is loaded (built with ``nvcc`` on a
checkout's first use) on a span's first entry on a CUDA device, before any
profiler needs a mark: loading launches nothing.
"""
from __future__ import annotations

import ctypes
from time import perf_counter_ns

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import record_function

def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build  # deferred: nothing is built at import

    return _build.load("obs/span_mark")


class ModelSpan:
    """One part of the model's step (module docstring).  It does not nest
    in itself."""

    __slots__ = ("name", "ns", "count", "_t0", "_range", "_marked", "_device", "_launcher")

    def __init__(self, name: str):
        self.name = name
        self._launcher = name.replace(".", "_") + "_mark_launch"  # csrc/obs/span_mark.cu's
        self.ns = self.count = self._t0 = 0
        self._range = self._marked = self._device = None

    def on(self, device: torch.device) -> "ModelSpan":
        """The span for a block whose work runs on ``device``."""
        self._device = device
        return self

    def _mark(self, end: int) -> None:
        fn = getattr(_lib(), self._launcher)
        if fn.argtypes is None:
            fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_void_p], ctypes.c_int
        rc = fn(end, torch.cuda.current_stream(self._marked).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"span mark launch failed: CUDA error {rc}")

    def __enter__(self) -> None:
        dev, self._device = self._device, None
        cuda = dev is not None and dev.type == "cuda"
        if cuda:
            _lib()
        if _profiler_enabled():
            self._range = record_function(self.name)
            self._range.__enter__()
            if cuda and not torch.cuda.is_current_stream_capturing():
                self._marked = dev
                self._mark(0)
        self._t0 = perf_counter_ns()

    def __exit__(self, *exc) -> None:
        self.ns += perf_counter_ns() - self._t0
        self.count += 1
        if self._marked is not None:
            self._mark(1)
            self._marked = None
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None


ATTN_MLA = ModelSpan("attn.mla")
SPANS = {s.name: s for s in (ATTN_MLA,)}


def totals() -> dict[str, tuple[int, int]]:
    """{span: (host ns, entries)} in this process so far."""
    return {n: (s.ns, s.count) for n, s in SPANS.items()}
