"""The program's device marks in a traced window: the port brackets a model
span's work on the card with two no-op one-thread kernels
(``span_begin_<span>``, ``span_end_<span>``; the port's
``obs/spans.py``), launched only while a profiler records.  The stream
runs in order, so the device work between a begin mark's end and its end
mark's start is the span's."""
from __future__ import annotations

import re

from hyca_bench.harness.trace import _union


def span_device_s(rec: dict, span: str) -> float | None:
    """Device busy seconds inside the marked span ``span`` (``attn_mla``)
    over the traced window: the union of the other device records,
    intersected with each [begin mark's end, end mark's start].  None where
    the trace holds no marks, or marks that do not pair (begin, end, begin,
    end, ...), or pairs that are not a whole number a layer of the model (a
    lost record)."""
    prof = rec.get("profile")
    if not prof or not prof.get("device"):
        return None
    kinds = {m: re.compile(rf"\bspan_{m}_{span}\b") for m in ("begin", "end")}
    marks, work = [], []
    for name, a, d, _ in prof["device"]:
        kind = next((k for k, pat in kinds.items() if pat.search(name)), None)
        if kind is None:
            work.append((a, a + d))
        else:
            marks.append((a, d, kind))
    marks.sort()
    if not marks or len(marks) % 2 or len(marks) // 2 % rec["model"]["num_hidden_layers"]:
        return None
    spans = []
    for (a0, d0, k0), (a1, _, k1) in zip(marks[::2], marks[1::2]):
        if (k0, k1) != ("begin", "end"):
            return None
        spans.append((a0 + d0, a1))
    busy, overlap, j = _union(work), 0.0, 0
    for a, b in spans:
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < b:
            overlap += min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
    return overlap / 1e6
