"""Lifecycle spans: per-entity traces over the repro_torch.obs event log.

The event log answers "what happened at step N"; this layer answers "what
happened to THIS request / THIS fault".  :func:`build_traces` correlates
events by entity id into :class:`Trace` objects, each a tree of
:class:`Span` records in the step domain:

  * **request traces** (entity ``request:<rid>``) — the ``request.*`` events
    the queue/scheduler/server emit: root span ``request`` with children
    ``queue`` (enqueue → admit, or → death in queue), ``prefill`` (admit →
    first token) and ``decode`` (first token → completion).  TTFT is the
    root start to the ``decode`` start; a request that expired, was dropped,
    or never completed carries ``status: "error"`` / ``"open"``.
  * **fault traces** (entity ``fault:<row>:<col>``) — the permanent-fault
    lifecycle: root span ``fault`` with children ``undetected`` (injection →
    first SUSPECT/CONFIRMED — the detection window), ``suspect`` (SUSPECT →
    CONFIRMED) and ``repair`` (REMAPPED → the first covering
    ``repair.plan``).  The latency attributes are computed by the SAME
    derivations ``ServingMetrics.summary()`` uses
    (:func:`~repro_torch.obs.events.detection_records` /
    :func:`~repro_torch.obs.events.repair_records`), so a span timeline and the
    summary's ``detect_latency_*`` / ``repair_latency_*`` agree exactly.

Ids are deterministic content hashes (sha1 of the entity key), OTLP-shaped:
128-bit ``trace_id``, 64-bit ``span_id``, ``parent_span_id`` linking the
tree.  Export is JSONL (one span object per line, :func:`write_spans`);
``python -m repro_torch.obs.trace events.jsonl -o spans.jsonl`` converts an
event JSONL, and ``--check`` validates a span file the way
``repro_torch.obs.schema`` validates events.

Spans are derived purely from the host-side event log; the decode step is
untouched: zero new host sync.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
from typing import Any, Iterable

from repro_torch.obs.events import Event, EventLog, detection_records, repair_records

SPAN_STATUSES = ("ok", "error", "open")


def _hex(key: str, n: int) -> str:
    return hashlib.sha1(key.encode()).hexdigest()[:n]


def trace_id(entity: str) -> str:
    """Deterministic 128-bit (32 hex) trace id for an entity key —
    ``"request:<rid>"`` or ``"fault:<row>:<col>"``.  Content-addressed, so
    re-deriving spans from the same log yields identical ids."""
    return _hex(entity, 32)


def span_id(tid: str, name: str) -> str:
    """Deterministic 64-bit (16 hex) span id within a trace."""
    return _hex(f"{tid}:{name}", 16)


@dataclasses.dataclass(frozen=True)
class Span:
    """One lifecycle phase of one entity, in the step domain (OTLP-style:
    steps stand in for wall-clock nanos — the simulation's time axis)."""

    trace_id: str
    span_id: str
    parent_span_id: str | None
    name: str
    start_step: int | None
    end_step: int | None
    attributes: dict[str, Any]
    status: str = "ok"

    def to_json(self) -> dict:
        return {
            "trace_id": self.trace_id, "span_id": self.span_id,
            "parent_span_id": self.parent_span_id, "name": self.name,
            "start_step": self.start_step, "end_step": self.end_step,
            "status": self.status, "attributes": self.attributes,
        }

    @property
    def duration_steps(self) -> int | None:
        if self.start_step is None or self.end_step is None:
            return None
        return self.end_step - self.start_step


@dataclasses.dataclass(frozen=True)
class Trace:
    """One entity's span tree: ``spans[0]`` is the root."""

    trace_id: str
    entity: str
    spans: tuple[Span, ...]

    @property
    def root(self) -> Span:
        return self.spans[0]


def _as_log(events) -> EventLog:
    if isinstance(events, EventLog):
        return events
    log = EventLog()
    log.events = [e if isinstance(e, Event) else Event.from_json(e)
                  for e in events]
    return log


def _child(tid: str, root_sid: str, name: str, start, end,
           attributes: dict, status: str = "ok") -> Span:
    return Span(trace_id=tid, span_id=span_id(tid, name),
                parent_span_id=root_sid, name=name, start_step=start,
                end_step=end, attributes=attributes, status=status)


# --------------------------------------------------------------------------- #
# request lifecycle
# --------------------------------------------------------------------------- #
def request_traces(events) -> list[Trace]:
    """One trace per rid seen in any ``request.*`` event, rid-ordered."""
    log = _as_log(events)
    first: dict[int, dict[str, Event]] = {}
    for e in log.events:
        if not e.kind.startswith("request."):
            continue
        per = first.setdefault(e.data["rid"], {})
        per.setdefault(e.kind, e)                 # first occurrence wins

    traces = []
    for rid in sorted(first):
        per = first[rid]
        enq = per.get("request.enqueue")
        adm = per.get("request.admit")
        ftok = per.get("request.first_token")
        comp = per.get("request.complete")
        entity = f"request:{rid}"
        tid = trace_id(entity)
        root_sid = span_id(tid, "request")

        reason = comp.data["reason"] if comp else None
        status = ("open" if comp is None
                  else "ok" if reason in ("done", "eos") else "error")
        start = enq.step if enq else min(
            (e.step for e in per.values() if e.step is not None), default=None)
        end = comp.step if comp else None
        attrs: dict[str, Any] = {"rid": rid}
        if enq:
            attrs["prompt_len"] = enq.data["prompt_len"]
        if comp:
            attrs["reason"] = reason
            attrs["tokens"] = comp.data["tokens"]
        if ftok is not None and start is not None and ftok.step is not None:
            attrs["ttft_steps"] = ftok.step - start
        spans = [Span(trace_id=tid, span_id=root_sid, parent_span_id=None,
                      name="request", start_step=start, end_step=end,
                      attributes=attrs, status=status)]

        # queue: enqueue -> admission, or -> death while still queued
        q_end = adm.step if adm else end
        spans.append(_child(
            tid, root_sid, "queue", start, q_end, {"rid": rid},
            status="ok" if adm else status))
        if adm:
            slot = adm.data["slot"]
            # prefill: admission -> first token (or death mid-prefill)
            p_end = ftok.step if ftok else end
            spans.append(_child(
                tid, root_sid, "prefill", adm.step, p_end,
                {"rid": rid, "slot": slot},
                status="ok" if ftok else status))
            if ftok:
                spans.append(_child(
                    tid, root_sid, "decode", ftok.step, end,
                    {"rid": rid, "slot": slot}, status=status))
        traces.append(Trace(trace_id=tid, entity=entity, spans=tuple(spans)))
    return traces


# --------------------------------------------------------------------------- #
# fault lifecycle
# --------------------------------------------------------------------------- #
def fault_traces(events) -> list[Trace]:
    """One trace per PE coordinate that was ever injected or confirmed.
    Latency attributes reuse ``detection_records`` / ``repair_records`` —
    span timelines and summary latencies agree by construction."""
    log = _as_log(events)
    det = {(d["row"], d["col"]): d for d in detection_records(log)}
    rep = {(r["row"], r["col"]): r for r in repair_records(log)}
    remapped = {}
    retired = {}
    for e in log.of_kind("fault.remapped"):
        remapped.setdefault((e.data["row"], e.data["col"]), e.step)
    for e in log.of_kind("fault.retired"):
        retired.setdefault((e.data["row"], e.data["col"]), e.step)

    traces = []
    for coord in sorted(det):
        d = det[coord]
        r = rep.get(coord)
        row, col = coord
        entity = f"fault:{row}:{col}"
        tid = trace_id(entity)
        root_sid = span_id(tid, "fault")
        inj, sus, conf = d["injected_step"], d["suspect_step"], d["confirmed_step"]

        ends = [s for s in (conf, remapped.get(coord), retired.get(coord),
                            r["plan_step"] if r else None) if s is not None]
        end = max(ends) if ends else None
        status = "ok" if conf is not None else "open"
        attrs: dict[str, Any] = {"row": row, "col": col,
                                 "detect_latency": d["latency"],
                                 "suspect_latency": d["suspect_latency"]}
        if r:
            attrs["repair_latency"] = r["latency"]
        if coord in retired:
            attrs["retired"] = True
        spans = [Span(trace_id=tid, span_id=root_sid, parent_span_id=None,
                      name="fault", start_step=inj, end_step=end,
                      attributes=attrs, status=status)]

        # undetected: injection -> first sighting (the detection window)
        sight = sus if sus is not None else conf
        if inj is not None:
            spans.append(_child(
                tid, root_sid, "undetected", inj, sight,
                {"row": row, "col": col},
                status="ok" if sight is not None else "open"))
        if sus is not None:
            spans.append(_child(
                tid, root_sid, "suspect", sus, conf, {"row": row, "col": col},
                status="ok" if conf is not None else "open"))
        if coord in remapped:
            spans.append(_child(
                tid, root_sid, "repair", remapped[coord],
                r["plan_step"] if r else None,
                {"row": row, "col": col},
                status="ok" if r else "open"))
        traces.append(Trace(trace_id=tid, entity=entity, spans=tuple(spans)))
    return traces


def build_traces(events) -> list[Trace]:
    """All lifecycle traces derivable from a log: requests, then faults."""
    return request_traces(events) + fault_traces(events)


# --------------------------------------------------------------------------- #
# export + validation (the span analogue of repro_torch.obs.schema)
# --------------------------------------------------------------------------- #
def write_spans(path: str, traces: Iterable[Trace]) -> int:
    """Write every span of every trace as JSONL; returns the span count."""
    n = 0
    with open(path, "w") as f:
        for tr in traces:
            for sp in tr.spans:
                f.write(json.dumps(sp.to_json()) + "\n")
                n += 1
    return n


def validate_span(obj: dict) -> None:
    """Validate one decoded span object; raises ``ValueError`` on the first
    violation (id shape, step ordering, status vocabulary, attribute type)."""
    if not isinstance(obj, dict):
        raise ValueError(f"span must be a JSON object, got {type(obj).__name__}")
    for field in ("trace_id", "span_id", "parent_span_id", "name",
                  "start_step", "end_step", "status", "attributes"):
        if field not in obj:
            raise ValueError(f"span missing field {field!r}")
    for field, width in (("trace_id", 32), ("span_id", 16)):
        v = obj[field]
        if not (isinstance(v, str) and len(v) == width
                and all(c in "0123456789abcdef" for c in v)):
            raise ValueError(f"{field} must be {width} lowercase hex chars, got {v!r}")
    p = obj["parent_span_id"]
    if p is not None and not (isinstance(p, str) and len(p) == 16):
        raise ValueError(f"parent_span_id must be 16 hex chars or null, got {p!r}")
    if not isinstance(obj["name"], str) or not obj["name"]:
        raise ValueError(f"name must be a non-empty string, got {obj['name']!r}")
    for field in ("start_step", "end_step"):
        v = obj[field]
        if v is not None and (not isinstance(v, int) or isinstance(v, bool)):
            raise ValueError(f"{field} must be an int or null, got {v!r}")
    s, e = obj["start_step"], obj["end_step"]
    if s is not None and e is not None and e < s:
        raise ValueError(f"span {obj['name']!r}: end_step {e} < start_step {s}")
    if obj["status"] not in SPAN_STATUSES:
        raise ValueError(f"status must be one of {SPAN_STATUSES}, got {obj['status']!r}")
    if not isinstance(obj["attributes"], dict):
        raise ValueError("attributes must be an object")


def validate_spans_jsonl(path: str) -> int:
    """Validate every line of a span JSONL file; returns the span count."""
    n = 0
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as exc:
                raise ValueError(f"{path}:{lineno}: not valid JSON: {exc}") from exc
            try:
                validate_span(obj)
            except ValueError as exc:
                raise ValueError(f"{path}:{lineno}: {exc}") from exc
            n += 1
    return n


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.trace",
        description="Derive lifecycle spans from a repro_torch.obs event JSONL, "
                    "or validate a span JSONL (--check).",
    )
    parser.add_argument("path", help="events.jsonl (or spans.jsonl with --check)")
    parser.add_argument("-o", "--out", default=None,
                        help="write spans JSONL here (default: <path>.spans.jsonl)")
    parser.add_argument("--check", action="store_true",
                        help="validate PATH as a span JSONL instead of deriving")
    args = parser.parse_args(argv)

    if args.check:
        try:
            n = validate_spans_jsonl(args.path)
        except (OSError, ValueError) as exc:
            print(f"[obs.trace] FAIL {exc}", file=sys.stderr)
            return 1
        print(f"[obs.trace] {args.path}: {n} spans OK")
        return 0

    try:
        log = EventLog.from_jsonl(args.path)
    except OSError as exc:
        print(f"[obs.trace] FAIL {exc}", file=sys.stderr)
        return 1
    traces = build_traces(log)
    out = args.out or args.path + ".spans.jsonl"
    n = write_spans(out, traces)
    n_req = sum(1 for t in traces if t.entity.startswith("request:"))
    print(f"[obs.trace] {out}: {n} spans "
          f"({n_req} request traces, {len(traces) - n_req} fault traces)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
