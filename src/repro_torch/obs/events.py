"""Structured fault-lifecycle tracing.

An :class:`EventLog` is an append-only list of :class:`Event` records, each a
(kind, wall-clock timestamp, server step, data) tuple.  The serving runtime
owns one log per server and stamps ``log.step`` at the top of every step, so
every emitter — the injector's ``inject_at``, the FaultManager's lifecycle
transitions, the repair hook — records *when in serving time* a thing
happened without threading step counters through every signature.

The log is the source of truth for the runtime's latency questions:

  * **detection latency** — per PE, the step delta from ``fault.injected``
    to ``fault.suspect`` / ``fault.confirmed`` (:func:`detection_records`).
    Exact under scheduled injection: the injection step is
    known, so the percentiles in ``ServingMetrics.summary()`` are measured,
    not modelled.
  * **repair latency** — per remapped PE, confirmation to the first
    ``repair.plan`` swap that covers it (:func:`repair_records`).
  * **scan coverage** — ``scan.sweep`` events mark each completed
    whole-array sweep.
  * **transient detection** — per SEU flip, injection to the first
    ``abft.alarm`` (:func:`transient_records`).
  * **checkpoint memory faults** — per leaf, the ``memory.fault`` actions
    of a guarded restore (:func:`memory_fault_records`).

Serialization is JSONL (one event per line); ``python -m
repro_torch.obs.schema`` validates emitted files against the event schema.

Events recorded before the first server step (BIST confirmation of factory
faults, power-on injections) carry ``step=None``; latency derivations skip
them — a fault whose injection step is unknown has no measurable latency.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Iterable

import numpy as np

_UNSET = object()


@dataclasses.dataclass(frozen=True)
class Event:
    ts: float              # wall-clock (time.time) at emit
    step: int | None       # server step, None before the loop starts
    kind: str              # dotted event kind, see repro_torch.obs.schema
    data: dict[str, Any]

    def to_json(self) -> dict:
        return {"ts": self.ts, "step": self.step, "kind": self.kind, "data": self.data}

    @classmethod
    def from_json(cls, obj: dict) -> "Event":
        return cls(ts=obj["ts"], step=obj["step"], kind=obj["kind"], data=obj.get("data", {}))


class EventLog:
    """Append-only structured event log with a mutable step cursor."""

    def __init__(self, *, clock: Callable[[], float] = time.time):
        self.events: list[Event] = []
        self.step: int | None = None
        self._clock = clock

    def __len__(self) -> int:
        return len(self.events)

    def emit(self, kind: str, *, step=_UNSET, **data) -> Event:
        """Record one event.  ``step`` defaults to the log's current cursor
        (set by the owning loop); pass it explicitly to backdate/override."""
        ev = Event(
            ts=self._clock(),
            step=self.step if step is _UNSET else step,
            kind=kind,
            data=data,
        )
        self.events.append(ev)
        return ev

    def of_kind(self, *kinds: str) -> list[Event]:
        want = set(kinds)
        return [e for e in self.events if e.kind in want]

    # ------------------------------------------------------------------ #
    # serialization
    # ------------------------------------------------------------------ #
    def dumps(self) -> str:
        return "".join(json.dumps(e.to_json()) + "\n" for e in self.events)

    def to_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.dumps())

    @classmethod
    def from_jsonl(cls, path: str) -> "EventLog":
        log = cls()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    log.events.append(Event.from_json(json.loads(line)))
        return log


# --------------------------------------------------------------------------- #
# derived metrics
# --------------------------------------------------------------------------- #
def _first_step_by_coord(events: Iterable[Event]) -> dict[tuple[int, int], int | None]:
    out: dict[tuple[int, int], int | None] = {}
    for e in events:
        coord = (e.data["row"], e.data["col"])
        if coord not in out:
            out[coord] = e.step
    return out


def detection_records(log: EventLog) -> list[dict]:
    """Per-PE detection timeline: injection → SUSPECT → CONFIRMED steps and
    the step deltas between them.  One record per PE that was ever injected
    or confirmed; ``latency`` is None when the injection step is unknown
    (factory faults confirmed by BIST) or the fault is still undetected."""
    injected = _first_step_by_coord(log.of_kind("fault.injected"))
    suspect = _first_step_by_coord(log.of_kind("fault.suspect"))
    confirmed = _first_step_by_coord(log.of_kind("fault.confirmed"))
    records = []
    for coord in sorted(set(injected) | set(confirmed)):
        inj = injected.get(coord)
        sus = suspect.get(coord)
        conf = confirmed.get(coord)
        records.append({
            "row": coord[0],
            "col": coord[1],
            "injected_step": inj,
            "suspect_step": sus,
            "confirmed_step": conf,
            "suspect_latency": (sus - inj) if (inj is not None and sus is not None) else None,
            "latency": (conf - inj) if (inj is not None and conf is not None) else None,
        })
    return records


def repair_records(log: EventLog) -> list[dict]:
    """Per-remapped-PE repair latency: the step delta from the PE's
    ``fault.remapped`` transition to the first ``repair.plan`` swap at or
    after it (the plan is what actually routes a pruned channel onto the
    column — until it lands, the remapped PE still corrupts)."""
    plan_steps = sorted(
        e.step for e in log.of_kind("repair.plan") if e.step is not None
    )
    records = []
    for e in log.of_kind("fault.remapped"):
        if e.step is None:
            continue
        later = [s for s in plan_steps if s >= e.step]
        if later:
            records.append({
                "row": e.data["row"],
                "col": e.data["col"],
                "remapped_step": e.step,
                "plan_step": later[0],
                "latency": later[0] - e.step,
            })
    return records


def transient_records(log: EventLog) -> list[dict]:
    """Per-flip detection timeline for SEU injections: each
    ``transient.flip`` paired with the first ``abft.alarm`` at or after its
    injection step (the injector keys every flip by (step, site, index, bit)
    at emit time, :func:`repro_torch.transient.seu.emit_flip_events`).
    ``latency`` is None for flips never alarmed or injected at an unknown
    step."""
    alarm_steps = sorted(
        e.step for e in log.of_kind("abft.alarm") if e.step is not None
    )
    records = []
    for e in log.of_kind("transient.flip"):
        later = [s for s in alarm_steps if e.step is not None and s >= e.step]
        records.append({
            "site": e.data["site"],
            "index": e.data["index"],
            "bit": e.data["bit"],
            "injected_step": e.step,
            "detected_step": later[0] if later else None,
            "latency": (later[0] - e.step) if later else None,
        })
    return records


def memory_fault_records(log: EventLog) -> list[dict]:
    """Per-leaf outcome of the checkpoint memory-fault path: for each leaf
    that ever raised ``memory.fault``, the actions it went through
    (detected / refetched / refused, in order) and the final disposition —
    ``"refetched"`` means the guarded restore recovered it from a pristine
    source, ``"refused"`` means the restore was (correctly) rejected."""
    by_leaf: dict[str, list[Event]] = {}
    for e in log.of_kind("memory.fault"):
        by_leaf.setdefault(e.data["leaf"], []).append(e)
    return [
        {
            "leaf": leaf,
            "actions": [e.data["action"] for e in evs],
            "outcome": evs[-1].data["action"],
            "steps": [e.step for e in evs],
        }
        for leaf, evs in sorted(by_leaf.items())
    ]


def latency_summary(latencies: list[int], prefix: str) -> dict:
    """mean/p50/p95 of a step-latency list, keyed ``{prefix}_{stat}_steps``;
    all None when empty (no measurable latencies is not zero latency)."""
    if not latencies:
        return {f"{prefix}_mean_steps": None, f"{prefix}_p50_steps": None,
                f"{prefix}_p95_steps": None}
    arr = np.asarray(latencies, np.float64)
    return {
        f"{prefix}_mean_steps": float(arr.mean()),
        f"{prefix}_p50_steps": float(np.percentile(arr, 50)),
        f"{prefix}_p95_steps": float(np.percentile(arr, 95)),
    }
