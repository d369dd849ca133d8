"""Event-schema validation for repro_torch.obs JSONL logs.

One place declares the event vocabulary: every kind the runtime emits, with
the data fields each kind must carry.  ``validate_jsonl`` checks an emitted
event log, e.g. one written by ``EventLog.to_jsonl``::

    PYTHONPATH=src python -m repro_torch.obs.schema serve_events.jsonl

Extra data fields are allowed (emitters may enrich events); missing required
fields, wrong types, unknown kinds, or malformed envelope fields fail.
"""
from __future__ import annotations

import json
import sys

# required data fields per kind: name -> allowed types.  bool is checked
# before int (Python bools ARE ints; a schema that says int must not silently
# accept True, and one that says bool must not accept 1).
KIND_SCHEMAS: dict[str, dict[str, tuple[type, ...]]] = {
    "server.start": {"mode": (str,), "rows": (int,), "cols": (int,),
                     "dppu": (int,), "dispatch": (str,), "arch": (str,)},
    "fault.injected": {"row": (int,), "col": (int,), "bit": (int,), "val": (int,)},
    "fault.suspect": {"row": (int,), "col": (int,)},
    "fault.confirmed": {"row": (int,), "col": (int,)},
    "fault.repaired": {"row": (int,), "col": (int,)},
    "fault.remapped": {"row": (int,), "col": (int,)},
    "fault.retired": {"row": (int,), "col": (int,)},
    "scan.sweep": {"sweep": (int,), "steps": (int,)},
    "scan.boot": {"sweeps": (int,), "confirmed": (int,)},
    "scan.bist": {"confirmed": (int,)},
    "chaos.injected": {"n": (int,)},
    "fleet.autoscale": {"action": (str,), "n": (int,),
                        "queue_depth_mean": (float, int),
                        "capacity_mean": (float, int), "live": (int,)},
    "repair.plan": {"mode": (str,), "n_remapped": (int,), "remapped_cols": (list,),
                    "quality_fraction": (float, int), "retrained": (bool,)},
    "train.step": {"loss": (float, int), "lr": (float, int),
                   "gnorm": (float, int), "ms": (float, int)},
    # request lifecycle (repro_torch.obs.trace correlates these by rid into
    # spans: enqueue -> admit -> first_token -> complete)
    "request.enqueue": {"rid": (int,), "prompt_len": (int,)},
    "request.admit": {"rid": (int,), "slot": (int,)},
    "request.first_token": {"rid": (int,)},
    "request.complete": {"rid": (int,), "reason": (str,), "tokens": (int,)},
    # transient-fault stack (the same vocabulary as the reference package)
    "transient.flip": {"site": (str,), "index": (int,), "bit": (int,)},
    "memory.fault": {"leaf": (str,), "action": (str,)},
    "abft.alarm": {"site": (str,), "n_flagged": (int,),
                   "syndrome_max": (float, int)},
}


def _check_type(value, types: tuple[type, ...]) -> bool:
    if bool in types:
        return isinstance(value, bool)
    if isinstance(value, bool):  # bool passes isinstance(int) — reject explicitly
        return False
    return isinstance(value, types)


def validate_event(obj: dict) -> None:
    """Validate one decoded event envelope + data payload.  Raises
    ``ValueError`` with a field-level message on the first violation."""
    if not isinstance(obj, dict):
        raise ValueError(f"event must be a JSON object, got {type(obj).__name__}")
    for field in ("ts", "step", "kind"):
        if field not in obj:
            raise ValueError(f"event missing envelope field {field!r}")
    if not isinstance(obj["ts"], (int, float)) or isinstance(obj["ts"], bool):
        raise ValueError(f"ts must be a number, got {obj['ts']!r}")
    if obj["step"] is not None and (not isinstance(obj["step"], int) or isinstance(obj["step"], bool)):
        raise ValueError(f"step must be an int or null, got {obj['step']!r}")
    kind = obj["kind"]
    if kind not in KIND_SCHEMAS:
        raise ValueError(f"unknown event kind {kind!r}; known: {sorted(KIND_SCHEMAS)}")
    data = obj.get("data", {})
    if not isinstance(data, dict):
        raise ValueError(f"{kind}: data must be an object, got {type(data).__name__}")
    for name, types in KIND_SCHEMAS[kind].items():
        if name not in data:
            raise ValueError(f"{kind}: missing required data field {name!r}")
        if not _check_type(data[name], types):
            raise ValueError(
                f"{kind}: field {name!r} must be {'/'.join(t.__name__ for t in types)}, "
                f"got {data[name]!r}"
            )


def validate_jsonl(path: str) -> int:
    """Validate every line of a JSONL event file; returns the event count.
    Raises ``ValueError`` naming the first offending line."""
    n = 0
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: not valid JSON: {e}") from e
            try:
                validate_event(obj)
            except ValueError as e:
                raise ValueError(f"{path}:{lineno}: {e}") from e
            n += 1
    return n


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m repro_torch.obs.schema <events.jsonl> [...]", file=sys.stderr)
        return 2
    for path in argv:
        try:
            n = validate_jsonl(path)
        except (OSError, ValueError) as e:
            print(f"[obs.schema] FAIL {e}", file=sys.stderr)
            return 1
        print(f"[obs.schema] {path}: {n} events OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
