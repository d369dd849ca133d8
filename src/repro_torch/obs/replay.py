"""Postmortem replay: one incident timeline from events + series.

``python -m repro_torch.obs.replay events.jsonl --series run.npz`` joins
the two telemetry artifacts a traced run leaves behind — the JSONL event
log (``EventLog.to_jsonl``) and the device-side series ring
(:func:`~repro_torch.obs.series.save_series` of ``series_host()``) — into a
per-incident chaos timeline:

    injection (step, #faults) → detection latency (first suspect/confirm,
    per-coord percentiles) → capacity dip (effective slots before/trough/
    recovery, from the series) → SLO impact (requests expired/dropped in the
    incident window) → repair (first covering plan).

An *incident* is one distinct injection step: every ``chaos.injected``
burst, and — without chaos — every step at which ``fault.injected`` events
landed.  The run-level ``detect_latency_*`` / ``suspect_latency_*`` /
``repair_latency_*`` keys are computed by the SAME derivations
``ServingMetrics.summary()`` uses (``detection_records`` /
``repair_records`` / ``latency_summary``), so the replay's numbers match
the serving summary exactly.

The series may be scalar per step (a server run) or carry a trailing
replica axis (a fleet artifact, one column per replica): pick one with
``--replica`` or let count channels sum and fraction channels average
across the fleet.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from repro_torch.obs.events import (
    EventLog,
    detection_records,
    latency_summary,
    repair_records,
)

# fleet aggregation per channel when no --replica is chosen: counts add
# across replicas, fractions average
_SUM_CHANNELS = frozenset((
    "tokens", "queue_depth", "active", "confirmed", "effective_slots",
    "true_faults", "surviving_cols",
))


def _series_view(series: dict | None, replica: int | None) -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    for k, arr in (series or {}).items():
        a = np.asarray(arr)
        if a.ndim == 2:
            if replica is not None:
                a = a[:, replica]
            elif k in _SUM_CHANNELS:
                a = a.sum(axis=1)
            else:
                a = a.astype(np.float64).mean(axis=1)
        out[k] = a
    return out


def _f(v):
    return None if v is None else float(v)


def build_timeline(log: EventLog, series: dict | None = None, *,
                   replica: int | None = None, start_step: int = 0) -> dict:
    """The joined postmortem: run-level latency summaries (exact —
    event-derived, same code path as the serving summary) plus one record
    per injection incident, enriched with the series' capacity trajectory
    when one is supplied (``start_step``: the run step of series row 0)."""
    det = detection_records(log)
    rep = repair_records(log)
    det_lat = [d["latency"] for d in det if d["latency"] is not None]
    sus_lat = [d["suspect_latency"] for d in det
               if d["suspect_latency"] is not None]
    rep_lat = [r["latency"] for r in rep]
    sv = _series_view(series, replica)
    n_rows = len(next(iter(sv.values()))) if sv else 0

    def at(ch: str, step: int):
        a = sv.get(ch)
        if a is None or not (0 <= step - start_step < len(a)):
            return None
        return a[step - start_step]

    # incidents: one per distinct injection step (chaos bursts first-class)
    chaos_steps = sorted({e.step for e in log.of_kind("chaos.injected")
                          if e.step is not None})
    inj_steps = chaos_steps or sorted({
        e.step for e in log.of_kind("fault.injected") if e.step is not None})
    plan_steps = sorted(e.step for e in log.of_kind("repair.plan")
                        if e.step is not None)
    slo_evs = [e for e in log.of_kind("request.complete")
               if e.step is not None and e.data["reason"] in ("expired", "dropped")]

    incidents = []
    for n, s in enumerate(inj_steps):
        window_end = inj_steps[n + 1] if n + 1 < len(inj_steps) else None
        mine = [d for d in det if d["injected_step"] == s]
        lat = [d["latency"] for d in mine if d["latency"] is not None]
        conf_steps = [d["confirmed_step"] for d in mine
                      if d["confirmed_step"] is not None]
        sus_steps = [d["suspect_step"] for d in mine
                     if d["suspect_step"] is not None]
        plans = [p for p in plan_steps if p >= s]
        inc = {
            "injected_step": s,
            "n_injected": len(mine),
            "n_confirmed": len(conf_steps),
            "first_suspect_step": min(sus_steps) if sus_steps else None,
            "first_confirmed_step": min(conf_steps) if conf_steps else None,
            "last_confirmed_step": max(conf_steps) if conf_steps else None,
            **latency_summary(lat, "detect_latency"),
            "slo_failures_in_window": sum(
                1 for e in slo_evs
                if e.step >= s and (window_end is None or e.step < window_end)),
            "repair_plan_step": plans[0] if plans else None,
        }
        # capacity trajectory from the series: pre-incident level, trough,
        # and the first step the level is regained (spare swap / repair)
        eff = sv.get("effective_slots")
        if eff is not None and s - start_step < len(eff):
            i0 = s - start_step
            pre = eff[max(0, i0 - 1)]
            after = eff[i0:]
            trough_i = int(np.argmin(after))
            trough = after[trough_i]
            rec = np.nonzero(after[trough_i:] >= pre)[0]
            inc.update({
                "capacity_pre": _f(pre),
                "capacity_trough": _f(trough),
                "capacity_trough_step": s + trough_i,
                "capacity_dip": _f(pre - trough),
                "capacity_recovered_step":
                    s + trough_i + int(rec[0]) if rec.size else None,
                "quality_trough": _f(np.min(sv["quality_fraction"][i0:]))
                    if "quality_fraction" in sv else None,
            })
        incidents.append(inc)

    return {
        "events_total": len(log.events),
        "incidents": incidents,
        "detections": len(det_lat),
        **latency_summary(det_lat, "detect_latency"),
        **latency_summary(sus_lat, "suspect_latency"),
        **latency_summary(rep_lat, "repair_latency"),
        "series_rows": n_rows,
        "series_channels": sorted(sv),
    }


def render_text(tl: dict) -> str:
    """Human-readable incident timeline (the CLI's stdout)."""
    lines = [
        f"events: {tl['events_total']}  incidents: {len(tl['incidents'])}  "
        f"detections: {tl['detections']}",
    ]
    if tl["detect_latency_mean_steps"] is not None:
        lines.append(
            f"detect latency: mean {tl['detect_latency_mean_steps']:.1f} "
            f"p50 {tl['detect_latency_p50_steps']:g} "
            f"p95 {tl['detect_latency_p95_steps']:g} steps")
    if tl["repair_latency_mean_steps"] is not None:
        lines.append(
            f"repair latency: mean {tl['repair_latency_mean_steps']:.1f} "
            f"p50 {tl['repair_latency_p50_steps']:g} steps")
    if tl["series_rows"]:
        lines.append(f"series: {tl['series_rows']} rows × "
                     f"{len(tl['series_channels'])} channels")
    for inc in tl["incidents"]:
        lines.append(f"— incident @ step {inc['injected_step']}: "
                     f"{inc['n_injected']} injected, "
                     f"{inc['n_confirmed']} confirmed")
        if inc["first_confirmed_step"] is not None:
            lines.append(
                f"    detected: first suspect @ {inc['first_suspect_step']}, "
                f"first confirm @ {inc['first_confirmed_step']} "
                f"(mean latency {inc['detect_latency_mean_steps']:.1f} steps)")
        else:
            lines.append("    detected: not yet (no confirmation in log)")
        if inc.get("capacity_pre") is not None:
            rec = inc["capacity_recovered_step"]
            lines.append(
                f"    capacity: {inc['capacity_pre']:g} -> "
                f"{inc['capacity_trough']:g} @ step "
                f"{inc['capacity_trough_step']}"
                + (f", recovered @ step {rec}" if rec is not None
                   else ", not recovered"))
        lines.append(f"    SLO impact: {inc['slo_failures_in_window']} "
                     f"requests expired/dropped in window")
        if inc["repair_plan_step"] is not None:
            lines.append(f"    repair: first covering plan @ step "
                         f"{inc['repair_plan_step']}")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.replay",
        description="Join a repro_torch.obs event JSONL with a series artifact "
                    "into a per-incident postmortem timeline.",
    )
    parser.add_argument("events", help="event JSONL (EventLog.to_jsonl)")
    parser.add_argument("--series", default=None,
                        help=".npz series artifact (obs.series.save_series)")
    parser.add_argument("--replica", type=int, default=None,
                        help="select one replica column of a fleet series")
    parser.add_argument("-o", "--out", default=None,
                        help="also write the timeline as JSON here")
    args = parser.parse_args(argv)

    try:
        log = EventLog.from_jsonl(args.events)
    except OSError as exc:
        print(f"[obs.replay] FAIL {exc}", file=sys.stderr)
        return 1
    series, start_step = None, 0
    if args.series:
        from repro_torch.obs.series import load_series

        try:
            series, meta = load_series(args.series)
        except OSError as exc:
            print(f"[obs.replay] FAIL {exc}", file=sys.stderr)
            return 1
        start_step = int(meta.get("start_step", 0))
    tl = build_timeline(log, series, replica=args.replica,
                        start_step=start_step)
    sys.stdout.write(render_text(tl))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(tl, f, indent=2, default=float)
        print(f"[obs.replay] timeline JSON -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
