"""Per-step serving telemetry + aggregate summary.

One :class:`StepRecord` per server step, one completion record per finished
request.  ``summary()`` folds them into the numbers the benchmarks plot:
throughput (tokens/s wall and tokens/step), goodput (tokens of requests that
finished successfully — and, when the caller supplies a reference, that also
*match* the fault-free run), time-to-first-token percentiles, queue depth,
scan coverage, and the degraded-capacity timeline.

With an :class:`~repro_torch.obs.events.EventLog` attached (the server wires its
own), ``summary()`` also derives the fault-lifecycle observability metrics:
detection latency (injection → CONFIRMED step deltas — exact under chaos
injection, where injection steps are known), suspect latency, repair
latency, completed scan sweeps, and scan coverage.  ``counters=`` embeds a
host-folded counter dict (``FaultTolerantServer.counters_host()``).

``phases`` is the server's :class:`~repro_torch.obs.phases.PhaseClock`:
``summary()["host_phase_ms"]`` gives each phase of the step its mean host
ms a step over the steps recorded.

The wall clock starts lazily at the first ``record_step``, NOT at
construction — bundle build and kernel build time between constructing a
server and stepping it would otherwise inflate ``wall_s`` and deflate
``tokens_per_s``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.obs.events import detection_records, latency_summary, repair_records
from repro_torch.obs.phases import PhaseClock
from repro_torch.serving.queue import CompletedRequest


@dataclasses.dataclass
class StepRecord:
    step: int
    active_slots: int
    effective_slots: int
    queue_depth: int
    tokens_generated: int          # decode tokens sampled into outputs this step
    confirmed_faults: int
    true_faults: int
    surviving_cols: int
    scan_ok: bool | None           # None when no scan ran this step
    completed: int
    remapped: int = 0              # PEs handled model-side (REMAPPED)
    quality_fraction: float = 1.0  # fraction of columns with trusted output


class ServingMetrics:
    def __init__(self, n_slots: int, rows: int, cols: int,
                 steps_per_sweep: int | None = None, log=None):
        self.n_slots = n_slots
        self.rows, self.cols = rows, cols
        # probe steps per whole-array sweep: rows/scan_block with the batched
        # ScanEngine (the server passes it); the legacy one-PE-per-step
        # default is rows*cols
        self.steps_per_sweep = steps_per_sweep or rows * cols
        self.log = log
        self.steps: list[StepRecord] = []
        self.completions: list[CompletedRequest] = []
        self.phases = PhaseClock()
        self._t0: float | None = None      # set at the first record_step
        self._wall: float | None = None

    def record_step(self, rec: StepRecord, completed: list[CompletedRequest]) -> None:
        if self._t0 is None:
            self._t0 = time.perf_counter()
        self.steps.append(rec)
        self.completions.extend(completed)

    def finish(self) -> None:
        self._wall = 0.0 if self._t0 is None else time.perf_counter() - self._t0

    # ------------------------------------------------------------------ #
    @property
    def wall_s(self) -> float:
        if self._wall is not None:
            return self._wall
        return 0.0 if self._t0 is None else time.perf_counter() - self._t0

    def goodput_tokens(self, reference: dict[int, np.ndarray] | None = None) -> int:
        """Tokens from successfully completed requests.  With a ``reference``
        map (rid -> fault-free token stream), only requests whose output
        matches bit-for-bit count — wrong-but-delivered tokens are not
        goodput."""
        total = 0
        for c in self.completions:
            if not c.ok:
                continue
            if reference is not None:
                ref = reference.get(c.rid)
                if ref is None or len(ref) != len(c.tokens) or not np.array_equal(ref, c.tokens):
                    continue
            total += int(len(c.tokens))
        return total

    def slo_counts(self) -> tuple[int, int]:
        """(requests that carried an SLA deadline, how many met it).

        A deadline is *met* only by a successful completion finishing at or
        before it — expired/dropped requests and late finishes are SLO
        misses.  The fleet report folds per-replica counts (plus requests
        lost at retirement) into a fleet-lifetime ``slo_attainment``."""
        with_slo = [c for c in self.completions if c.deadline_step is not None]
        met = sum(1 for c in with_slo if c.slo_met)
        return len(with_slo), met

    def ttft_steps(self) -> list[int]:
        return [
            c.first_token_step - c.arrival_step
            for c in self.completions
            if c.first_token_step is not None
        ]

    def latency_lists(self) -> dict[str, list[int]]:
        """Raw step-latency observations per metric — the same lists
        ``summary()`` folds into mean/p50/p95."""
        out: dict[str, list[int]] = {"ttft_steps": self.ttft_steps()}
        if self.log is not None:
            det = detection_records(self.log)
            out["detect_latency_steps"] = [
                d["latency"] for d in det if d["latency"] is not None]
            out["suspect_latency_steps"] = [
                d["suspect_latency"] for d in det
                if d["suspect_latency"] is not None]
            out["repair_latency_steps"] = [
                r["latency"] for r in repair_records(self.log)]
        return out

    def summary(self, reference: dict[int, np.ndarray] | None = None, *,
                counters: dict | None = None) -> dict:
        n_steps = len(self.steps)
        toks = sum(r.tokens_generated for r in self.steps)
        good = self.goodput_tokens(reference)
        ttft = self.ttft_steps()
        scans = [r for r in self.steps if r.scan_ok is not None]
        n_pe_scans = len(scans)
        sweep = max(self.steps_per_sweep, 1)
        ok = [c for c in self.completions if c.ok]
        slo_requests, slo_met = self.slo_counts()
        out = {
            "steps": n_steps,
            "wall_s": self.wall_s,
            "tokens": toks,
            "tokens_per_step": toks / max(n_steps, 1),
            "tokens_per_s": toks / max(self.wall_s, 1e-9),
            "goodput_tokens": good,
            "goodput_per_step": good / max(n_steps, 1),
            "requests_completed": len(ok),
            "requests_failed": len(self.completions) - len(ok),
            "requests_expired": sum(1 for c in self.completions if c.reason == "expired"),
            # SLA accounting: only requests that carried a deadline count;
            # expired/dropped/late ones are misses (attainment None w/o SLAs)
            "slo_requests": slo_requests,
            "slo_met": slo_met,
            "slo_misses": slo_requests - slo_met,
            "slo_attainment": (slo_met / slo_requests) if slo_requests else None,
            # None leaves are skipped by the .prom exporter, so dashboards
            # could not tell "no SLAs configured" from a missing scrape —
            # the companion 0/1 gauge disambiguates
            "slo_attainment_defined": bool(slo_requests),
            # same mean/p50/p95 treatment as the detect/repair latency blocks
            **latency_summary(ttft, "ttft"),
            "queue_depth_mean": float(np.mean([r.queue_depth for r in self.steps])) if self.steps else 0.0,
            "scan_steps": n_pe_scans,
            "scan_sweeps": n_pe_scans / sweep,
            # fraction of the PE array probed at least once (1.0 once a full
            # sweep has completed)
            "scan_coverage": min(1.0, n_pe_scans / sweep),
            "confirmed_faults_final": self.steps[-1].confirmed_faults if self.steps else 0,
            "true_faults_final": self.steps[-1].true_faults if self.steps else 0,
            "surviving_cols_final": self.steps[-1].surviving_cols if self.steps else self.cols,
            "effective_slots_min": min((r.effective_slots for r in self.steps), default=self.n_slots),
            "effective_slots_final": self.steps[-1].effective_slots if self.steps else self.n_slots,
            "remapped_final": self.steps[-1].remapped if self.steps else 0,
            "quality_fraction_final": self.steps[-1].quality_fraction if self.steps else 1.0,
            "host_phase_ms": self.phases.ms_per_step(n_steps),
        }
        if self.log is not None:
            det = detection_records(self.log)
            lat = [d["latency"] for d in det if d["latency"] is not None]
            slat = [d["suspect_latency"] for d in det if d["suspect_latency"] is not None]
            rlat = [r["latency"] for r in repair_records(self.log)]
            out["events_total"] = len(self.log.events)
            out["detections"] = len(lat)
            out["injection_steps"] = sorted({
                d["injected_step"] for d in det if d["injected_step"] is not None
            })
            out.update(latency_summary(lat, "detect_latency"))
            out.update(latency_summary(slat, "suspect_latency"))
            out.update(latency_summary(rlat, "repair_latency"))
            out["sweeps_completed"] = len(self.log.of_kind("scan.sweep"))
            out["abft_alarms"] = len(self.log.of_kind("abft.alarm"))
        if counters is not None:
            out["counters"] = counters
        return out
