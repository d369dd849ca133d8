"""N-replica fleet simulation: fault accumulation vs. fleet goodput.

Each replica is a full :class:`~repro_torch.serving.server.FaultTolerantServer`
on one shared :class:`~repro_torch.serving.server.ModelBundle` (one set of
params and one FTContext, whose fault table each replica's step swaps in
place).  Each server owns its KV cache and its decode step, so on a card
each replica captures its step as a CUDA graph once; a spare that replaces
a retired replica is a fresh server and captures its own, and the retired
server's graph, cache and buffers go with it (the bundle holds its steps by
weak reference only).  Faults accumulate per replica at a Poisson
rate; a replica whose confirmed faults exceed DPPU capacity serves at reduced
admission capacity, and a replica degraded to zero surviving columns is
*retired* and replaced from a :class:`~repro_torch.runtime.elastic.SparePool` —
the HyCA flexible-pool insight applied one level up: a small global spare
pool beats region-locked spares because ANY spare can cover ANY replica.

``run_fleet`` reports fleet-level goodput (correct tokens per step, summed
over replicas), the serving-layer counterpart of the paper's Fig. 10 when
swept over the fault rate.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.campaign import ChaosSpec, apply_chaos, chaos_maps, chaos_signatures
from repro_torch.obs.events import detection_records, latency_summary
from repro_torch.models.lm import LMConfig
from repro_torch.runtime.elastic import SparePool
from repro_torch.serving.fault_manager import FaultInjector
from repro_torch.serving.queue import Request
from repro_torch.serving.server import FaultTolerantServer, ModelBundle, ServerConfig
from repro_torch.serving.traffic import TrafficSpec, requests_at, sample_trace


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    n_replicas: int = 4
    n_spares: int = 2
    spare_policy: str = "pool"     # "pool" | "region" (see runtime.elastic)
    n_regions: int = 2
    steps: int = 120
    fault_rate: float = 0.0        # Poisson new faults / replica / step
    request_rate: float = 0.5      # new requests / replica / step (fleet-wide Poisson)
    prompt_len: int = 4
    max_new_tokens: int = 8
    retire_fraction: float = 0.25  # drain a replica at/below this capacity fraction
    seed: int = 0
    # chaos experiment: at chaos.at_step, merge one campaign-sampled fault
    # map per targeted replica into its injector — the runtime is NOT told
    # (no bist); the ScanEngine probes must find the faults, which is the
    # detection-latency-under-burst measurement this hook exists for
    chaos: ChaosSpec | None = None
    # trace-driven load (serving/traffic.py): when set, arrivals come from a
    # spec-seeded per-step per-class schedule instead of the live-count
    # Poisson above — the same schedule both engines consume, which is what
    # makes legacy-vs-vectorized outcome parity exact.  request_rate/
    # prompt_len/max_new_tokens above are ignored in favour of the spec.
    traffic: TrafficSpec | None = None
    # vectorized-engine knobs (run_vfleet; ignored by the legacy loop):
    # queue-age histogram resolution, ticks between host harvests (also the
    # autoscale decision cadence), and the optional autoscaling policy
    age_bins: int = 64
    chunk_steps: int = 32
    autoscale: "object | None" = None  # AutoscaleSpec (serving/vfleet.py)
    # repro_torch.obs.series telemetry:
    #   series       — run_vfleet records one row a tick into a device ring
    #                  harvested at every chunk boundary (per-tick, per-replica channels;
    #                  report gains a "series" dict); ignored by run_fleet
    #   record_steps — run_fleet keeps every replica position's StepRecords
    #                  across spare swaps (report gains "step_records"); the
    #                  legacy half of the series↔StepRecord parity pin
    series: bool = False
    record_steps: bool = False
    # scan_block=2: the batched ScanEngine sweeps the default 8x8 array every
    # 4 steps — background scanning is cheap enough (one row-block probe a
    # step) to leave on fleet-wide.  The device is the ServerConfig's
    # ("cuda" by default; the fleet raises without CUDA unless it says "cpu")
    server: ServerConfig = dataclasses.field(
        default_factory=lambda: ServerConfig(
            n_slots=2, smax=32, mode="protected", scan_block=2
        )
    )


@dataclasses.dataclass
class ReplicaState:
    server: FaultTolerantServer
    region: int
    retired_at: int | None = None
    replaced: int = 0              # spares consumed by this replica position


def _fresh_server(bundle: ModelBundle, cfg: FleetConfig, seed: int) -> FaultTolerantServer:
    scfg = dataclasses.replace(cfg.server, fault_rate=cfg.fault_rate, seed=seed)
    return FaultTolerantServer(
        scfg, bundle=bundle,
        injector=FaultInjector(scfg.rows, scfg.cols, seed=seed),
    )


def run_fleet(cfg: FleetConfig, *, lm: LMConfig | None = None) -> dict:
    """Drive the fleet for ``cfg.steps`` and return the fleet report dict.

    ``lm``: the model every replica serves (default the smoke config of
    ``cfg.server.arch``, as the reference's fleet serves); a full-width
    :class:`~repro_torch.models.lm.LMConfig` serves that model at its width,
    with random params from ``cfg.server.seed``.

    **Telemetry semantics — every total is fleet-LIFETIME**: ``retirements``,
    ``replacements``, ``repair_events``, ``remapped_total``, ``requests_*``
    and the SLO counts all include work done by servers that were later
    retired and replaced from the spare pool (a replacement swaps the server
    object, so lifetime totals are accumulated at swap time).  Only the
    ``replica_summaries`` rows describe the *current* server in each replica
    position.  Further keys:

    * ``goodput_tokens`` — decode tokens generated fleet-wide (lifetime);
      ``goodput_per_step`` is its per-step mean.
    * ``requests_lost`` — in-flight requests that died with a retiring
      replica, plus queued requests stranded when no spare was available.
    * ``requests_unrouted`` — arrivals while NO replica was live (dropped at
      routing; counted separately from per-replica losses).
    * ``slo_requests/slo_met/slo_misses/slo_attainment`` — requests that
      carried an SLA deadline: met iff successfully finished by the
      deadline; expired/dropped/late completions AND deadline-carrying
      requests lost at retirement are misses.  ``slo_attainment`` is None
      when no request carried a deadline.

    With ``cfg.traffic`` set, arrivals follow the spec-seeded trace
    (identical for the vectorized engine — see serving/traffic.py);
    otherwise the legacy live-count Poisson arrival process runs.
    """
    rng = np.random.default_rng(cfg.seed)
    bundle = ModelBundle(dataclasses.replace(cfg.server, fault_rate=cfg.fault_rate), lm=lm)
    pool = SparePool(cfg.n_spares, policy=cfg.spare_policy, n_regions=cfg.n_regions)
    replicas = [
        ReplicaState(
            server=_fresh_server(bundle, cfg, seed=cfg.seed * 1000 + i),
            region=i % cfg.n_regions,
        )
        for i in range(cfg.n_replicas)
    ]

    vocab = bundle.lm.vocab
    next_rid = 0
    goodput_per_step: list[int] = []
    alive_per_step: list[int] = []
    retirements = 0
    replacements = 0
    requests_lost = 0
    requests_unrouted = 0

    # lifetime accumulators: harvested from a server at replacement time so
    # spare swaps don't erase its history (the old remapped_total only
    # counted non-retired replicas — inconsistent with the other totals)
    acc_remapped = 0
    acc_repair_events = 0
    acc_repair_log: list[dict] = []
    acc_slo_requests = 0
    acc_slo_met = 0
    acc_completed = 0
    acc_expired = 0
    lost_with_deadline = 0
    acc_steps: list[list] = [[] for _ in range(cfg.n_replicas)]

    def _harvest(i: int, server: FaultTolerantServer) -> None:
        nonlocal acc_remapped, acc_repair_events, acc_slo_requests
        nonlocal acc_slo_met, acc_completed, acc_expired
        acc_remapped += server.manager.n_remapped
        acc_repair_events += len(server.repair_events)
        acc_repair_log.extend(dict(ev, replica=i) for ev in server.repair_events)
        n_slo, n_met = server.metrics.slo_counts()
        acc_slo_requests += n_slo
        acc_slo_met += n_met
        acc_completed += sum(1 for c in server.metrics.completions if c.ok)
        acc_expired += sum(1 for c in server.metrics.completions
                           if c.reason == "expired")
        if cfg.record_steps:
            # per-position step history survives spare swaps; StepRecord.step
            # is the fleet clock (replacements inherit step_idx), so the
            # concatenation is chronological with no step repeated
            acc_steps[i].extend(server.metrics.steps)

    chaos_injected = 0
    chaos_batch = chaos_bits = chaos_vals = None
    if cfg.chaos is not None:
        chaos_batch = chaos_maps(cfg.chaos, cfg.n_replicas,
                                 cfg.server.rows, cfg.server.cols)
        # signatures from the SPEC seed (not each injector's RNG) so the
        # vectorized engine injects bit-identical faults — parity-critical
        chaos_bits, chaos_vals = chaos_signatures(
            cfg.chaos, cfg.n_replicas, cfg.server.rows, cfg.server.cols)

    trace = None
    trace_rng = None
    if cfg.traffic is not None:
        trace = sample_trace(cfg.traffic, cfg.steps, cfg.n_replicas,
                             cfg.server.smax)
        trace_rng = np.random.default_rng([cfg.traffic.seed, 0x7E1])

    for step in range(cfg.steps):
        if cfg.chaos is not None and step == cfg.chaos.at_step:
            for i in cfg.chaos.targets(cfg.n_replicas):
                if replicas[i].retired_at is None:
                    # stamp the event-log cursor so the fault.injected events
                    # carry the chaos step — detection latency is then exact
                    replicas[i].server.log.step = step
                    n = apply_chaos(replicas[i].server.injector, chaos_batch[i],
                                    bits=chaos_bits[i], vals=chaos_vals[i])
                    chaos_injected += n
                    replicas[i].server.log.emit("chaos.injected", n=n)
        # arrivals: least-loaded routing over live replicas
        live = [r for r in replicas if r.retired_at is None]
        if trace is not None:
            new_reqs, next_rid = requests_at(trace, step, trace_rng, vocab, next_rid)
        else:
            n_new = int(rng.poisson(cfg.request_rate * max(len(live), 1)))
            new_reqs = []
            for _ in range(n_new):
                prompt = rng.integers(0, vocab, size=cfg.prompt_len).astype(np.int32)
                new_reqs.append(Request(
                    rid=next_rid, prompt=prompt,
                    max_new_tokens=cfg.max_new_tokens, arrival_step=step,
                ))
                next_rid += 1
        for req in new_reqs:
            if not live:
                requests_unrouted += 1
                continue
            target = min(live, key=lambda r: r.server.queue.depth() + r.server.scheduler.active)
            target.server.queue.submit(req)

        tokens = 0
        for i, rep in enumerate(replicas):
            if rep.retired_at is not None:
                continue
            rep.server.step()
            tokens += rep.server.scheduler.last_step_tokens
            worn_out = rep.server.manager.capacity_fraction <= cfg.retire_fraction
            if rep.server.retired or worn_out:
                rep.retired_at = step
                retirements += 1
                # in-flight work dies with the replica; queued work survives
                # iff a spare takes over and the requests are re-routed
                requests_lost += rep.server.scheduler.active
                lost_with_deadline += sum(
                    1 for s in rep.server.scheduler.slots
                    if not s.free and s.request.deadline_step is not None
                )
                stranded = rep.server.queue.drain_all()
                if pool.try_allocate(rep.region):
                    _harvest(i, rep.server)  # lifetime totals survive the swap
                    rep.server = _fresh_server(
                        bundle, cfg, seed=cfg.seed * 1000 + 500 + replacements
                    )
                    # the replacement inherits the FLEET clock: request
                    # deadlines are absolute fleet steps, so a server whose
                    # step_idx restarted at 0 would judge expiry (and stamp
                    # completions) ~step_idx steps in the past
                    rep.server.step_idx = step + 1
                    for req in stranded:
                        rep.server.queue.submit(req)
                    rep.retired_at = None
                    rep.replaced += 1
                    replacements += 1
                else:
                    requests_lost += len(stranded)
                    lost_with_deadline += sum(
                        1 for req in stranded if req.deadline_step is not None
                    )
        goodput_per_step.append(tokens)
        alive_per_step.append(sum(r.retired_at is None for r in replicas))

    for i, rep in enumerate(replicas):
        rep.server.metrics.finish()
        _harvest(i, rep.server)

    slo_requests = acc_slo_requests + lost_with_deadline
    slo_met = acc_slo_met

    # fleet-level detection latency: merge every replica's event log (chaos
    # injections above stamp exact injection steps, so these are measured)
    det_lat: list[int] = []
    sus_lat: list[int] = []
    for r in replicas:
        for d in detection_records(r.server.log):
            if d["latency"] is not None:
                det_lat.append(d["latency"])
            if d["suspect_latency"] is not None:
                sus_lat.append(d["suspect_latency"])

    return {
        "steps": cfg.steps,
        "fault_rate": cfg.fault_rate,
        "spare_policy": cfg.spare_policy,
        "goodput_tokens": int(np.sum(goodput_per_step)),
        "goodput_per_step": float(np.mean(goodput_per_step)),
        "alive_final": alive_per_step[-1] if alive_per_step else cfg.n_replicas,
        "alive_mean": float(np.mean(alive_per_step)) if alive_per_step else float(cfg.n_replicas),
        "chaos_injected": chaos_injected,
        "chaos_at_step": cfg.chaos.at_step if cfg.chaos is not None else None,
        "retirements": retirements,
        "replacements": replacements,
        # lifetime totals: include servers consumed by spare replacement, not
        # just the current occupant of each replica position
        "remapped_total": acc_remapped,
        "repair_events": acc_repair_events,
        # full repair-hook telemetry, tagged by replica position: what was
        # remapped, where, at what quality
        "repair_event_log": acc_repair_log,
        "requests_completed": acc_completed,
        "requests_expired": acc_expired,
        "requests_lost": requests_lost,
        "requests_unrouted": requests_unrouted,
        "slo_requests": slo_requests,
        "slo_met": slo_met,
        "slo_misses": slo_requests - slo_met,
        "slo_attainment": (slo_met / slo_requests) if slo_requests else None,
        "slo_attainment_defined": bool(slo_requests),
        "spares_remaining": pool.remaining,
        "engine": "legacy",
        "scan_steps_total": sum(r.server.manager.scans for r in replicas),
        "scan_steps_per_sweep": replicas[0].server.manager.steps_per_sweep
        if replicas else 0,
        "scan_sweeps_total": sum(
            len(r.server.log.of_kind("scan.sweep")) for r in replicas
        ),
        "detection_cycles_model": replicas[0].server.manager.scan_cycles()
        if replicas else 0,
        # MEASURED fleet detection latency (chaos-stamped injections only;
        # empty without chaos or before any confirmation)
        "detections": len(det_lat),
        **latency_summary(det_lat, "detect_latency"),
        **latency_summary(sus_lat, "suspect_latency"),
        # per-replica-position StepRecord history (fleet-clock steps, spare
        # swaps included) — the legacy half of the series parity pin
        **({"step_records": [
            [dataclasses.asdict(s) for s in pos] for pos in acc_steps
        ]} if cfg.record_steps else {}),
        "replica_summaries": [
            {
                "region": r.region,
                "retired_at": r.retired_at,
                "replaced": r.replaced,
                "true_faults": r.server.injector.n_faults,
                "confirmed": r.server.manager.n_confirmed,
                "surviving_cols": r.server.manager.surviving_cols,
                "remapped": r.server.manager.n_remapped,
                "quality_fraction": r.server.manager.quality_fraction,
                "scan_steps": r.server.manager.scans,
                "scan_sweeps": len(r.server.log.of_kind("scan.sweep")),
                "repair_events": len(r.server.repair_events),
                "events": len(r.server.log),
            }
            for r in replicas
        ],
    }
