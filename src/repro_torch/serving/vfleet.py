"""run_vfleet — the vectorized fleet engine: one batched tick for the fleet.

The legacy :func:`~repro_torch.serving.fleet.run_fleet` loop steps every
replica's FaultTolerantServer in Python, O(replicas · steps) host iterations,
each a real decode.  This engine replays the same fleet semantics as batched
integer and bool tensor ops with a leading replica axis: one tick advances
every replica, and a run is ``steps`` ticks, harvested to the host once per
chunk of ``FleetConfig.chunk_steps`` ticks.

What is batched, and how it stays exact (held against ``run_fleet`` on the
same FleetConfig + TrafficSpec, and against the reference's ``run_vfleet``):

  * **fault truth + scan pipeline** — per-replica (rows, cols) fault and
    stuck-at grids; every tick probes each replica's cursor row-block with
    the shared :func:`repro_torch.core.scan.probe_operands` schedule and the
    int32 corruption math of :func:`repro_torch.core.scan.corrupt_probe`, so
    the hit/confirm trajectory is bit-identical.  The probe's int32 product
    runs as a float64 batched matmul, exact below 2**53 (the operands are in
    [-4, 8)); CUDA has no integer GEMM.  Chaos injection takes its stuck-at
    signatures from :func:`repro_torch.core.campaign.chaos_signatures`, the
    grids the legacy loop injects.
  * **request flow** — the queue is an (age × class) count matrix, decode
    slots are per-class countdown histograms (a request of class k holds a
    slot for ``prompt+gen-1`` steps and emits a token on the last ``gen`` of
    them, the scheduler's token-level accounting, eos-free).  Arrivals come
    from the shared :func:`~repro_torch.serving.traffic.sample_trace`;
    least-loaded routing with the lowest index on ties is an exact
    water-fill (the final level in closed form over the sorted loads, then
    one extra each to the lowest-index replicas still below it).  SLA expiry
    reproduces ``pop_ready`` for any class mix: an expired request is
    dropped iff the admission walk reaches it before free capacity runs out
    (a masked cumsum over the age-desc / class-asc pop order).
  * **capacity / retire / spares** — surviving-column prefix, effective
    slots, the retire threshold, and pool- or region-policy spare grants are
    integer ops; grants follow replica index order as in the legacy loop.

Wearout is the one part that is random: Poisson new faults a live replica a
tick, uniform over its healthy PEs.  The port draws it from a seeded
``torch.Generator`` on the device (Poisson by inversion of a uniform against
the rate's CDF, placement by the ranks of uniform priorities), so with
``fault_rate > 0`` it matches the reference in distribution, not draw for
draw (JAX's threefry streams cannot be replayed).

One build per geometry: the state, the parameters (the trace's counts, the
fault-rate CDF, the chaos map and signatures) and the tick's static tables
live in fixed buffers of a program cached by the tick geometry
(:class:`_Geom`) and the run's shape; a run rewrites them in place, so a
fault-rate sweep or a change of chaos spec reuses one build (``_TRACES``
gets one entry a build, the reference's no-retrace witness).  On a card the
tick is captured once as a CUDA graph over those buffers, with the tick
index ``t`` a device scalar the graph advances, and a chunk is that many
replays; the wearout uniforms of a chunk are drawn into a buffer before it,
outside the graph.  ``capture=False`` runs the same tick eagerly, the
comparison the graph is held to.

Autoscaling runs as a host hook between chunks (decision cadence =
``FleetConfig.chunk_steps``): an :class:`AutoscaleSpec` scales the
provisioned replica set between min and max on mean queue depth, emitting
``fleet.autoscale`` events through the event log.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.campaign import chaos_maps, chaos_signatures
from repro_torch.core.engine import FaultState, empty_fault_state
from repro_torch.core.scan import corrupt_probe, probe_operands
from repro_torch.runtime.elastic import initial_spares
from repro_torch.serving.fleet import FleetConfig
from repro_torch.serving.server import resolve_device
from repro_torch.serving.traffic import sample_trace

# one entry appended per build of a tick program: the no-rebuild witness
# (a fault-rate sweep must leave its length unchanged)
_TRACES: list = []
_PROGRAMS: dict = {}

_COUNTERS = (
    "tokens_total", "clean_tokens", "chaos_injected", "retirements",
    "replacements", "requests_lost", "requests_unrouted",
    "requests_completed", "requests_expired", "slo_met", "slo_miss",
)
_C = {k: i for i, k in enumerate(_COUNTERS)}
_SERIES = {
    "tokens": torch.int64, "queue_depth": torch.int64, "active": torch.int64,
    "confirmed": torch.int64, "effective_slots": torch.int64,
    "true_faults": torch.int64, "surviving_cols": torch.int64,
    "scan_coverage": torch.float32, "capacity_fraction": torch.float32,
    "quality_fraction": torch.float32, "live": torch.bool,
}
_SERIES_NP = {torch.int64: np.int32, torch.float32: np.float32, torch.bool: np.bool_}


@dataclasses.dataclass(frozen=True)
class AutoscaleSpec:
    """Queue-depth autoscaling policy (host hook between chunks)."""

    min_replicas: int = 1
    max_replicas: int = 8
    high_queue: float = 8.0    # mean queued requests / live replica -> scale out
    low_queue: float = 0.5     # -> scale in (idle replicas only)
    step_size: int = 1


@dataclasses.dataclass(frozen=True)
class _Geom:
    """Static tick geometry: with the run's shape, the key of a build
    (hashable; every workload and fault knob is a buffer)."""

    n_replicas: int            # R — replica-axis size (max_replicas w/ autoscale)
    rows: int
    cols: int
    block: int                 # scan_block (rows probed per tick)
    window: int                # probe window
    confirm_hits: int
    capacity: int              # DPPU repair capacity (HyCAConfig.capacity)
    n_slots: int
    thresh: int                # retire iff surviving_cols <= thresh
    n_regions: int             # spare-pool regions (1 under "pool")
    policy: str                # "pool" | "region"
    age_bins: int              # A — queue-age histogram depth
    slot_bins: int             # C — slot countdown bins (max service + 1)
    # per-request-class statics (from the TrafficSpec quantization)
    service: tuple[int, ...]   # prompt+gen-1 slot-occupancy steps
    gen: tuple[int, ...]       # decode tokens per request
    wait: tuple[int, ...]      # max queue age before SLA expiry (age_bins = none)
    has_sla: tuple[bool, ...]


def _retire_threshold(cols: int, retire_fraction: float) -> int:
    """Largest surviving-column count that still retires, computed with the
    float comparison the legacy loop applies per replica
    (``capacity_fraction <= retire_fraction``), so both engines retire on
    the same integer boundary."""
    return max(s for s in range(cols + 1) if s / cols <= retire_fraction)


def _water_fill(load: torch.Tensor, live: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Distribute ``n`` arrivals greedily least-loaded, lowest index on
    ties: the legacy loop's per-request ``min()`` routing, closed form.

    The fill that brings every live replica below level L up to L is
    ``max_j (j·L - P_j)`` over the sorted loads' prefix sums P_j, so the
    final level, the least L whose fill reaches n, is
    ``min_j ceil((n + P_j) / j)``: the level the reference finds by binary
    search.  Everyone is filled to L-1, then one extra each goes to the
    lowest-index replicas still at L-1."""
    big = torch.iinfo(torch.int64).max // 4
    l = torch.where(live, load, torch.full_like(load, big))
    s, _ = torch.sort(l)
    j = torch.arange(1, l.shape[0] + 1, device=l.device)
    p = torch.cumsum(torch.where(s < big, s, torch.zeros_like(s)), 0)
    nn = torch.clamp(n, min=1)
    cand = torch.div(nn + p + j - 1, j, rounding_mode="floor")
    level = torch.where(s < big, cand, torch.full_like(cand, big)).min()
    base = torch.where(live, torch.clamp(level - 1 - l, min=0), torch.zeros_like(l))
    extras = n - base.sum()
    eligible = live & (l <= level - 1)
    first = torch.cumsum(eligible.long(), 0) - eligible.long()  # exclusive
    extra = (eligible & (first < extras)).long()
    return torch.where(n > 0, base + extra, torch.zeros_like(base))


class _Program:
    """One build: fixed buffers of state, parameters and static tables for a
    (geometry, steps, chunk, series, device), and the tick over them."""

    def __init__(self, geom: _Geom, steps: int, chunk: int, series: bool, device: torch.device):
        _TRACES.append((geom, steps, chunk, series))
        g, dev = geom, device
        self.geom, self.steps, self.chunk, self.device = g, steps, chunk, dev
        R, rows, cols, K, A, C = g.n_replicas, g.rows, g.cols, len(g.service), g.age_bins, g.slot_bins
        P = rows * cols
        i64 = torch.int64

        def z(*shape, dtype=i64):
            return torch.zeros(shape, dtype=dtype, device=dev)

        steps_per_sweep = rows // g.block
        n_sweeps = steps // steps_per_sweep + 2
        # parameters, rewritten in place by load()
        self.counts = z(max(steps, 1), K)
        self.wear_cdf = z(P, dtype=torch.float64)
        self.chaos_at = z(1)
        self.chaos_mask = z(R, rows, cols, dtype=torch.bool)
        self.chaos_bits = z(R, rows, cols, dtype=torch.int32)
        self.chaos_vals = z(R, rows, cols, dtype=torch.int32)
        self.wear_bits = z(R, rows, cols, dtype=torch.int32)
        self.wear_vals = z(R, rows, cols, dtype=torch.int32)
        ops = [probe_operands(rows, cols, sw, g.window) for sw in range(n_sweeps)]
        self.px_sched = torch.from_numpy(np.stack([px for px, _ in ops])).to(dev, torch.float64)
        self.pw_sched = torch.from_numpy(np.stack([pw for _, pw in ops])).to(dev, torch.float64)
        # wearout uniforms of one chunk, drawn before it
        self.u_n = z(chunk, R, dtype=torch.float32)
        self.u_place = z(chunk, R, P, dtype=torch.float32)
        # static tables
        region = np.arange(R) % max(g.n_regions, 1)
        onehot = np.zeros((R, g.n_regions), bool)
        onehot[np.arange(R), region if g.policy == "region" else 0] = True
        self.region_onehot = torch.from_numpy(onehot).to(dev)
        pop_age = np.repeat(np.arange(A)[::-1], K)
        pop_cls = np.tile(np.arange(K), A)
        self.exp_mask = torch.from_numpy(pop_age > np.asarray(g.wait)[pop_cls]).to(dev)
        enter = np.zeros((K, C), np.int64)
        enter[np.arange(K), np.asarray(g.service)] = 1
        self.enter = torch.from_numpy(enter).to(dev)
        c_ix = np.arange(C)
        self.tok_mask = torch.from_numpy(
            np.stack([(c_ix >= 1) & (c_ix <= g.gen[k]) for k in range(K)]).astype(np.int64)).to(dev)
        self.has_sla = torch.tensor(g.has_sla, dtype=i64, device=dev)
        block_of_row = np.arange(rows) // g.block
        self.block_of_row = torch.from_numpy(block_of_row).to(dev)
        # state, reset by load()
        self.t = z(1)
        self.chunk0 = z(1)
        self.fault = z(R, rows, cols, dtype=torch.bool)
        self.sbit = z(R, rows, cols, dtype=torch.int32)
        self.sval = z(R, rows, cols, dtype=torch.int32)
        self.hits = z(R, rows, cols)
        self.cursor = z(R)
        self.sweep = z(R)
        self.queue = z(R, A, K)
        self.slots = z(R, K, C)
        self.provisioned = z(R, dtype=torch.bool)
        self.dead = z(R, dtype=torch.bool)
        self.spares = z(g.n_regions)
        self.counters = z(len(_COUNTERS))
        self.wait_hist = z(K, A)
        self.ys = z(max(steps, 1), 4)
        self.series = ({k: z(min(chunk, steps), R, dtype=d) for k, d in _SERIES.items()}
                       if series else None)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.captures = 0

    def load(self, params: dict, state: dict) -> None:
        """Rewrite the buffers in place for a new run."""
        for k, v in {**params, **state}.items():
            getattr(self, k).copy_(torch.as_tensor(v).to(self.device))
        for k in ("t", "chunk0", "hits", "cursor", "sweep", "queue", "slots", "counters",
                  "wait_hist", "ys"):
            getattr(self, k).zero_()
        if self.series is not None:
            for v in self.series.values():
                v.zero_()

    # ------------------------------------------------------------------ #
    def tick(self) -> None:
        """One tick of every replica, read from and written back into the
        buffers (so a CUDA graph can hold it)."""
        g = self.geom
        R, rows, cols, K, A = g.n_replicas, g.rows, g.cols, len(g.service), g.age_bins
        t = self.t
        j = t - self.chunk0
        live = self.provisioned & ~self.dead
        fault, sbit, sval = self.fault, self.sbit, self.sval
        queue, slots = self.queue, self.slots
        inc = torch.zeros(len(_COUNTERS), dtype=torch.int64, device=self.device)

        # 1. chaos: merge the sampled maps into live replicas' truth at chaos_at
        hit = (t == self.chaos_at) & live[:, None, None]
        inj = self.chaos_mask & ~fault & hit
        sbit = torch.where(inj, self.chaos_bits, sbit)
        sval = torch.where(inj, self.chaos_vals, sval)
        fault = fault | inj
        inc[_C["chaos_injected"]] += inj.sum()

        # 2. arrivals: per-class sequential water-fill (the trace emits
        # classes in ascending order; the legacy loop routes in that order)
        counts_t = self.counts.index_select(0, t)[0]
        any_live = live.any()
        load = queue.sum((1, 2)) + slots.sum((1, 2))
        new = torch.zeros((R, K), dtype=torch.int64, device=self.device)
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        for k in range(K):
            n_k = counts_t[k]
            inc[_C["requests_unrouted"]] += torch.where(any_live, zero, n_k)
            new_k = _water_fill(load, live, torch.where(any_live, n_k, zero))
            new[:, k] = new_k
            load = load + new_k
        queue = torch.cat([queue[:, :1, :] + new[:, None, :], queue[:, 1:, :]], dim=1)

        # 3. wearout: Poisson(rate) new faults per live replica (inversion of
        # a uniform against the rate's CDF), placed on the healthy PEs of
        # least uniform priority
        u_n = self.u_n.index_select(0, j)[0]
        u_pl = self.u_place.index_select(0, j)[0]
        n_new = (u_n.double()[:, None] > self.wear_cdf[None, :]).sum(1)
        flat_fault = fault.reshape(R, -1)
        pri = torch.where(flat_fault, torch.full_like(u_pl, 2.0), u_pl)
        rank = torch.argsort(torch.argsort(pri, dim=1, stable=True), dim=1, stable=True)
        wear = (rank < n_new[:, None]) & (pri < 1.5) & live[:, None]
        wear = wear.reshape(R, rows, cols)
        sbit = torch.where(wear, self.wear_bits, sbit)
        sval = torch.where(wear, self.wear_vals, sval)
        fault = fault | wear

        # 4. scan: probe each live replica's cursor row-block against the
        # shared per-sweep operand schedule (the int32 math of corrupt_probe)
        sweep_i = torch.clamp(self.sweep, 0, self.px_sched.shape[0] - 1)
        clean = torch.bmm(self.px_sched[sweep_i], self.pw_sched[sweep_i]).to(torch.int64).to(torch.int32)
        flags = (corrupt_probe(clean, fault, sbit, sval) != clean) | \
                (corrupt_probe(-clean, fault, sbit, sval) != -clean)
        in_block = self.block_of_row[None, :] == self.cursor[:, None]          # (R, rows)
        countable = flags & in_block[:, :, None] & (self.hits < g.confirm_hits) & live[:, None, None]
        hits = self.hits + countable.long()
        last = self.cursor == (rows // g.block) - 1
        cursor = torch.where(live, torch.where(last, torch.zeros_like(self.cursor), self.cursor + 1), self.cursor)
        sweep = self.sweep + (last & live).long()

        # 5. capacity: confirmed overflow retires the column suffix (leftmost-
        # first repair priority), effective slots shrink proportionally
        conf = hits >= g.confirm_hits
        nconf = conf.sum((1, 2))
        csum = torch.cumsum(conf.sum(1), dim=1)                                # (R, cols)
        first_over = torch.argmax((csum >= g.capacity + 1).to(torch.int8), dim=1)
        surv = torch.where(nconf <= g.capacity, torch.full_like(nconf, cols), first_over)
        eff = torch.where(
            surv >= cols, torch.full_like(surv, g.n_slots),
            torch.where(surv == 0, torch.zeros_like(surv), torch.clamp((g.n_slots * surv) // cols, min=1)),
        )
        eff = torch.where(live, eff, torch.zeros_like(eff))

        # 6. admission: walk the FIFO in pop order (age-desc, class-asc within
        # an age — the submit order).  ``pop_ready`` drops an SLA-expired
        # request only when the walk reaches it with free capacity left, and
        # the walk stops at the admission filling the last free slot, so
        # "reached" is exactly `admissible-before-me < free`: one masked
        # cumsum reproduces the legacy per-item loop for any class mix.
        active = slots.sum((1, 2))
        free = torch.clamp(eff - active, min=0)
        q_pop = queue.flip(1).reshape(R, A * K)                                # pop order
        adm = torch.where(self.exp_mask[None, :], torch.zeros_like(q_pop), q_pop)
        excl = torch.cumsum(adm, dim=1) - adm                                  # admissible before b
        reached = excl < free[:, None]
        drop = torch.where(self.exp_mask[None, :] & reached, q_pop, torch.zeros_like(q_pop))
        take = torch.minimum(torch.clamp(free[:, None] - excl, min=0), adm)
        queue = (q_pop - drop - take).reshape(R, A, K).flip(1)
        drop_k = drop.reshape(R, A, K).sum((0, 1))                             # per class
        inc[_C["requests_expired"]] += drop_k.sum()
        inc[_C["slo_miss"]] += (drop_k * self.has_sla).sum()
        take_ak = take.reshape(R, A, K).flip(1)                                # (R, age, class)
        wait_hist = self.wait_hist + take_ak.sum(0).T
        slots = slots + take_ak.sum(1)[:, :, None] * self.enter[None]

        # 7. decode proxy: a slot at countdown c emits a token iff c <= gen
        # (the last `gen` occupancy steps), completes at c == 1.  Every
        # completion is on time: SLA admission guarantees finish <= deadline.
        tokens_r = (slots * self.tok_mask[None]).sum((1, 2))
        done = slots[:, :, 1]                                                  # (R, K)
        inc[_C["requests_completed"]] += done.sum()
        inc[_C["slo_met"]] += (done * self.has_sla[None]).sum()
        inc[_C["tokens_total"]] += tokens_r.sum()
        unconfirmed = (fault & (hits < g.confirm_hits)).any(2).any(1)
        inc[_C["clean_tokens"]] += torch.where(unconfirmed, torch.zeros_like(tokens_r), tokens_r).sum()

        # series: one per-replica row a tick, at the point the legacy server
        # records its StepRecord (post-scan, post-admission, pre-commit/
        # aging/retire)
        if self.series is not None:
            spsw = rows // g.block
            probes = sweep * spsw + cursor
            row = {
                "tokens": tokens_r, "queue_depth": queue.sum((1, 2)), "active": slots.sum((1, 2)),
                "confirmed": nconf, "effective_slots": eff, "true_faults": fault.sum((1, 2)),
                "surviving_cols": surv,
                "scan_coverage": torch.clamp(probes.float() / spsw, max=1.0),
                "capacity_fraction": surv.float() / cols,
                "quality_fraction": torch.ones(R, dtype=torch.float32, device=self.device),
                "live": live,
            }
            for k, buf in self.series.items():
                buf.index_copy_(0, j, row[k][None].to(buf.dtype))

        zk = torch.zeros((R, K, 1), dtype=torch.int64, device=self.device)
        slots = torch.cat([zk, slots[:, :, 2:], zk], dim=2)                   # countdown shift

        # 8. queue aging (post-step, so age == steps waited; clamps at A-1)
        queue = torch.cat([torch.zeros((R, 1, K), dtype=torch.int64, device=self.device), queue[:, : A - 2, :],
                           (queue[:, A - 2, :] + queue[:, A - 1, :])[:, None, :]], dim=1)

        # 9. retire + spare replacement (post-step check, replica index order)
        dying = live & (surv <= g.thresh)
        inc[_C["retirements"]] += dying.sum()
        inc[_C["requests_lost"]] += torch.where(dying, slots.sum((1, 2)), torch.zeros_like(surv)).sum()
        sla_slots = (slots.sum(2) * self.has_sla[None]).sum(1)
        inc[_C["slo_miss"]] += torch.where(dying, sla_slots, torch.zeros_like(sla_slots)).sum()
        in_rg = dying[:, None] & self.region_onehot                            # (R, regions)
        g_rg = in_rg & (torch.cumsum(in_rg.long(), 0) <= self.spares[None, :])
        spares = self.spares - g_rg.long().sum(0)
        grant = g_rg.any(1)
        inc[_C["replacements"]] += grant.sum()
        # granted: a fresh server takes over — clean array, reset scan state,
        # queued work survives (resubmitted).  Not granted: the replica is
        # dead, in-flight and queued work are lost.
        g3 = grant[:, None, None]
        fault = fault & ~g3
        sbit = torch.where(g3, self.wear_bits, sbit)
        sval = torch.where(g3, self.wear_vals, sval)
        hits = torch.where(g3, torch.zeros_like(hits), hits)
        cursor = torch.where(grant, torch.zeros_like(cursor), cursor)
        sweep = torch.where(grant, torch.zeros_like(sweep), sweep)
        unlucky = dying & ~grant
        q_r = queue.sum((1, 2))
        inc[_C["requests_lost"]] += torch.where(unlucky, q_r, torch.zeros_like(q_r)).sum()
        sla_q = (queue.sum(1) * self.has_sla[None]).sum(1)
        inc[_C["slo_miss"]] += torch.where(unlucky, sla_q, torch.zeros_like(sla_q)).sum()
        queue = torch.where(unlucky[:, None, None], torch.zeros_like(queue), queue)
        slots = torch.where(dying[:, None, None], torch.zeros_like(slots), slots)
        dead = self.dead | unlucky

        alive = (self.provisioned & ~dead).sum()
        ys = torch.stack([tokens_r.sum(), alive, queue.sum(), slots.sum()])
        self.ys.index_copy_(0, t, ys[None])
        new_state = dict(fault=fault, sbit=sbit, sval=sval, hits=hits, cursor=cursor, sweep=sweep,
                         queue=queue, slots=slots, spares=spares, dead=dead,
                         counters=self.counters + inc, wait_hist=wait_hist)
        for k, v in new_state.items():
            getattr(self, k).copy_(v)
        self.t.add_(1)

    # ------------------------------------------------------------------ #
    def run_chunk(self, n: int, gen: torch.Generator, fault_rate: float, capture: bool) -> None:
        """Advance ``n`` ticks from the current ``t``: draw the chunk's
        wearout uniforms (only where faults can wear in), then tick."""
        self.chunk0.copy_(self.t)
        if fault_rate > 0:
            self.u_n.uniform_(generator=gen)
            self.u_place.uniform_(generator=gen)
        for _ in range(n):
            if not capture:
                self.tick()
            elif self.graph is None:
                self._warm_up_and_capture()
            else:
                self.graph.replay()

    def _warm_up_and_capture(self) -> None:
        dev = self.device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.tick()  # this tick's own work, run eagerly: the warm-up
        main.wait_stream(side)
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.tick()
        torch.cuda.synchronize(dev)
        self.graph = graph
        self.captures += 1


def _weighted_percentile(values: np.ndarray, weights: np.ndarray, q: float):
    w = np.asarray(weights, np.float64)
    if w.sum() <= 0:
        return None
    order = np.argsort(values)
    v, w = np.asarray(values, np.float64)[order], w[order]
    cdf = np.cumsum(w) / w.sum()
    return float(v[np.searchsorted(cdf, q / 100.0, side="left")])


def batched_confirmed_states(hits, sbit, sval, *, confirm_hits: int) -> FaultState:
    """Fold the engine's per-replica confirmed grids into one batched
    :class:`~repro_torch.core.engine.FaultState` (leading replica axis,
    leftmost-sorted entries, the ``campaign.batched_fault_states`` layout),
    on the device of ``hits``: the batched merge of each replica's
    confirmed PEs into an empty table."""
    hits = torch.as_tensor(hits)
    n, rows, cols = hits.shape
    m = rows * cols
    empty = empty_fault_state(m, device=hits.device)
    states = FaultState(empty.fpt.expand(n, m, 2), empty.stuck_bit.expand(n, m), empty.stuck_val.expand(n, m))
    return states.merge_batched(
        hits >= confirm_hits,
        stuck_bit=torch.as_tensor(sbit).to(hits.device),
        stuck_val=torch.as_tensor(sval).to(hits.device),
    )


# --------------------------------------------------------------------------- #
# driver
# --------------------------------------------------------------------------- #
def _build(cfg: FleetConfig, device: torch.device):
    """The run's geometry, trace and initial buffers, and its program (made
    once per geometry and run shape)."""
    s = cfg.server
    if cfg.traffic is None:
        raise ValueError("run_vfleet needs FleetConfig.traffic (a TrafficSpec)")
    if s.mode != "protected":
        raise ValueError("run_vfleet models the protected serving mode only")
    if s.repair != "none":
        raise ValueError("run_vfleet does not model repro_torch.repair remediation")
    if s.rows % s.scan_block:
        raise ValueError("scan_block must divide rows")

    auto = cfg.autoscale
    R = max(cfg.n_replicas, auto.max_replicas) if auto is not None else cfg.n_replicas
    trace = sample_trace(cfg.traffic, cfg.steps, cfg.n_replicas, s.smax)
    classes = trace.classes
    service = tuple(c.service_steps for c in classes)
    A = max(cfg.age_bins,
            max((c.wait_budget + 2 for c in classes if c.wait_budget is not None), default=0))
    wait = tuple(A if c.wait_budget is None else c.wait_budget for c in classes)
    geom = _Geom(
        n_replicas=R, rows=s.rows, cols=s.cols, block=s.scan_block,
        window=8, confirm_hits=s.confirm_hits,
        capacity=s.hyca().capacity, n_slots=s.n_slots,
        thresh=_retire_threshold(s.cols, cfg.retire_fraction),
        n_regions=cfg.n_regions if cfg.spare_policy == "region" else 1,
        policy=cfg.spare_policy,
        age_bins=A, slot_bins=max(service) + 1,
        service=service, gen=tuple(c.max_new_tokens for c in classes), wait=wait,
        has_sla=tuple(c.sla_steps is not None for c in classes),
    )
    chunk = max(1, cfg.chunk_steps)
    key = (geom, cfg.steps, chunk, bool(cfg.series), str(device))
    prog = _PROGRAMS.get(key)
    if prog is None:
        prog = _PROGRAMS[key] = _Program(geom, cfg.steps, chunk, bool(cfg.series), device)

    shape = (R, s.rows, s.cols)
    wr = np.random.default_rng([cfg.seed, 0x3EA4])
    cmask = np.zeros(shape, bool)
    cbits = np.zeros(shape, np.int32)
    cvals = np.zeros(shape, np.int32)
    chaos_at = -1
    if cfg.chaos is not None:
        maps = chaos_maps(cfg.chaos, cfg.n_replicas, s.rows, s.cols)
        for i in cfg.chaos.targets(cfg.n_replicas):
            cmask[i] = maps[i]
        b, v = chaos_signatures(cfg.chaos, cfg.n_replicas, s.rows, s.cols)
        cbits[: cfg.n_replicas], cvals[: cfg.n_replicas] = b, v
        chaos_at = cfg.chaos.at_step
    wear_bits = wr.integers(0, 32, size=shape, dtype=np.int32)
    wear_vals = wr.integers(0, 2, size=shape, dtype=np.int32)
    # the Poisson CDF at 0..P-1 new faults (more than P faults fill the array)
    P = s.rows * s.cols
    lam = float(cfg.fault_rate)
    terms = np.ones(P)
    terms[1:] = lam / np.arange(1, P)
    cdf = np.cumsum(np.exp(-lam) * np.cumprod(terms))
    counts = np.zeros((max(cfg.steps, 1), len(classes)), np.int64)
    counts[: cfg.steps] = trace.counts
    params = {
        "counts": counts, "wear_cdf": cdf, "chaos_at": np.array([chaos_at]),
        "chaos_mask": cmask, "chaos_bits": cbits, "chaos_vals": cvals,
        "wear_bits": wear_bits, "wear_vals": wear_vals,
    }
    state = {
        "fault": np.zeros(shape, bool), "sbit": wear_bits, "sval": wear_vals,
        "provisioned": np.arange(R) < cfg.n_replicas, "dead": np.zeros(R, bool),
        "spares": initial_spares(cfg.n_spares, cfg.spare_policy, cfg.n_regions).astype(np.int64),
    }
    prog.load(params, state)
    return geom, prog, trace


def _autoscale(cfg: FleetConfig, prog: _Program, step: int, log) -> None:
    """Host-side scaling decision at chunk boundaries (rewrites the
    provisioned set in place)."""
    auto = cfg.autoscale
    prov = prog.provisioned.cpu().numpy().copy()
    dead = prog.dead.cpu().numpy()
    live = prov & ~dead
    n_live = int(live.sum())
    if n_live == 0:
        return
    qd = prog.queue.sum((1, 2)).cpu().numpy()
    busy = qd + prog.slots.sum((1, 2)).cpu().numpy()
    q_mean = float(qd[live].sum() / n_live)
    action, n = None, 0
    if q_mean >= auto.high_queue and n_live < auto.max_replicas:
        idle_slots = np.nonzero(~prov & ~dead)[0]
        n = min(auto.step_size, auto.max_replicas - n_live, len(idle_slots))
        if n > 0:
            prov[idle_slots[:n]] = True
            action = "scale_out"
    elif q_mean <= auto.low_queue and n_live > auto.min_replicas:
        idle = np.nonzero(live & (busy == 0))[0]
        n = min(auto.step_size, n_live - auto.min_replicas, len(idle))
        if n > 0:
            prov[idle[-n:]] = False                         # drop highest index
            action = "scale_in"
    if action is None:
        return
    if log is not None:
        log.step = step
        log.emit(
            "fleet.autoscale", action=action, n=int(n),
            queue_depth_mean=q_mean,
            capacity_mean=float(busy[live].mean()),
            live=int((prov & ~dead).sum()),
        )
    prog.provisioned.copy_(torch.from_numpy(prov))


def run_vfleet(cfg: FleetConfig, *, log=None, capture: bool | None = None) -> dict:
    """Vectorized fleet campaign on ``cfg.server.device`` ("cuda" by
    default; it raises without CUDA unless that says "cpu"): the same
    FleetConfig + TrafficSpec, the same report keys and, on the
    shared-semantics subset (goodput, retirements, spare consumption, SLO
    counts…), the same values as ``run_fleet``.  ``log``: optional EventLog
    receiving ``fleet.autoscale`` events.  ``capture``: hold the tick as a
    CUDA graph (default: on a card).  Adds ``sim_wall_s`` (wall time of the
    simulation loop, the first run's build and capture included) and
    latency percentiles derived from the admission-wait histogram."""
    device = resolve_device(cfg.server.device)
    if capture is None:
        capture = device.type == "cuda"
    elif capture and device.type != "cuda":
        raise ValueError(f"a CUDA graph holds the tick on a card, not on {device}")
    t0 = time.perf_counter()
    geom, prog, trace = _build(cfg, device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    chunk = prog.chunk
    series_rows: list[dict] = []
    step = 0
    while step < cfg.steps:
        n = min(chunk, cfg.steps - step)
        prog.run_chunk(n, gen, cfg.fault_rate, capture)
        step += n
        if prog.series is not None:
            # the one device-to-host read of the telemetry path: drain the
            # chunk's rows before the next chunk overwrites them
            series_rows.append({k: v[:n].cpu().numpy().astype(_SERIES_NP[v.dtype])
                                for k, v in prog.series.items()})
        if cfg.autoscale is not None and step < cfg.steps:
            _autoscale(cfg, prog, step, log)
    ys = prog.ys[: cfg.steps].cpu().numpy()
    cvec = prog.counters.cpu().numpy()
    hist = prog.wait_hist.cpu().numpy().astype(np.int32)                  # (K, A)
    spares_rem = int(prog.spares.sum())
    wall = time.perf_counter() - t0

    c = {k: int(cvec[i]) for k, i in _C.items()}
    tok, alive, qdepth = ys[:, 0], ys[:, 1], ys[:, 2]
    waits = np.tile(np.arange(geom.age_bins), len(geom.service))
    e2e = np.concatenate([
        np.arange(geom.age_bins) + geom.service[k] - 1
        for k in range(len(geom.service))
    ])
    w = hist.reshape(-1)
    slo_requests = c["slo_met"] + c["slo_miss"]
    report = {
        "engine": "vfleet",
        "steps": cfg.steps,
        "fault_rate": cfg.fault_rate,
        "spare_policy": cfg.spare_policy,
        "goodput_tokens": int(tok.sum()),
        "goodput_per_step": float(tok.mean()) if tok.size else 0.0,
        "clean_tokens": c["clean_tokens"],
        "alive_final": int(alive[-1]) if alive.size else cfg.n_replicas,
        "alive_mean": float(alive.mean()) if alive.size else float(cfg.n_replicas),
        "queue_depth_mean": float(qdepth.mean()) if qdepth.size else 0.0,
        "chaos_injected": c["chaos_injected"],
        "chaos_at_step": cfg.chaos.at_step if cfg.chaos is not None else None,
        "retirements": c["retirements"],
        "replacements": c["replacements"],
        "requests_total": trace.total_requests,
        "requests_completed": c["requests_completed"],
        "requests_expired": c["requests_expired"],
        "requests_lost": c["requests_lost"],
        "requests_unrouted": c["requests_unrouted"],
        "slo_requests": slo_requests,
        "slo_met": c["slo_met"],
        "slo_misses": c["slo_miss"],
        "slo_attainment": (c["slo_met"] / slo_requests) if slo_requests else None,
        "slo_attainment_defined": bool(slo_requests),
        "spares_remaining": spares_rem,
        "latency_wait_p50": _weighted_percentile(waits, w, 50),
        "latency_wait_p99": _weighted_percentile(waits, w, 99),
        "latency_e2e_p50": _weighted_percentile(e2e, w, 50),
        "latency_e2e_p99": _weighted_percentile(e2e, w, 99),
        "sim_wall_s": wall,
        "n_replicas": cfg.n_replicas,
    }
    if series_rows:
        # (steps, R) per channel — time-major, replica axis preserved
        report["series"] = {
            k: np.concatenate([rows[k] for rows in series_rows])
            for k in series_rows[0]
        }
    return report
