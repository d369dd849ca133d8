"""Trace-driven production load for the fleet engines.

A :class:`TrafficSpec` describes a workload — base request rate with a
diurnal modulation, Poisson burst events, heavy-tailed prompt/decode
lengths quantized into ``n_classes`` request classes (optionally tagged
with model families from the config registry), and per-request SLA
deadlines.  :func:`sample_trace` turns it into a concrete
:class:`Trace`: per-step per-class arrival counts, sampled once on the
host from ``spec.seed`` so the legacy ``run_fleet`` loop and the
vectorized ``run_vfleet`` engine consume the *identical* request
schedule (the parity tests rely on this).

Class quantization is deterministic: class k sits at the (k+0.5)/K
lognormal quantile of the length distribution (``tail`` is the lognormal
sigma; 0 = every class identical), so equal class weights give the right
marginal distribution without per-request sampling.  Lengths are clamped
so every class fits the KV budget (``prompt+gen <= smax`` — the
scheduler's admission check can then never reject a trace request).

SLA semantics: a class with ``sla_steps`` set carries an absolute
deadline ``arrival + sla`` on each request.  The queue admits a request
only while the deadline is still meetable — the slack is
``W = sla - (prompt+gen-2)`` steps of queue wait; ``sla`` is clamped up
so a freshly arrived request is always admittable (W >= 0).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serving.queue import Request

# fixed reference sample for deterministic lognormal quantiles (NOT spec.seed:
# the class structure is part of the workload shape, the seed only drives
# arrival sampling)
_Z = np.sort(np.random.default_rng(0xA11CE).standard_normal(4096))


def _normal_quantile(q: float) -> float:
    return float(np.quantile(_Z, q))


@dataclasses.dataclass(frozen=True)
class RequestClass:
    """One quantized request population: uniform lengths within a class."""

    prompt_len: int
    max_new_tokens: int
    sla_steps: int | None = None   # deadline offset from arrival; None = no SLA
    arch: str = ""                 # model-family tag (workload metadata)
    weight: float = 1.0

    @property
    def service_steps(self) -> int:
        """Slot occupancy from admission to completion (see scheduler.py)."""
        return self.prompt_len + self.max_new_tokens - 1

    @property
    def wait_budget(self) -> int | None:
        """Max queue wait (steps) before the deadline becomes unmeetable."""
        if self.sla_steps is None:
            return None
        return self.sla_steps - (self.service_steps - 1)


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    request_rate: float = 0.5      # mean new requests / replica / step
    diurnal_amplitude: float = 0.0  # 0..1 sinusoidal rate modulation
    diurnal_period: int = 256      # steps per diurnal cycle
    burst_rate: float = 0.0        # Poisson burst events / step
    burst_size: float = 4.0        # mean extra requests per burst (geometric)
    prompt_len: int = 4            # median prompt length
    max_new_tokens: int = 8        # median generation budget
    tail: float = 0.0              # lognormal sigma of the length tail
    n_classes: int = 1
    arch_mix: tuple[str, ...] = () # model families tagged round-robin on classes
    sla_steps: int | None = None   # deadline offset; None = no SLA
    seed: int = 0


def request_classes(spec: TrafficSpec, smax: int) -> tuple[RequestClass, ...]:
    """Quantize the spec's length distribution into concrete classes."""
    if spec.n_classes < 1:
        raise ValueError("n_classes must be >= 1")
    out = []
    for k in range(spec.n_classes):
        if spec.tail > 0 and spec.n_classes > 1:
            scale = float(np.exp(spec.tail * _normal_quantile((k + 0.5) / spec.n_classes)))
        else:
            scale = 1.0
        p = max(1, int(round(spec.prompt_len * scale)))
        g = max(1, int(round(spec.max_new_tokens * scale)))
        # fit the KV budget (admission checks prompt+gen <= smax)
        p = min(p, smax - 1)
        g = min(g, smax - p)
        sla = None
        if spec.sla_steps is not None:
            sla = max(int(spec.sla_steps), p + g - 2)  # fresh requests admittable
        arch = spec.arch_mix[k % len(spec.arch_mix)] if spec.arch_mix else ""
        out.append(RequestClass(
            prompt_len=p, max_new_tokens=g, sla_steps=sla, arch=arch,
            weight=1.0 / spec.n_classes,
        ))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Trace:
    """A concrete request schedule: ``counts[t, k]`` arrivals of class k at
    step t.  Both fleet engines submit class counts in ascending class
    order within a step, so least-loaded routing sees the same request
    sequence — the cross-engine parity invariant."""

    spec: TrafficSpec
    classes: tuple[RequestClass, ...]
    counts: np.ndarray             # (steps, n_classes) int32

    @property
    def steps(self) -> int:
        return int(self.counts.shape[0])

    @property
    def total_requests(self) -> int:
        return int(self.counts.sum())


def sample_trace(spec: TrafficSpec, steps: int, n_replicas: int, smax: int) -> Trace:
    """Sample the per-step per-class arrival counts (host RNG, spec.seed)."""
    classes = request_classes(spec, smax)
    k = len(classes)
    rng = np.random.default_rng(spec.seed)
    t = np.arange(steps)
    rate = spec.request_rate * n_replicas * (
        1.0 + spec.diurnal_amplitude * np.sin(2 * np.pi * t / max(spec.diurnal_period, 1))
    )
    rate = np.clip(rate, 0.0, None)
    counts = rng.poisson(rate[:, None] / k, size=(steps, k)).astype(np.int32)
    if spec.burst_rate > 0:
        n_bursts = rng.poisson(spec.burst_rate, size=steps)
        for step in np.nonzero(n_bursts)[0]:
            for _ in range(int(n_bursts[step])):
                cls = int(rng.integers(0, k))
                size = int(rng.geometric(1.0 / max(spec.burst_size, 1.0)))
                counts[step, cls] += size
    return Trace(spec=spec, classes=classes, counts=counts)


def requests_at(trace: Trace, step: int, rng: np.random.Generator,
                vocab: int, next_rid: int) -> tuple[list[Request], int]:
    """Materialize the step's arrivals as queue Requests (legacy engine).

    Classes are emitted in ascending class order — the same order the
    vectorized engine routes them — with prompt contents drawn from the
    caller's dedicated trace RNG (token values never affect goodput
    accounting, but the server needs real prompts to feed)."""
    out: list[Request] = []
    for k, cls in enumerate(trace.classes):
        for _ in range(int(trace.counts[step, k])):
            prompt = rng.integers(0, vocab, size=cls.prompt_len).astype(np.int32)
            out.append(Request(
                rid=next_rid, prompt=prompt,
                max_new_tokens=cls.max_new_tokens,
                arrival_step=step,
                deadline_step=None if cls.sla_steps is None else step + cls.sla_steps,
            ))
            next_rid += 1
    return out, next_rid
