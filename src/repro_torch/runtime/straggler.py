"""Straggler mitigation: EMA detection + proportional work reassignment.

At pod scale the slowest host gates every synchronous all-reduce.  The
mitigator tracks per-host step-time EMAs, flags hosts slower than
``threshold`` × median, and rebalances microbatches inversely to measured
speed (a host that runs 2× slower gets half the microbatches).  The expected
step time of a plan is max_h(load_h · time_per_micro_h) — the simulation in
the tests asserts the rebalance strictly reduces it.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class StragglerMitigator:
    n_hosts: int
    total_micro: int
    ema_decay: float = 0.8
    threshold: float = 1.5

    def __post_init__(self):
        self.ema = np.zeros(self.n_hosts)
        self._seen = False
        self.assignment = np.full(self.n_hosts, self.total_micro // self.n_hosts)
        self.assignment[: self.total_micro % self.n_hosts] += 1

    def observe(self, step_times: np.ndarray) -> None:
        """step_times: wall time each host spent on ITS microbatches."""
        per_micro = np.asarray(step_times) / np.maximum(self.assignment, 1)
        if not self._seen:
            self.ema = per_micro
            self._seen = True
        else:
            self.ema = self.ema_decay * self.ema + (1 - self.ema_decay) * per_micro

    def stragglers(self) -> np.ndarray:
        med = np.median(self.ema)
        return np.nonzero(self.ema > self.threshold * med)[0]

    def rebalance(self) -> np.ndarray:
        """Largest-remainder apportionment of microbatches ∝ 1/ema."""
        speed = 1.0 / np.maximum(self.ema, 1e-9)
        quota = self.total_micro * speed / speed.sum()
        base = np.floor(quota).astype(int)
        rem = self.total_micro - base.sum()
        order = np.argsort(-(quota - base))
        base[order[:rem]] += 1
        self.assignment = base
        return base

    def expected_step_time(self, assignment: np.ndarray | None = None) -> float:
        a = self.assignment if assignment is None else assignment
        return float(np.max(a * self.ema))
