"""An open loop with bursts: requests arrive whatever the server does, the
gaps between them Gamma-distributed with ``shape`` k and mean 1 / ``rate``
(coefficient of variation 1 / sqrt(k): k = 0.25 gives BurstGPT's CV of 2,
arXiv:2401.17644).  The first request is due at the window's start.  The
gaps are drawn from the mix's ``schedule_seed``, not the run's seed, so
every run offers the same schedule, as every run sends the same sizes; the
run's seed draws the token ids only."""
from __future__ import annotations

import numpy as np


class Arrivals:
    def __init__(self, params: dict, seed: int):
        self.rate, self.shape = float(params["rate"]), float(params["shape"])
        self.rng = np.random.default_rng(params["schedule_seed"])
        self.t0: float | None = None
        self.next = 0.0  # the next request's due time after the window's start

    def due(self, now: float, completed: int) -> list[float]:
        """The due times of the requests that arrived by host time ``now``
        and were not given yet (the first call is the window's start)."""
        if self.t0 is None:
            self.t0 = now
        out = []
        while self.t0 + self.next <= now:
            out.append(self.t0 + self.next)
            self.next += self.rng.gamma(self.shape, 1.0 / (self.shape * self.rate))
        return out
