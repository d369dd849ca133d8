"""Fault-campaign statistics.

This slice carries the binomial confidence interval that the
detector-coverage campaign (:mod:`repro_torch.transient.coverage`) reports;
the Monte-Carlo campaign engine itself comes with a later slice.
"""
from __future__ import annotations

import math

Z95 = 1.959963984540054  # two-sided 95% normal quantile


def binomial_halfwidth(p_hat: float, n: int, *, z: float = Z95) -> float:
    """Wald binomial CI half-width for an empirical proportion, floored at
    z/(2n) so a degenerate 0/1 estimate still reports the resolution limit
    of the sample size."""
    if n <= 0:
        return 1.0
    w = z * math.sqrt(max(p_hat * (1.0 - p_hat), 0.0) / n)
    return max(w, z / (2.0 * n))
