"""The comparison that decides ``correct``.  Each kind's driver
(``drivers/<kind>.py::compare``) reads the numbers off what the timed path
produced, against the plain reference (``reference/<family>.py``) on the
weights and inputs the benchmark drew, after the program's state is freed;
:func:`judge` holds them to the cell's limits (``limits/<cell>.json``).
The control goes through the same :func:`judge`."""
from __future__ import annotations

import numpy as np

from hyca_bench.harness import spec
from hyca_bench.harness.inputs import float_weights, sub_seed


def judge(numbers: dict, limits: dict) -> tuple[dict, bool]:
    """(checks, correct): each number the limits name beside its limit,
    and whether every one is there and within it."""
    checks = {name: {"value": numbers.get(name), "limit": limit} for name, limit in limits.items()}
    return checks, all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())


def reference(cfg: dict):
    """The family's plain reference, with its matmuls exact (TF32 off)."""
    ref = spec.module("reference", cfg["family"])
    ref.exact_matmuls()
    return ref


def weights(cfg: dict, seed: int, device):
    """``weights(part)`` of the configuration, drawn again from the seed in
    float32: the benchmark's weights, never the program's copies."""
    return float_weights(spec.module("bridges", cfg["family"]), cfg["model"], seed, device)


def sample(n_items: int, seed: int, n: int) -> list[int]:
    """n indices of ``n_items`` drawn from the seed, in order (all of them
    where there are no more)."""
    if n_items <= n:
        return list(range(n_items))
    rng = np.random.default_rng(sub_seed(seed, "check"))
    return sorted(int(j) for j in rng.choice(n_items, size=n, replace=False))
