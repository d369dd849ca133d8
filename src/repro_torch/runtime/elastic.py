"""Elastic scaling — the HyCA insight lifted to the cluster level.

The paper's argument: a small *flexible* recompute pool (DPPU) that can cover
a fault anywhere beats region-locked spares (RR/CR/DR) of the same size.  At
cluster scale the same dichotomy exists:

  * region-locked:  per-rack hot spares can only replace failures in their
    own rack — utilization collapses under clustered failures (switch or PSU
    takes out a rack);
  * HyCA-style:     a small global spare pool + data-parallel re-mesh: ANY
    failed host's shard is recomputed by the pool or folded into the
    surviving data axis.

``plan_remesh`` implements the recovery policy: keep the model axis intact
(TP/EP shards are stateful and expensive to rebuild), shrink the data axis to
the largest size the surviving hosts support, re-spread the batch, and hand
back a shard-remapping usable with a checkpoint restore.
``spare_pool_ffp`` mirrors core.reliability at host granularity so
bench/cluster_ffp.py can show the same FFP-vs-fault-rate separation as
the paper's Fig. 10 — same math, five orders of magnitude up.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    old_shape: tuple[int, ...]
    new_shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    global_batch: int
    microbatch_per_group: int
    dropped_groups: tuple[int, ...]

    @property
    def degraded(self) -> bool:
        return self.new_shape != self.old_shape


def plan_remesh(
    mesh_shape: tuple[int, ...],
    axis_names: tuple[str, ...],
    failed_device_ids: list[int],
    global_batch: int,
) -> ElasticPlan:
    """Shrink the data axis past failures, keeping the model axis whole.

    Devices are numbered row-major over ``mesh_shape``.  A failure anywhere in
    a data-parallel group (one slice along the data axis, i.e. a full model
    shard replica) poisons that group: its TP collective ring is broken.  The
    plan drops poisoned groups and, if the pod axis exists and an entire pod
    is poisoned, drops that pod.
    """
    shape = tuple(mesh_shape)
    names = tuple(axis_names)
    data_ax = names.index("data")
    dev = np.arange(int(np.prod(shape))).reshape(shape)
    failed = np.isin(dev, np.asarray(failed_device_ids, dtype=int))
    # collapse all axes except the (pod,data) group axes
    group_axes = tuple(i for i, n in enumerate(names) if n in ("pod", "data"))
    other = tuple(i for i in range(len(shape)) if i not in group_axes)
    poisoned = failed.any(axis=other) if other else failed
    flat_groups = poisoned.reshape(-1)
    surviving = int((~flat_groups).sum())
    if surviving == 0:
        raise RuntimeError("no surviving data-parallel groups")
    new_shape = list(shape)
    # fold pod axis in: total surviving groups along the flattened (pod,data)
    if "pod" in names:
        pod_ax = names.index("pod")
        new_shape[pod_ax] = 1
        new_shape[data_ax] = surviving
    else:
        new_shape[data_ax] = surviving
    micro = global_batch // surviving
    dropped = tuple(int(i) for i in np.nonzero(flat_groups)[0])
    return ElasticPlan(
        old_shape=shape,
        new_shape=tuple(new_shape),
        axis_names=names,
        global_batch=global_batch,
        microbatch_per_group=micro,
        dropped_groups=dropped,
    )


def initial_spares(n_spares: int, policy: str, n_regions: int = 1) -> np.ndarray:
    """The canonical spare split as a per-region vector.

    ``pool`` keeps every spare in one global bucket (``[n_spares]``);
    ``region`` pins ``n_spares // n_regions`` per region (integer division —
    the remainder is deliberately *lost*, mirroring real region-locked
    provisioning waste).  Single source of the split rule: both the
    event-driven :class:`SparePool` and the vectorized fleet engine's
    integer-lax spare accounting (``repro_torch.serving.vfleet``) start from this
    vector, so their allocation outcomes agree by construction."""
    if policy == "pool":
        return np.array([n_spares], dtype=np.int32)
    if policy == "region":
        return np.full(n_regions, n_spares // n_regions, dtype=np.int32)
    raise ValueError(policy)


@dataclasses.dataclass
class SparePool:
    """Event-driven spare allocation — the same dichotomy as
    :func:`spare_pool_ffp`, but consumed incrementally by a running fleet.

    ``policy="pool"``: any spare replaces any retired replica (the DPPU
    analogue).  ``policy="region"``: spares are pinned per region
    (``n_spares // n_regions`` each) and can only replace failures in their
    own region (RR/CR analogue) — utilization collapses under clustered
    failures.
    """

    n_spares: int
    policy: str = "pool"
    n_regions: int = 1

    def __post_init__(self):
        if self.policy not in ("pool", "region"):
            raise ValueError(self.policy)
        if self.policy == "region":
            self._per_region = list(initial_spares(self.n_spares, self.policy,
                                                   self.n_regions))
        self._taken = 0

    @property
    def remaining(self) -> int:
        if self.policy == "region":
            return sum(self._per_region)
        return self.n_spares - self._taken

    def try_allocate(self, region: int = 0) -> bool:
        """Consume one spare for a retired replica in ``region``."""
        if self.policy == "pool":
            if self._taken < self.n_spares:
                self._taken += 1
                return True
            return False
        r = region % self.n_regions
        if self._per_region[r] > 0:
            self._per_region[r] -= 1
            return True
        return False


def spare_pool_ffp(
    rng: np.random.Generator,
    n_hosts: int,
    host_fail_prob: float,
    *,
    n_spares: int,
    policy: str,
    n_racks: int = 16,
    n_trials: int = 2000,
) -> float:
    """Fully-functional probability of a cluster under two spare policies.

    ``policy="region"``: spares are pinned per rack (n_spares/n_racks each) —
    the cluster survives iff every rack's failures ≤ its own spares (RR/CR
    analogue).  ``policy="pool"``: any spare covers any host (DPPU analogue).
    """
    hosts_per_rack = n_hosts // n_racks
    fails = rng.random((n_trials, n_racks, hosts_per_rack)) < host_fail_prob
    per_rack = fails.sum(axis=2)
    if policy == "pool":
        ok = per_rack.sum(axis=1) <= n_spares
    elif policy == "region":
        per_rack_spares = n_spares // n_racks
        ok = (per_rack <= per_rack_spares).all(axis=1)
    else:
        raise ValueError(policy)
    return float(ok.mean())
