"""Remap planner: choose which output channels to sacrifice to broken PEs.

The DPPU recomputes the ``capacity`` leftmost faults; every fault past that
corrupts the outputs mapped onto its PE.  The engine maps output channel
``j`` onto PE column ``j % cols`` (its residue class), and a static
permutation of that mapping moves any residue class onto any PE column at
no runtime cost.  The planner therefore:

  1. finds the PE columns holding unrepaired faults (``k`` distinct columns,
     leftmost-first repair priority: the FPT is already sorted);
  2. ranks residue classes by salience (see :mod:`repro_torch.repair.remap`)
     and picks the ``k`` least salient as victims;
  3. builds the minimal-swap permutation that routes every victim onto a
     broken column (classes already in place stay put), and prunes (zeroes)
     what lands there.

The result is a :class:`~repro_torch.core.engine.RepairPlan`.  The host
planner :func:`remap_plan` works in numpy; :func:`remap_plan_device` builds
the same plans for a batch of fault tables at once with torch ops on their
device (the counterpart of the reference's ``vmap``-ed planner).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import (
    FaultState,
    HyCAConfig,
    RepairPlan,
    identity_plan,
    validate_fault_state,
)

__all__ = [
    "identity_plan",
    "remap_plan",
    "remap_plan_device",
    "unrepaired_fault_columns",
    "plan_summary",
]


def _fpt(state: FaultState) -> np.ndarray:
    return state.fpt.detach().cpu().numpy()


def unrepaired_fault_columns(state: FaultState, cfg: HyCAConfig) -> np.ndarray:
    """Distinct PE columns holding faults the DPPU cannot repair (the FPT
    entries past ``cfg.capacity``; the FPT is leftmost-sorted)."""
    fpt = _fpt(state)
    cols = fpt[fpt[:, 0] >= 0, 1]
    return np.unique(cols[cfg.capacity:]) if cols.size > cfg.capacity else np.zeros(0, np.int64)


def remap_plan(
    state: FaultState,
    cfg: HyCAConfig,
    salience: np.ndarray,
    *,
    prune: bool = True,
    broken_cols=None,
) -> RepairPlan:
    """Host planner: the permutation routing the least-salient residue
    classes onto the unrepairable PE columns, on the state's device.

    ``salience``: (cols,) per-residue-class salience (higher = more
    important).  Ties break by class index (stable sort), so the batched
    planner below builds the same plan.  ``broken_cols`` overrides the
    broken-column set (default: every column holding over-capacity FPT
    entries); the serving FaultManager passes its REMAPPED columns only, so
    columns retired past the remap budget are discarded, not pruned.
    ``prune=False`` remaps without zeroing (ablation only: the victims then
    carry the raw stuck-at corruption)."""
    validate_fault_state(state, cfg.rows, cfg.cols)
    s = np.asarray(salience, np.float64)
    if s.shape != (cfg.cols,):
        raise ValueError(f"salience must be ({cfg.cols},), got {s.shape}")
    broken = (
        unrepaired_fault_columns(state, cfg)
        if broken_cols is None else np.unique(np.asarray(list(broken_cols), np.int64))
    )
    k = broken.size
    if k == 0:
        return identity_plan(cfg.rows, cfg.cols, device=state.device)
    victims = np.argsort(s, kind="stable")[:k]
    broken_set, victim_set = set(broken.tolist()), set(victims.tolist())
    # minimal swaps: victims already on a broken column stay; each remaining
    # victim (on a healthy column) trades places with the non-victim class on
    # a broken column, paired in ascending index order
    mis_v = sorted(v for v in victim_set if v not in broken_set)
    mis_f = sorted(f for f in broken_set if f not in victim_set)
    col_map = np.arange(cfg.cols, dtype=np.int32)
    for v, f in zip(mis_v, mis_f):
        col_map[v], col_map[f] = f, v
    # the sacrificed PEs: the planner's snapshot of the confirmed unrepairable
    # faults on the covered columns, not a live read at matmul time
    pruned = np.zeros((cfg.rows, cfg.cols), bool)
    if prune:
        for r, c in _fpt(state)[cfg.capacity:]:
            if r >= 0 and c in broken_set:
                pruned[r, c] = True
    return RepairPlan(torch.from_numpy(col_map).to(state.device), torch.from_numpy(pruned).to(state.device))


def remap_plan_device(
    fpt: torch.Tensor,
    salience: torch.Tensor,
    *,
    rows: int,
    cols: int,
    capacity: int,
    prune: bool = True,
) -> RepairPlan:
    """:func:`remap_plan` for a batch of fault tables, on their device.

    ``fpt``: (..., max_faults, 2) leftmost-sorted fault tables (-1 padding);
    ``salience``: (..., cols), broadcast against the tables' batch.  Returns
    a RepairPlan with ``col_map`` (..., cols) int32 and ``prune`` (..., rows,
    cols) bool: one plan per table, all built by the same tensor ops."""
    dev = fpt.device
    lead = fpt.shape[:-2]
    fpt = fpt.reshape(-1, *fpt.shape[-2:]).long()
    b, f = fpt.shape[:2]
    sal = torch.broadcast_to(salience.to(dev), (*lead, cols)).reshape(b, cols)
    idx = torch.arange(cols, device=dev)
    valid = fpt[..., 0] >= 0
    over = valid & (torch.arange(f, device=dev) >= capacity)
    # scatters route non-entries to a discard slot one past the grid
    c = torch.where(over, fpt[..., 1], torch.full_like(fpt[..., 1], cols))
    broken = torch.zeros((b, cols + 1), dtype=torch.bool, device=dev).scatter_(1, c, True)[:, :cols]
    k = broken.sum(dim=1, keepdim=True)
    r = torch.where(over, fpt[..., 0], torch.full_like(fpt[..., 0], rows))
    flat = torch.where(over, r * cols + c, torch.full_like(r, rows * cols))
    pruned = torch.zeros((b, rows * cols + 1), dtype=torch.bool, device=dev).scatter_(1, flat, True)
    pruned = pruned[:, : rows * cols].reshape(b, rows, cols) & bool(prune)
    # stable ascending-salience rank per class (argsort of argsort)
    rank = torch.argsort(torch.argsort(sal, dim=1, stable=True), dim=1, stable=True)
    victim = rank < k
    mis_v = victim & ~broken
    mis_f = broken & ~victim
    # pair the i-th misplaced victim with the i-th wrongly occupied broken
    # column, both in ascending class order (the host planner's zip)
    big = torch.full((b, cols), cols, dtype=torch.long, device=dev)
    v_sorted = torch.sort(torch.where(mis_v, idx, big), dim=1).values
    f_sorted = torch.sort(torch.where(mis_f, idx, big), dim=1).values
    ok = (v_sorted < cols) & (f_sorted < cols)
    col_map = torch.cat([idx.expand(b, cols), big[:, :1]], dim=1)
    col_map = col_map.scatter(1, torch.where(ok, v_sorted, big), torch.where(ok, f_sorted, big))
    col_map = col_map.scatter(1, torch.where(ok, f_sorted, big), torch.where(ok, v_sorted, big))
    return RepairPlan(col_map[:, :cols].to(torch.int32).reshape(*lead, cols),
                      pruned.reshape(*lead, rows, cols))


def plan_summary(plan: RepairPlan, state: FaultState, cfg: HyCAConfig) -> dict:
    """Host report: what the plan sacrifices."""
    cm = plan.col_map.detach().cpu().numpy()
    pruned = plan.prune.detach().cpu().numpy()
    pruned_cols = np.nonzero(pruned.any(axis=0))[0]
    broken = unrepaired_fault_columns(state, cfg)
    return {
        "n_broken_cols": int(broken.size),
        "broken_cols": [int(c) for c in broken],
        "pruned_pes": int(pruned.sum()),
        "victim_classes": sorted(int(c) for c in np.nonzero(np.isin(cm, pruned_cols))[0]),
        "moved_classes": int((cm != np.arange(cfg.cols)).sum()),
        "quality_fraction": 1.0 - pruned_cols.size / cfg.cols,
    }
