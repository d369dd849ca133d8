"""Fault-aware pruning: the remap plan's no-permutation degenerate case.

With no salience information, the cheapest remediation for an over-capacity
fault state is to zero every output element mapped onto an unrepaired faulty
PE: the channels that would carry stuck-at garbage carry zeros instead.
This is the identity-permutation ``RepairPlan`` with the broken columns'
resident classes pruned; this module names it and what it costs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import FaultState, HyCAConfig, RepairPlan
from repro_torch.repair.plan import unrepaired_fault_columns

__all__ = ["prune_plan", "pruned_fraction", "pruned_pe_fraction"]


def prune_plan(state: FaultState, cfg: HyCAConfig) -> RepairPlan:
    """Identity mapping with pruning on: zero the outputs of the confirmed
    unrepairable PEs in place, on the state's device (whatever channels sit
    on them are the ones sacrificed)."""
    pruned = np.zeros((cfg.rows, cfg.cols), bool)
    for r, c in state.fpt.detach().cpu().numpy()[cfg.capacity:]:
        if r >= 0:
            pruned[r, c] = True
    return RepairPlan(torch.arange(cfg.cols, dtype=torch.int32, device=state.device),
                      torch.from_numpy(pruned).to(state.device))


def pruned_fraction(state: FaultState, cfg: HyCAConfig) -> float:
    """Fraction of PE columns hosting a pruned residue class (0.0 while the
    faults fit the DPPU)."""
    return unrepaired_fault_columns(state, cfg).size / cfg.cols


def pruned_pe_fraction(state: FaultState, cfg: HyCAConfig) -> float:
    """Fraction of individual PEs whose outputs are zeroed."""
    fpt = state.fpt.detach().cpu().numpy()
    n = int((fpt[:, 0] >= 0).sum())
    return max(0, n - cfg.capacity) / (cfg.rows * cfg.cols)
