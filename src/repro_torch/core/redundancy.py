"""Redundancy schemes: RR, CR, DR baselines and HyCA (paper Sections II–IV).

Every scheme answers two questions for a given fault map:
  * ``fully_functional`` — can ALL faulty PEs be repaired (zero perf penalty)?
  * ``remaining_columns`` — after repairing what can be repaired and discarding
    columns with unrepaired faults (plus columns disconnected from the
    input/weight/output buffers, i.e. everything right of the first discarded
    column — Section IV-B end), how many array columns survive?

Spare PEs are fabricated in the same process and are fault-prone with the same
PER; faulty spares cannot repair anything (this is why even HyCA's fully
functional probability dips slightly before its capacity cliff — Fig. 10).

Repair priority (paper Section IV-B): faults are repaired leftmost-first so the
surviving prefix of columns stays connected to the on-chip buffers.

Host numpy, as in the JAX package: these per-config functions are the
reference that the batched torch evaluator of
:mod:`repro_torch.core.campaign` is held to config by config.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "DPPUConfig",
    "dppu_capacity",
    "effective_capacity",
    "n_spares",
    "rr_repair",
    "cr_repair",
    "dr_repair",
    "hyca_repair",
    "hyca_remap_repair",
    "repair",
    "SCHEMES",
]


def n_spares(scheme: str, rows: int, cols: int) -> int:
    """Spare-PE count a scheme fabricates for a rows×cols array: one per row
    (RR), one per column (CR), one per diagonal of each square sub-array
    (DR), none for HyCA (its redundancy is the DPPU)."""
    if scheme == "RR":
        return rows
    if scheme == "CR":
        return cols
    if scheme == "DR":
        n = min(rows, cols)
        return n * (-(-max(rows, cols) // n))
    if scheme == "HyCA":
        return 0
    raise ValueError(f"unknown scheme {scheme!r}")


# --------------------------------------------------------------------------- #
# DPPU internal redundancy (Section IV-C1, Fig. 6)
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class DPPUConfig:
    """Grouped DPPU: ``size`` multipliers split into dot-product groups of
    ``group_size``; inside each group every ``mult_red_group`` multipliers share
    one ring-connected redundant multiplier and every ``adder_red_group`` adders
    share one redundant adder (paper defaults: 4 and 3)."""

    size: int = 32
    group_size: int = 8
    mult_red_group: int = 4
    adder_red_group: int = 3
    unified: bool = False  # unified DPPU (Fig. 15 baseline) vs grouped

    @property
    def n_groups(self) -> int:
        return max(1, self.size // self.group_size)

    def units_per_group(self) -> tuple[int, int]:
        """(#multipliers incl. spares, #adders incl. spares) in one group."""
        mults = self.group_size
        mult_spares = -(-mults // self.mult_red_group)
        adders = self.group_size - 1  # adder tree of a ``group_size`` dot product
        adder_spares = -(-max(adders, 1) // self.adder_red_group)
        return mults + mult_spares, adders + adder_spares


def dppu_capacity(
    rng: np.random.Generator, cfg: DPPUConfig, per: float, n: int
) -> np.ndarray:
    """Effective DPPU lane capacity for ``n`` Monte-Carlo samples.

    A redundancy subgroup (``mult_red_group`` units + 1 spare, ring topology)
    survives iff at most one of its members is faulty.  A dot-product group is
    healthy iff all of its multiplier and adder subgroups survive; an unhealthy
    group contributes zero lanes.
    """
    mult_sub = -(-cfg.group_size // cfg.mult_red_group)
    add_units = max(cfg.group_size - 1, 1)
    add_sub = -(-add_units // cfg.adder_red_group)
    # multiplier subgroups: mult_red_group + 1 members each
    m_faults = rng.random((n, cfg.n_groups, mult_sub, cfg.mult_red_group + 1)) < per
    a_faults = rng.random((n, cfg.n_groups, add_sub, cfg.adder_red_group + 1)) < per
    m_ok = (m_faults.sum(-1) <= 1).all(-1)
    a_ok = (a_faults.sum(-1) <= 1).all(-1)
    healthy = m_ok & a_ok
    return (healthy.sum(-1) * cfg.group_size).astype(np.int64)


# --------------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------------- #
def _prefix_from_unrepaired(unrepaired_cols: np.ndarray, cols: int) -> int:
    """Surviving columns = longest prefix before the first unrepaired fault."""
    if unrepaired_cols.size == 0:
        return cols
    return int(unrepaired_cols.min())


# --------------------------------------------------------------------------- #
# RR — row redundancy: one spare PE per row, shared by that row only
# --------------------------------------------------------------------------- #
def rr_repair(fault_map: np.ndarray, spare_faulty: np.ndarray) -> tuple[bool, int]:
    """``spare_faulty``: (rows,) bool — the per-row spare's own health."""
    rows, cols = fault_map.shape
    per_row = fault_map.sum(axis=1)
    ff = bool(((per_row == 0) | ((per_row == 1) & ~spare_faulty)).all())
    if ff:
        return True, cols
    # The row-shift replacement mechanism cannot partially repair a row with
    # more than one fault ("RR cannot effectively shift the faulty PEs to a
    # different column", Section V-C): only single-fault rows are repaired
    # (iff the row spare works); every fault in a multi-fault row and every
    # fault next to a dead spare stays unrepaired.
    repaired_rows = (per_row == 1) & ~spare_faulty
    unrepaired = fault_map & ~repaired_rows[:, None]
    return False, _prefix_from_unrepaired(np.nonzero(unrepaired)[1], cols)


# --------------------------------------------------------------------------- #
# CR — column redundancy: one spare PE per column
# --------------------------------------------------------------------------- #
def cr_repair(fault_map: np.ndarray, spare_faulty: np.ndarray) -> tuple[bool, int]:
    rows, cols = fault_map.shape
    per_col = fault_map.sum(axis=0)
    repairable = (per_col == 0) | ((per_col == 1) & ~spare_faulty)
    ff = bool(repairable.all())
    if ff:
        return True, cols
    bad_cols = np.nonzero(~repairable)[0]
    return False, _prefix_from_unrepaired(bad_cols, cols)


# --------------------------------------------------------------------------- #
# DR — diagonal redundancy: spare d repairs a fault in row d OR column d
# (Takanami [20]); feasibility is a bipartite matching between faults and
# spares.  Non-square arrays are split into square sub-arrays (paper Sec. V-E).
# --------------------------------------------------------------------------- #
def _dr_match_square(fault_rc: list[tuple[int, int]], n_spares: int, spare_ok: np.ndarray) -> tuple[bool, list[tuple[int, int]]]:
    """Greedy augmenting-path matching, faults processed in column order so the
    matched set maximises the surviving column prefix (transversal matroid
    greedy).  Returns (all_matched, unmatched_faults)."""
    order = sorted(range(len(fault_rc)), key=lambda i: fault_rc[i][1])
    spare_of: dict[int, int] = {}  # spare index -> fault index
    match_of: dict[int, int] = {}  # fault index -> spare index

    def neighbours(i: int) -> list[int]:
        r, c = fault_rc[i]
        out = []
        for s in (r, c):
            if s < n_spares and spare_ok[s]:
                out.append(s)
        return out

    def augment(i: int, seen: set[int]) -> bool:
        for s in neighbours(i):
            if s in seen:
                continue
            seen.add(s)
            if s not in spare_of or augment(spare_of[s], seen):
                spare_of[s] = i
                match_of[i] = s
                return True
        return False

    unmatched = []
    for i in order:
        if not augment(i, set()):
            unmatched.append(fault_rc[i])
    return not unmatched, unmatched


def dr_repair(fault_map: np.ndarray, spare_faulty: np.ndarray) -> tuple[bool, int]:
    rows, cols = fault_map.shape
    n = min(rows, cols)
    ff = True
    unrepaired_cols: list[int] = []
    # split a non-square array into square sub-arrays along the long axis
    n_sub = -(-max(rows, cols) // n)
    for s in range(n_sub):
        if rows >= cols:
            sub = fault_map[s * n : (s + 1) * n, :]
            off_r, off_c = s * n, 0
        else:
            sub = fault_map[:, s * n : (s + 1) * n]
            off_r, off_c = 0, s * n
        rc = [(int(r), int(c)) for r, c in zip(*np.nonzero(sub))]
        ok = spare_faulty[s * n : s * n + min(n, len(spare_faulty) - s * n)]
        ok = ~np.asarray(ok, dtype=bool)
        matched, unmatched = _dr_match_square(rc, len(ok), ok)
        ff &= matched
        unrepaired_cols.extend(off_c + c for _, c in unmatched)
    if ff:
        return True, cols
    return False, _prefix_from_unrepaired(np.asarray(unrepaired_cols), cols)


# --------------------------------------------------------------------------- #
# HyCA — DPPU recomputes ANY faulty PE; capacity = healthy DPPU lanes
# --------------------------------------------------------------------------- #
def hyca_repair(fault_map: np.ndarray, capacity: int) -> tuple[bool, int]:
    rows, cols = fault_map.shape
    n_faults = int(fault_map.sum())
    if n_faults <= capacity:
        return True, cols
    # leftmost-first repair priority (Section IV-B): repair the ``capacity``
    # faults with the smallest column index; the first unrepaired fault's
    # column bounds the surviving prefix.
    fault_cols = np.sort(np.nonzero(fault_map)[1])
    return False, int(fault_cols[capacity])


def hyca_remap_repair(fault_map: np.ndarray, capacity: int) -> tuple[bool, int]:
    """HyCA outcome under model-side remap/prune remediation (repro_torch.repair).

    Fully-functional is unchanged (remap does not add repair capacity), but
    the degradation story is: instead of discarding the column prefix from the
    first unrepaired fault rightward, the remap planner re-routes the least-
    salient output residue classes onto the unrepairable PE columns and prunes
    them — every OTHER column keeps producing trusted output.  Remaining
    computing power is therefore ``cols - #distinct unrepaired-fault columns``
    instead of the surviving prefix: the capacity cliff flattens into a
    per-column haircut.  NumPy reference for the vmapped campaign evaluator.
    """
    rows, cols = fault_map.shape
    n_faults = int(fault_map.sum())
    if n_faults <= capacity:
        return True, cols
    # leftmost-first: the DPPU repairs the ``capacity`` leftmost faults; any
    # column whose trailing fault overflows capacity hosts a pruned class
    fault_cols = np.sort(np.nonzero(fault_map)[1])
    unrepaired_cols = np.unique(fault_cols[capacity:])
    return False, cols - int(unrepaired_cols.size)


def effective_capacity(cfg: DPPUConfig, col: int) -> int:
    """Faults repairable per D=Col-cycle window (Section V-E, Fig. 15).

    Each faulty PE contributes a ``col``-long dot product per window.

    * Unified DPPU: all ``size`` multipliers form one dot-product unit but the
      register files supply at most ``col`` operands per fault, so a fault
      takes ``ceil(col / min(size, col))`` cycles and lanes beyond ``col`` (or
      a non-divisor remainder) idle: size 24/40/48 do not scale at col=32.
    * Grouped DPPU: each ``group_size`` group finishes a fault in
      ``col / group_size`` cycles independently → capacity == size, strictly
      scaling.
    """
    if cfg.unified:
        use = min(cfg.size, col)
        return col // (-(-col // use))
    per_group_cycles = max(1, -(-col // cfg.group_size))
    return cfg.n_groups * max(1, col // per_group_cycles)


# --------------------------------------------------------------------------- #
# unified dispatch
# --------------------------------------------------------------------------- #
SCHEMES = ("RR", "CR", "DR", "HyCA")


def repair(
    scheme: str,
    fault_map: np.ndarray,
    *,
    spare_faulty: np.ndarray | None = None,
    capacity: int | None = None,
) -> tuple[bool, int]:
    """Returns (fully_functional, surviving_columns)."""
    rows, cols = fault_map.shape
    if scheme == "RR":
        sf = np.zeros(rows, bool) if spare_faulty is None else spare_faulty
        return rr_repair(fault_map, sf)
    if scheme == "CR":
        sf = np.zeros(cols, bool) if spare_faulty is None else spare_faulty
        return cr_repair(fault_map, sf)
    if scheme == "DR":
        n = min(rows, cols) * (-(-max(rows, cols) // min(rows, cols)))
        sf = np.zeros(n, bool) if spare_faulty is None else spare_faulty
        return dr_repair(fault_map, sf)
    if scheme == "HyCA":
        cap = cols if capacity is None else capacity
        return hyca_repair(fault_map, cap)
    raise ValueError(f"unknown scheme {scheme!r}")
