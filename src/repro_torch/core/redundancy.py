"""DPPU geometry and repair capacity (paper Section IV-C1, Section V-E).

Only what the serving slice needs: the grouped/unified DPPU configuration and
the faults it can repair per window.  The RR/CR/DR redundancy schemes come
with the campaign slice.
"""
from __future__ import annotations

import dataclasses


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


def effective_capacity(cfg: DPPUConfig, col: int) -> int:
    """Faults repairable per D=Col-cycle window (Section V-E, Fig. 15).

    Each faulty PE contributes a ``col``-long dot product per window.

    * Unified DPPU: all ``size`` multipliers form one dot-product unit but the
      register files supply at most ``col`` operands per fault, so a fault
      takes ``ceil(col / min(size, col))`` cycles and lanes beyond ``col`` (or
      a non-divisor remainder) idle.
    * Grouped DPPU: each ``group_size`` group finishes a fault in
      ``col / group_size`` cycles independently, so capacity == size.
    """
    if cfg.unified:
        use = min(cfg.size, col)
        return col // (-(-col // use))
    per_group_cycles = max(1, -(-col // cfg.group_size))
    return cfg.n_groups * max(1, col // per_group_cycles)
