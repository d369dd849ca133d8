"""Monte-Carlo reliability evaluation (paper Figs. 3, 10, 11, 14, 15).

Metrics (Section V-C):
  * fully functional probability (FFP) — P(the scheme repairs every fault),
    the metric for mission-critical deployments;
  * normalized remaining computing power — E[surviving columns] / columns,
    the metric for degradable deployments (column-granular discard).

This module is the per-config NumPy *reference*; large campaigns should use
:mod:`repro_torch.core.campaign`, which evaluates the same schemes as batched
torch ops over the whole config batch on the device (bit-identical at the
same seed, asserted in the tests).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import fault_models as fm
from repro_torch.core import redundancy as red


def point_seed(seed: int, per_index: int) -> int:
    """Stable per-PER-point seed derivation (NOT the salted builtin ``hash``).  Scheme-independent on purpose: every scheme at
    one operating point is evaluated on the same fault maps.  Lives here (the
    NumPy reference layer) so both the legacy sweep and the batched campaign
    share one derivation."""
    return seed + 7919 * (per_index + 1)


@dataclasses.dataclass(frozen=True)
class ReliabilityResult:
    scheme: str
    per: float
    fault_model: str
    fully_functional_prob: float
    remaining_power: float
    n_configs: int


def evaluate_scheme(
    scheme: str,
    per: float,
    *,
    rows: int = 32,
    cols: int = 32,
    fault_model: str = "random",
    n_configs: int = 2000,
    dppu: red.DPPUConfig | None = None,
    seed: int = 0,
) -> ReliabilityResult:
    rng = np.random.default_rng(seed)
    maps = fm.sample_fault_maps(rng, n_configs, rows, cols, per, fault_model)  # type: ignore[arg-type]
    ff = np.zeros(n_configs, dtype=bool)
    surv = np.zeros(n_configs, dtype=np.float64)

    if scheme == "HyCA":
        cfg = dppu or red.DPPUConfig(size=cols)
        lane_caps = red.dppu_capacity(rng, cfg, per, n_configs)
        eff = red.effective_capacity(cfg, cols)
        caps = np.minimum(lane_caps, eff)
        for i in range(n_configs):
            ff[i], sc = red.hyca_repair(maps[i], int(caps[i]))
            surv[i] = sc
    else:
        n_sp = red.n_spares(scheme, rows, cols)
        spare_faults = rng.random((n_configs, n_sp)) < per
        for i in range(n_configs):
            ff[i], sc = red.repair(scheme, maps[i], spare_faulty=spare_faults[i])
            surv[i] = sc

    return ReliabilityResult(
        scheme=scheme,
        per=per,
        fault_model=fault_model,
        fully_functional_prob=float(ff.mean()),
        remaining_power=float(surv.mean() / cols),
        n_configs=n_configs,
    )


def sweep(
    schemes: Sequence[str],
    pers: Sequence[float],
    *,
    rows: int = 32,
    cols: int = 32,
    fault_model: str = "random",
    n_configs: int = 2000,
    dppu: red.DPPUConfig | None = None,
    seed: int = 0,
) -> list[ReliabilityResult]:
    out = []
    for s in schemes:
        for i, p in enumerate(pers):
            out.append(
                evaluate_scheme(
                    s,
                    p,
                    rows=rows,
                    cols=cols,
                    fault_model=fault_model,
                    n_configs=n_configs,
                    dppu=dppu,
                    # Stable and scheme-independent: every scheme at one PER
                    # point draws the SAME fault maps (evaluate_scheme samples
                    # maps before any scheme-specific draws).  The old
                    # derivation used the salted builtin ``hash((s, per))``,
                    # so cross-scheme map sharing — and run-to-run
                    # reproducibility — depended on PYTHONHASHSEED.
                    seed=point_seed(seed, i),
                )
            )
    return out


# default PER grid used by the paper's figures (BER 1e-7..1e-3 → PER 0..6%)
PER_GRID = tuple(float(x) for x in fm.per_from_ber(np.geomspace(1e-7, 1e-3, 9)))
