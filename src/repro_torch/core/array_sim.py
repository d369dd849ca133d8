"""Cycle-level simulator of the output-stationary 2-D array + DPPU dataflow
(paper Section IV-B, Fig. 5).

This is the *timing* model: it reproduces the iteration schedule — 2-D-array
output-buffer writes, DPPU overwrite writes, idle phases — and asserts the
paper's structural claims:

  * the DPPU lags the array by D = Col cycles; IRF/WRF are Ping-Pong register
    files of depth 2·D·Row so no value the DPPU still needs is overwritten;
  * the output buffer port is used by the 2-D array for D cycles/iteration and
    by the DPPU for ``fault_PE_num`` cycles/iteration; no write conflicts occur
    while ``fault_PE_num + D <= T_iteration = c·k²``;
  * a DPPU of size ≥ #faults finishes each window's recompute before the
    Ping/Pong swap.

The *data* semantics (what values land in the output buffer) live in
``repro_torch.kernels`` / ``repro_torch.core.engine``; both are cross-checked
in tests.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ArrayConfig:
    rows: int = 32
    cols: int = 32
    dppu_size: int = 32
    dppu_group: int = 8

    @property
    def delay(self) -> int:  # D = Col (Section IV-B: minimises RF overhead)
        return self.cols


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    """One conv (or FC, with k=1, spatial=1·out_pixels) layer."""

    c_in: int
    k: int
    out_pixels: int  # OH*OW (spatial positions), mapped to rows
    c_out: int  # output channels, mapped to columns

    @property
    def t_iteration(self) -> int:
        return self.c_in * self.k * self.k


@dataclasses.dataclass(frozen=True)
class IterationTimeline:
    """Output-buffer port occupancy inside one iteration of length t."""

    t_iteration: int
    array_write: tuple[int, int]  # [start, end) cycles of 2-D array writes
    dppu_write: tuple[int, int]  # [start, end) cycles of DPPU overwrites
    idle: int  # idle port cycles

    @property
    def conflict_free(self) -> bool:
        return self.array_write[1] <= self.dppu_write[0] and (
            self.dppu_write[1] <= self.t_iteration
        )


def iteration_timeline(cfg: ArrayConfig, layer: ConvLayer, n_faults: int) -> IterationTimeline:
    """Port schedule of one steady-state iteration (Fig. 5 cycles kkc-1 …)."""
    t = layer.t_iteration
    d = cfg.delay
    # 2-D array drains one column of outputs per cycle for D = Col cycles.
    array_write = (0, d)
    # DPPU overwrites start after its ORF fill: Col (=delay) + pipeline, one
    # recomputed output per cycle.
    dppu_start = d + 2  # +2: ORF ping/pong swap + byte-mask setup (Fig. 5 step 4/5)
    dppu_write = (dppu_start, dppu_start + n_faults)
    idle = max(0, t - d - 2 - n_faults)
    return IterationTimeline(t, array_write, dppu_write, idle)


def dppu_recompute_cycles(cfg: ArrayConfig, n_faults: int) -> int:
    """Cycles for the grouped DPPU to recompute ``n_faults`` outputs of one
    D=Col-long MAC window: each group of ``dppu_group`` lanes needs
    ``Col/group`` cycles per fault; groups work on faults in parallel."""
    groups = max(1, cfg.dppu_size // cfg.dppu_group)
    per_fault = -(-cfg.cols // cfg.dppu_group)
    rounds = -(-n_faults // groups)
    return rounds * per_fault


def recompute_keeps_up(cfg: ArrayConfig, n_faults: int) -> bool:
    """DPPU must finish a window's recompute within D cycles (before the
    Ping-Pong register files swap) — true iff n_faults <= capacity."""
    return dppu_recompute_cycles(cfg, n_faults) <= cfg.delay


def layer_cycles(layer: ConvLayer, rows: int, cols: int) -> int:
    """Total cycles for a layer on a rows×cols output-stationary array.

    Scale-sim OS cycle count (Samajdar et al.): each fold computes a
    rows×cols output tile in ``2·R + C + T_iteration - 2`` cycles (input skew
    down the rows, output drain, weight wave across the columns).  FC layers
    (out_pixels == 1) occupy a single column of PEs (paper Section V-D), so
    their runtime is nearly independent of the column count — this is what
    compresses Fig. 12's speedup relative to Fig. 11's computing-power gap.
    """
    if layer.out_pixels == 1:  # fully-connected: single column, Row PEs
        iters = -(-layer.c_out // rows)
    else:
        iters = (-(-layer.out_pixels // rows)) * (-(-layer.c_out // cols))
    return iters * (layer.t_iteration + 2 * rows + cols - 2)


def register_file_bytes(cfg: ArrayConfig, data_bytes: int = 1) -> dict[str, int]:
    """IRF/WRF/ORF sizing (Section IV-A/V-A1): depth 2·D·Row each."""
    depth = 2 * cfg.delay * cfg.rows
    return {
        "WRF": depth * data_bytes,
        "IRF": depth * data_bytes,
        "ORF": 2 * cfg.dppu_size * data_bytes,  # Ping-Pong output register file
        "FPT_bits": cfg.dppu_size * (
            int(np.ceil(np.log2(max(cfg.rows, 2)))) + int(np.ceil(np.log2(max(cfg.cols, 2))))
        ),
    }
