"""Timing model of the output-stationary 2-D array (paper Section IV-B).

This slice carries the layer shape and its cycle count, which the
detection-coverage model (:mod:`repro_torch.core.detection`) compares the
scan time against; the iteration-level simulator comes with a later slice.
"""
from __future__ import annotations

import dataclasses


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


def layer_cycles(layer: ConvLayer, rows: int, cols: int) -> int:
    """Total cycles for a layer on a rows×cols output-stationary array.

    Scale-sim OS cycle count (Samajdar et al.): each fold computes a
    rows×cols output tile in ``2·R + C + T_iteration - 2`` cycles.  FC layers
    (out_pixels == 1) occupy a single column of PEs (paper Section V-D), so
    their runtime is nearly independent of the column count."""
    if layer.out_pixels == 1:  # fully-connected: single column, Row PEs
        iters = -(-layer.c_out // rows)
    else:
        iters = (-(-layer.out_pixels // rows)) * (-(-layer.c_out // cols))
    return iters * (layer.t_iteration + 2 * rows + cols - 2)
