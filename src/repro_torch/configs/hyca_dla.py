"""The paper's own accelerator configuration (Section V-A1).

32×32 output-stationary PE array, DPPU size 32 grouped 8-wide, D = Col = 32
cycle delay, Ping-Pong IRF/WRF of 2·D·Row entries, FPT of DPPU_size entries,
8-bit input/weight datapath with a 32-bit accumulator; every 4 multipliers /
3 adders in the DPPU share one ring-connected spare.

Like the reference's, this module is not in the model registry: it
configures the array, not a model.
"""
from __future__ import annotations

from repro_torch.core.array_sim import ArrayConfig
from repro_torch.core.engine import HyCAConfig
from repro_torch.core.redundancy import DPPUConfig

ARCH_ID = "hyca-dla"


def dla_config(rows: int = 32, cols: int = 32, dppu_size: int = 32) -> HyCAConfig:
    return HyCAConfig(
        rows=rows,
        cols=cols,
        dppu=DPPUConfig(size=dppu_size, group_size=8, mult_red_group=4, adder_red_group=3),
        mode="protected",
    )


def array_config(rows: int = 32, cols: int = 32, dppu_size: int = 32) -> ArrayConfig:
    return ArrayConfig(rows=rows, cols=cols, dppu_size=dppu_size)


# Paper Table/Fig parameters for the benchmark harness
BUFFERS = {
    "input_kb": 128,
    "output_kb": 128,
    "weight_kb": 512,
    "wrf_bytes": 2048,   # 2 × 32 × D
    "irf_bytes": 2048,
    "orf_bytes": 64,
    "fpt_bits": 32 * 10,  # DPPU_size entries × (5b row + 5b col)
}
