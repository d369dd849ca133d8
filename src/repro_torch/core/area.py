"""Component-count chip-area model (paper Fig. 9, TSMC 40 nm synthesis).

We do not run a synthesis flow; instead we count micro-architectural
components and weight them with relative area constants (normalised to one
baseline MAC PE = 1.0).  The constants are chosen to match the qualitative
structure the paper reports: MUX networks dominate RR/CR/DR overhead, while
HyCA's overhead is dominated by the DPPU PEs with the register files a small
addition.  All constants are in one place so the sensitivity is auditable.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.array_sim import ArrayConfig, register_file_bytes
from repro_torch.core.detection import clb_bytes
from repro_torch.core.redundancy import DPPUConfig

# relative area constants (1.0 == one baseline 8-bit MAC PE)
A_MULT8 = 0.45  # 8x8 multiplier
A_ADDER32 = 0.25  # 32-bit accumulator adder
A_PE_REGS = 0.25  # 64 bit-registers (flops) in a PE
A_PE_CTRL = 0.05
A_PE = A_MULT8 + A_ADDER32 + A_PE_REGS + A_PE_CTRL  # == 1.0
A_MUX_PER_BIT = 0.004  # one 2:1 mux bit
A_RF_PER_BIT = 0.0004  # register-file / small SRAM bit
A_SRAM_PER_KB = 0.9  # on-chip buffer SRAM per KB (same for every scheme)

BUFFERS_KB = 128 + 128 + 512  # input + output + weight buffers (Section V-A1)


@dataclasses.dataclass(frozen=True)
class AreaBreakdown:
    scheme: str
    base_array: float
    buffers: float
    redundant_pes: float
    mux: float
    register_files: float
    other: float

    @property
    def redundancy_overhead(self) -> float:
        return self.redundant_pes + self.mux + self.register_files + self.other

    @property
    def total(self) -> float:
        return self.base_array + self.buffers + self.redundancy_overhead


def _base(rows: int, cols: int) -> tuple[float, float]:
    return rows * cols * A_PE, BUFFERS_KB * A_SRAM_PER_KB


def area_rr(rows: int = 32, cols: int = 32) -> AreaBreakdown:
    base, buf = _base(rows, cols)
    spares = rows * A_PE
    # every PE needs 2:1 steering muxes on its 8b input, 8b weight and 16b
    # psum paths to shift operands toward the row spare
    mux = rows * cols * (8 + 8 + 16) * A_MUX_PER_BIT
    return AreaBreakdown("RR", base, buf, spares, mux, 0.0, 0.0)


def area_cr(rows: int = 32, cols: int = 32) -> AreaBreakdown:
    a = area_rr(rows, cols)
    return dataclasses.replace(a, scheme="CR", redundant_pes=cols * A_PE)


def area_dr(rows: int = 32, cols: int = 32) -> AreaBreakdown:
    base, buf = _base(rows, cols)
    n = min(rows, cols) * (-(-max(rows, cols) // min(rows, cols)))
    spares = n * A_PE
    # DR steers along BOTH the row and the column direction → 2x mux network
    mux = 2 * rows * cols * (8 + 8 + 16) * A_MUX_PER_BIT
    return AreaBreakdown("DR", base, buf, spares, mux, 0.0, 0.0)


def area_hyca(
    rows: int = 32, cols: int = 32, dppu: DPPUConfig | None = None
) -> AreaBreakdown:
    cfg = dppu or DPPUConfig(size=32)
    base, buf = _base(rows, cols)
    mult_spares = cfg.n_groups * (-(-cfg.group_size // cfg.mult_red_group))
    adders = cfg.n_groups * max(cfg.group_size - 1, 1)
    adder_spares = cfg.n_groups * (-(-max(cfg.group_size - 1, 1) // cfg.adder_red_group))
    dppu_area = (
        (cfg.size + mult_spares) * A_MULT8 + (adders + adder_spares) * A_ADDER32
    )
    rf = register_file_bytes(ArrayConfig(rows, cols, cfg.size, cfg.group_size))
    rf_bits = (rf["WRF"] + rf["IRF"] + rf["ORF"]) * 8 + rf["FPT_bits"]
    rf_bits += clb_bytes(cols) * 8  # fault-detection CLB (Section IV-D)
    rf_area = rf_bits * A_RF_PER_BIT
    # ring-topology reconfig muxes inside the DPPU (per protected unit, 8b/32b)
    other = (cfg.size * 8 + adders * 32) * A_MUX_PER_BIT
    return AreaBreakdown(
        f"HyCA{cfg.size}", base, buf, dppu_area, 0.0, rf_area, other
    )


def all_areas(rows: int = 32, cols: int = 32) -> list[AreaBreakdown]:
    return [
        area_rr(rows, cols),
        area_cr(rows, cols),
        area_dr(rows, cols),
        area_hyca(rows, cols, DPPUConfig(size=24)),
        area_hyca(rows, cols, DPPUConfig(size=32)),
        area_hyca(rows, cols, DPPUConfig(size=40)),
    ]
