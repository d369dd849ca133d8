"""ScanEngine — the batched DPPU scan pipeline (paper Section IV-D).

  * One probe step checks a whole row-block of the virtual PE grid —
    ``block_rows`` grid rows × all ``cols`` columns, the paper's *p* DPPU
    groups probing *p* PEs in parallel.
  * Each PE is checked against a probe matmul AND its negated-weights
    complement: a stuck-at-1 on a high accumulator bit is a no-op on every
    small negative value, and negating the weights flips the sign, so one of
    the pair exposes it.  Both AR == BAR + PR comparisons run in one launch
    of :func:`~repro_torch.kernels.dppu_recompute.probe_check_pair` for CUDA
    tensors, and through the int32 reference
    :func:`~repro_torch.kernels.dppu_recompute.probe_check_pair_ref` for CPU
    tensors.
  * ``confirm_hits`` probe flags promote a PE from suspect to confirmed;
    detections merge into the FPT through the batched
    :meth:`~repro_torch.core.engine.FaultState.merge` (deduped,
    leftmost-sorted).

The scan cursor and sweep counter are host integers (eager PyTorch has no
trace to carry them, and reading them then costs no device sync); the per-PE
hit counters are a tensor on the engine's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.detection import detection_cycles
from repro_torch.core.engine import FaultState, _int_matmul
from repro_torch.kernels.dppu_recompute import probe_check_pair


@dataclasses.dataclass(frozen=True)
class ScanConfig:
    """Scan-pipeline geometry: ``block_rows`` grid rows are probed per step
    (``dppu_groups = block_rows * cols`` PEs in parallel); ``confirm_hits``
    probe flags promote a PE from suspect to confirmed."""

    rows: int = 32
    cols: int = 32
    window: int = 8         # S — MACs recomputed per check (partial result)
    block_rows: int = 1     # grid rows probed per step
    confirm_hits: int = 2

    def __post_init__(self):
        if self.rows <= 0 or self.cols <= 0:
            raise ValueError(f"array must be non-empty, got {self.rows}x{self.cols}")
        if not 1 <= self.block_rows <= self.rows:
            raise ValueError(
                f"block_rows must be in [1, rows={self.rows}], got {self.block_rows}"
            )
        if self.rows % self.block_rows:
            raise ValueError(
                f"block_rows must divide rows (no PE may be probed twice per "
                f"sweep), got rows={self.rows}, block_rows={self.block_rows}"
            )
        if self.confirm_hits < 1:
            raise ValueError(f"confirm_hits must be >= 1, got {self.confirm_hits}")

    @property
    def dppu_groups(self) -> int:
        """p — PEs probed in parallel per scan step."""
        return self.block_rows * self.cols

    @property
    def steps_per_sweep(self) -> int:
        return self.rows // self.block_rows

    def scan_cycles(self) -> int:
        """Full-sweep latency in the analytical model."""
        return detection_cycles(self.rows, self.cols, dppu_groups=self.dppu_groups)


@dataclasses.dataclass
class ScanState:
    """Scan cursor + per-PE hit counters.

    ``cursor``: next row-block index within the current sweep; ``sweep``:
    completed-sweep counter (keys the probe-operand schedule); ``hits``:
    (rows, cols) int32 — probe flags accumulated per PE.  Suspect/confirmed
    are derived: ``1 <= hits < confirm_hits`` / ``hits >= confirm_hits``.
    """

    cursor: int
    sweep: int
    hits: torch.Tensor


def probe_operands(rows: int, cols: int, sweep: int, window: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic small-int probe operands for one sweep: values in
    [-4, 8) bound |accumulator| <= window·32, far below 2^30, so a bit-30/31
    stuck-at is always exposed by one of the complementary ±probes.  Fresh
    per sweep (seeded by the sweep index), so marginal low-bit faults are
    re-scanned with different values.  The same numpy calls as the JAX
    package: the schedules are identical."""
    rng = np.random.default_rng((sweep + 1) * 7919)
    px = rng.integers(-4, 8, size=(rows, window)).astype(np.int32)
    pw = rng.integers(-4, 8, size=(window, cols)).astype(np.int32)
    return px, pw


def corrupt_probe(out: torch.Tensor, fault_map: torch.Tensor, stuck_bit: torch.Tensor,
                  stuck_val: torch.Tensor) -> torch.Tensor:
    """What the faulty array returns for an int32 probe matmul: out[i, j] is
    PE(i, j)'s accumulator with its stuck bit forced (the device-side mirror
    of ``FaultInjector.corrupted_probe``)."""
    out = out.to(torch.int32)
    mask = torch.ones_like(stuck_bit, dtype=torch.int32) << stuck_bit.to(torch.int32)
    bad = torch.where(stuck_val > 0, out | mask, out & ~mask)
    return torch.where(fault_map, bad, out)


# --------------------------------------------------------------------------- #
# float-tolerant output check (the OnlineVerifier adapter path)
# --------------------------------------------------------------------------- #
def output_block_check(
    x: torch.Tensor,
    w: torch.Tensor,
    out: torch.Tensor,
    *,
    row0: int,
    row1: int,
    n_cols: int,
    window: int,
    rtol: float,
) -> np.ndarray:
    """AR == BAR + PR over an *output* row-block (rows [row0, row1), columns
    [0, n_cols)): the DPPU lanes recompute the window-long partial result PR
    and the tail BAR and compare against the array's accumulator AR, on the
    tensors' device.  Integer dtypes recompute in the int32 accumulator
    (wrapping) and compare exactly; float dtypes use ``rtol``.  Returns a
    (row1-row0, n_cols) bool mismatch mask on the host."""
    kwin = min(window, x.shape[1])
    exact = not out.dtype.is_floating_point
    xs, ws = x[row0:row1], w[:, :n_cols]
    ar = out[row0:row1, :n_cols]
    if exact:
        pr = _int_matmul(xs[:, :kwin], ws[:kwin])
        bar = _int_matmul(xs[:, kwin:], ws[kwin:])
        expect = (pr.to(torch.int64) + bar).to(torch.int32)
        bad = ar.to(torch.int32) != expect
    else:
        xs, ws, ar = xs.to(torch.float32), ws.to(torch.float32), ar.to(torch.float32)
        expect = xs[:, :kwin] @ ws[:kwin] + xs[:, kwin:] @ ws[kwin:]
        # negated <=, not >: a corrupted accumulator can be NaN (a stuck bit
        # in the exponent), and NaN must flag as a mismatch
        bad = ~((ar - expect).abs() <= rtol * (1.0 + expect.abs()))
    return bad.cpu().numpy()


@dataclasses.dataclass(frozen=True)
class ScanEngine:
    """Batched DPPU scan pipeline over one rows×cols virtual PE array on
    ``device``.  The probe runs wherever its tensors live: the CUDA kernel
    on a card, the int32 reference on the CPU."""

    cfg: ScanConfig
    device: str = "cuda"

    # -- state ------------------------------------------------------------ #
    def init_state(self) -> ScanState:
        c = self.cfg
        return ScanState(0, 0, torch.zeros((c.rows, c.cols), dtype=torch.int32, device=self.device))

    def confirmed(self, state: ScanState) -> torch.Tensor:
        return state.hits >= self.cfg.confirm_hits

    def suspect(self, state: ScanState) -> torch.Tensor:
        return (state.hits >= 1) & ~self.confirmed(state)

    # -- one probe step: a whole row-block of the grid --------------------- #
    def probe_block(self, state: ScanState, px, pw, ar, ar_neg) -> tuple[ScanState, torch.Tensor, int]:
        """Probe grid rows [cursor·block, cursor·block + block) — all columns —
        against the complementary probe pair, given whole-array operands and
        readbacks.  Returns (next state, (block_rows, cols) flags, block
        start row)."""
        row0 = state.cursor * self.cfg.block_rows
        sl = slice(row0, row0 + self.cfg.block_rows)
        return self.probe_presliced(state, px[sl], pw, ar[sl], ar_neg[sl])

    def probe_presliced(self, state: ScanState, px_b, pw, ar_b, arn_b) -> tuple[ScanState, torch.Tensor, int]:
        """Probe step on an already-sliced row-block (the serving hot path:
        only the block being probed is materialized).  Already-confirmed PEs
        keep failing their probes (the flags report hardware truth) but stop
        accumulating hits."""
        c = self.cfg
        row0 = state.cursor * c.block_rows
        flags = probe_check_pair(px_b, pw, ar_b, arn_b).to(torch.bool)
        hits_b = state.hits[row0 : row0 + c.block_rows]
        countable = flags & (hits_b < c.confirm_hits)
        hits = state.hits.clone()
        hits[row0 : row0 + c.block_rows] = hits_b + countable.to(torch.int32)
        last = state.cursor == c.steps_per_sweep - 1
        nxt = ScanState(0 if last else state.cursor + 1, state.sweep + int(last), hits)
        return nxt, flags, row0

    # -- one whole-array sweep + FPT merge ------------------------------- #
    def sweep(self, state: ScanState, fstate: FaultState, fault_map, stuck_bit, stuck_val,
              px, pw) -> tuple[ScanState, FaultState]:
        """One full sweep: the hardware answers the probe pair once, every
        row-block is probed, and the confirmed set merges into the FPT."""
        ar = corrupt_probe(_int_matmul(px, pw), fault_map, stuck_bit, stuck_val)
        ar_neg = corrupt_probe(_int_matmul(px, -pw), fault_map, stuck_bit, stuck_val)
        for _ in range(self.cfg.steps_per_sweep):
            state, _, _ = self.probe_block(state, px, pw, ar, ar_neg)
        return state, fstate.merge(self.confirmed(state))

    # -- power-on scan ------------------------------------------------------ #
    def boot_scan(self, state: ScanState, fstate: FaultState, fault_map, stuck_bit, stuck_val,
                  px_stack, pw_stack) -> tuple[ScanState, FaultState]:
        """The power-on scan: one :meth:`sweep` per entry of the pre-sampled
        probe schedule ``px_stack`` (n_sweeps, rows, K) / ``pw_stack``
        (n_sweeps, K, cols)."""
        for px, pw in zip(px_stack, pw_stack):
            state, fstate = self.sweep(state, fstate, fault_map, stuck_bit, stuck_val, px, pw)
        return state, fstate


def build_scan_engine(
    rows: int,
    cols: int,
    *,
    window: int = 8,
    block_rows: int = 1,
    confirm_hits: int = 2,
    device="cuda",
) -> ScanEngine:
    """Build a :class:`ScanEngine` on ``device``: the CUDA probe kernel when
    the device is a card, the int32 reference on the CPU."""
    cfg = ScanConfig(
        rows=rows, cols=cols, window=window, block_rows=block_rows,
        confirm_hits=confirm_hits,
    )
    return ScanEngine(cfg=cfg, device=str(torch.device(device)))
