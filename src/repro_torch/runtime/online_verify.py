"""Online fault detection — the paper's Section IV-D lifted to LM matmuls.

The paper reserves DPPU groups to re-execute a sliding window of S MACs for
the scanned PEs and compares AR == BAR + PR.  Here, over a live matmul
output:

  * the output is tiled onto the virtual PE grid (out[i, j] -> PE(i % rows,
    j % cols), the engine's mapping);
  * each check recomputes a row-block of PE output elements with independent
    products — a partial-result check over a ``window``-long slice of the
    contraction (:func:`repro_torch.core.scan.output_block_check` does the
    batched math, on the tensors' device);
  * the cursor rotates over the **occupied** grid — the ``min(rows, M) ×
    min(cols, N)`` sub-grid that owns output elements — with one cursor per
    shape, so small decode shapes never skip scan steps;
  * detected PEs are appended to the FPT on the host by :func:`append_fault`
    (deduped), or merged on the device by
    :meth:`repro_torch.core.engine.FaultState.merge`.

The integer datapath compares exactly; float outputs use a relative
tolerance, since recomputation reassociates the sum.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.engine import FaultState
from repro_torch.core.scan import output_block_check


@dataclasses.dataclass
class OnlineVerifier:
    rows: int = 32
    cols: int = 32
    window: int = 8          # S — MACs recomputed per check (partial result)
    block_rows: int = 1      # PE-grid rows verified per check_block call
    rtol: float = 1e-3
    step: int = 0            # total checks issued (telemetry)
    # one cursor per occupied-grid shape: a single counter taken modulo a
    # shape-dependent grid size would alias (alternating (2, n) and (3, n)
    # outputs would pin the (2, n) cursor to even residues)
    _cursors: dict = dataclasses.field(default_factory=dict)

    def occupied(self, m: int | None = None, n: int | None = None) -> tuple[int, int]:
        """The sub-grid of PEs that own at least one output element of an
        (m, n) output tile — the grid the cursor rotates over."""
        r = self.rows if m is None else min(self.rows, m)
        c = self.cols if n is None else min(self.cols, n)
        return max(r, 1), max(c, 1)

    def coord(self, step: int | None = None, *, m: int | None = None,
              n: int | None = None) -> tuple[int, int]:
        s = self.step if step is None else step
        rows, cols = self.occupied(m, n)
        idx = s % (rows * cols)
        return idx // cols, idx % cols

    def _advance(self, key: tuple) -> int:
        """Take the next cursor position for this occupied-grid shape (and
        check granularity) and advance it (also bumps the global counter)."""
        s = self._cursors.get(key, 0)
        self._cursors[key] = s + 1
        self.step += 1
        return s

    def check(self, x: torch.Tensor, w: torch.Tensor, out: torch.Tensor) -> tuple[bool, tuple[int, int]]:
        """Re-verify the output element owned by the scanned PE.

        x: (M, K), w: (K, N), out: (M, N) as the (possibly faulty) array
        produced it.  The cursor rotates over the occupied grid, so every
        check verifies a real output element."""
        m, n = out.shape
        rows, cols = self.occupied(m, n)
        idx = self._advance(("elem", rows, cols)) % (rows * cols)
        r, c = idx // cols, idx % cols
        # single-column slice: one element costs two O(K) dot products
        bad = output_block_check(
            x, w[:, c : c + 1], out[:, c : c + 1], row0=r, row1=r + 1,
            n_cols=1, window=self.window, rtol=self.rtol,
        )[0, 0]
        return not bool(bad), (r, c)

    def check_block(self, x: torch.Tensor, w: torch.Tensor,
                    out: torch.Tensor) -> tuple[bool, list[tuple[int, int]]]:
        """Verify a whole row-block of the occupied grid in one vectorized
        call.  Returns (all clean, flagged PE coordinates)."""
        m, n = out.shape
        rows, cols = self.occupied(m, n)
        blocks = -(-rows // self.block_rows)
        r0 = (self._advance(("block", rows, cols)) % blocks) * self.block_rows
        r1 = min(r0 + self.block_rows, rows)
        bad = output_block_check(
            x, w, out, row0=r0, row1=r1, n_cols=cols,
            window=self.window, rtol=self.rtol,
        )
        flagged = [(r0 + int(i), int(j)) for i, j in zip(*np.nonzero(bad))]
        return not flagged, flagged

    def scan_cycles(self) -> int:
        """Paper Section IV-D: Row·Col + Col cycles for a full sweep (one
        reserved DPPU group)."""
        return self.rows * self.cols + self.cols


def append_fault(state: FaultState, row: int, col: int) -> FaultState:
    """FPT update on detection (host-side; the next step's repair consumes
    it), returned on the state's device.

    Deduped: re-detecting a (row, col) already in the table returns the
    state unchanged (a duplicate would burn a DPPU repair lane).  A full
    table grows by one entry (capacity exceeded: the degradation path).  The
    valid entries stay leftmost-sorted, ties in their table order."""
    fpt = state.fpt.cpu().numpy().copy()
    if bool(((fpt[:, 0] == row) & (fpt[:, 1] == col)).any()):
        return state
    bits = state.stuck_bit.cpu().numpy()
    vals = state.stuck_val.cpu().numpy()
    free = np.nonzero(fpt[:, 0] < 0)[0]
    if free.size == 0:
        fpt = np.concatenate([fpt, [[row, col]]]).astype(np.int32)
        bits = np.concatenate([bits, [0]]).astype(np.int32)
        vals = np.concatenate([vals, [0]]).astype(np.int32)
    else:
        fpt[free[0]] = (row, col)
    order = np.argsort(np.where(fpt[:, 0] >= 0, fpt[:, 1], 2**30), kind="stable")
    return FaultState(*(torch.from_numpy(np.ascontiguousarray(a[order])) for a in (fpt, bits, vals))).to(state.device)
