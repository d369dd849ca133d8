"""HyCAEngine — the paper's architecture as a fault-tolerant matmul executor.

Data semantics of Section IV:

  * The matmul's output matrix is mapped onto the virtual rows×cols PE array
    output-stationary: out[i, j] belongs to PE(i % rows, j % cols).
  * Faulty PEs corrupt every output element mapped to them (stuck-at faults on
    the PE's accumulator register).
  * The DPPU recomputes the outputs of up to ``capacity`` faulty PEs
    (leftmost-first priority) and overwrites them in the output buffer.
  * Unrepaired faults degrade the array: their columns (and everything to the
    right) are discarded; :func:`surviving_columns` reports the prefix.

Modes: ``off`` (plain matmul), ``protected`` (faults injected AND repaired —
bit-exact with ``off`` while #faults <= capacity) and ``unprotected`` (faults
injected, no DPPU).

The int32-accumulator stuck-at model is exact for integer operands; for float
dtypes the stuck-at is applied to the bit pattern of the float32 result.

Fault tables are plain tensors on any device.  Torch has no scatter with
``mode="drop"``, so FPT padding (row == col == -1) is routed to a discard slot
one past the dense grid and sliced away — never aliased onto PE(0, 0), where
it could clobber a real fault.  A boolean mask would do the same but forces a
host sync on CUDA.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

from repro_torch.core.redundancy import DPPUConfig, effective_capacity

Mode = Literal["off", "protected", "unprotected"]


@dataclasses.dataclass(frozen=True)
class HyCAConfig:
    rows: int = 32
    cols: int = 32
    dppu: DPPUConfig = dataclasses.field(default_factory=lambda: DPPUConfig(size=32))
    mode: Mode = "off"

    @property
    def capacity(self) -> int:
        return min(self.dppu.size, effective_capacity(self.dppu, self.cols))


@dataclasses.dataclass
class FaultState:
    """Fault PE table (FPT) + stuck-at signatures.

    ``fpt``: (max_faults, 2) int32 — (row, col) of faulty PEs, padded with -1.
    ``stuck_bit`` / ``stuck_val``: (max_faults,) int32 per-entry signatures.
    Construct via :func:`fault_state_from_map`.
    """

    fpt: torch.Tensor
    stuck_bit: torch.Tensor
    stuck_val: torch.Tensor

    @property
    def max_faults(self) -> int:
        return self.fpt.shape[0]

    @property
    def device(self) -> torch.device:
        return self.fpt.device

    def to(self, device) -> "FaultState":
        return FaultState(self.fpt.to(device), self.stuck_bit.to(device), self.stuck_val.to(device))

    def merge(
        self,
        detected: torch.Tensor,
        *,
        stuck_bit: torch.Tensor | None = None,
        stuck_val: torch.Tensor | None = None,
    ) -> "FaultState":
        """Batched FPT merge (the ScanEngine detection→repair path).

        ``detected``: dense (rows, cols) bool grid of newly detected PEs;
        ``stuck_bit``/``stuck_val``: optional (rows, cols) signature grids for
        the new entries (default 0).  The result keeps ``max_faults`` entries:

          * **dedup** — a PE already in the FPT is never appended twice;
          * existing entries keep their signatures; new ones take the grids;
          * leftmost-first sorted (col-major, then row) with -1 padding;
          * overflow beyond ``max_faults`` keeps the leftmost entries and
            drops the rest.
        """
        rows, cols = detected.shape
        dev = detected.device
        bit0, val0, faulty0 = _pe_grids(self, rows, cols)
        new = detected & ~faulty0
        faulty = faulty0 | detected
        zero = torch.zeros((rows, cols), dtype=torch.int32, device=dev)
        bit = torch.where(new, zero if stuck_bit is None else stuck_bit.to(torch.int32), bit0)
        val = torch.where(new, zero if stuck_val is None else stuck_val.to(torch.int32), val0)
        # pack: leftmost-first (col, then row) over the flattened grid
        ci = torch.arange(cols, device=dev)[None, :].expand(rows, cols)
        ri = torch.arange(rows, device=dev)[:, None].expand(rows, cols)
        sentinel = rows * cols
        key = torch.where(faulty, ci * rows + ri, torch.full_like(ci, sentinel)).reshape(-1)
        order = torch.argsort(key, stable=True)
        taken = key[order] < sentinel
        if self.max_faults <= rows * cols:
            order, taken = order[: self.max_faults], taken[: self.max_faults]
        else:
            # more FPT slots than PEs: pad rather than shrink the table
            pad = self.max_faults - rows * cols
            order = torch.cat([order, torch.zeros(pad, dtype=order.dtype, device=dev)])
            taken = torch.cat([taken, torch.zeros(pad, dtype=torch.bool, device=dev)])
        neg = torch.full_like(order, -1)
        r = torch.where(taken, order // cols, neg).to(torch.int32)
        c = torch.where(taken, order % cols, neg).to(torch.int32)
        zf = torch.zeros_like(order, dtype=torch.int32)
        return FaultState(
            torch.stack([r, c], dim=1),
            torch.where(taken, bit.reshape(-1)[order], zf).to(torch.int32),
            torch.where(taken, val.reshape(-1)[order], zf).to(torch.int32),
        )


@dataclasses.dataclass
class RepairPlan:
    """Model-side remediation plan for fault states past DPPU capacity.

    ``col_map``: (cols,) int permutation — residue class ``c`` is computed by
    PE column ``col_map[c]``.  ``prune``: (rows, cols) bool PE mask — the PEs
    the plan sacrifices; every output element they produce is zeroed.
    ``identity_plan`` is bit-exact with ``plan=None``.
    """

    col_map: torch.Tensor
    prune: torch.Tensor

    def to(self, device) -> "RepairPlan":
        return RepairPlan(self.col_map.to(device), self.prune.to(device))


def identity_plan(rows: int, cols: int, *, device="cpu") -> RepairPlan:
    """The no-op plan: native channel→PE mapping, nothing pruned."""
    return RepairPlan(
        torch.arange(cols, dtype=torch.int32, device=device),
        torch.zeros((rows, cols), dtype=torch.bool, device=device),
    )


def validate_repair_plan(plan: RepairPlan, rows: int, cols: int) -> RepairPlan:
    """Host-side check that ``col_map`` is a permutation of range(cols) and
    ``prune`` is a (rows, cols) PE mask."""
    cm = plan.col_map.detach().cpu().numpy()
    if cm.shape != (cols,) or not np.array_equal(np.sort(cm), np.arange(cols)):
        raise ValueError(
            f"RepairPlan.col_map must be a permutation of range({cols}), "
            f"got shape {cm.shape} values {cm[:8]}..."
        )
    if tuple(plan.prune.shape) != (rows, cols):
        raise ValueError(
            f"RepairPlan.prune must be a ({rows}, {cols}) PE mask, "
            f"got shape {tuple(plan.prune.shape)}"
        )
    return plan


def validate_fault_state(state: FaultState, rows: int, cols: int) -> FaultState:
    """Host-side FPT bounds check against the (rows, cols) array geometry: an
    out-of-range entry would otherwise wrap around silently."""
    fpt = state.fpt.detach().cpu().numpy()
    if fpt.ndim != 2 or fpt.shape[1] != 2:
        raise ValueError(f"FPT must be (max_faults, 2), got shape {fpt.shape}")
    valid = fpt[:, 0] >= 0
    bad = valid & ((fpt[:, 0] >= rows) | (fpt[:, 1] < 0) | (fpt[:, 1] >= cols))
    if bad.any():
        entries = [tuple(int(v) for v in e) for e in fpt[bad][:8]]
        raise ValueError(
            f"FPT entries {entries} out of bounds for the {rows}x{cols} PE "
            f"array; fault coordinates must satisfy 0 <= row < {rows} and "
            f"0 <= col < {cols} (padding entries use row == col == -1)"
        )
    return state


def empty_fault_state(max_faults: int = 1, *, device="cpu") -> FaultState:
    """All-padding FPT: the fault-free array.  Feeding it to a protected
    context yields the reference ("off") run through the identical step."""
    return FaultState(
        torch.full((max_faults, 2), -1, dtype=torch.int32, device=device),
        torch.zeros(max_faults, dtype=torch.int32, device=device),
        torch.zeros(max_faults, dtype=torch.int32, device=device),
    )


def fault_state_from_map(
    fault_map: np.ndarray,
    *,
    max_faults: int | None = None,
    rng: np.random.Generator | None = None,
    device="cpu",
) -> FaultState:
    """FPT of a host fault map, leftmost-first, with stuck-at signatures
    drawn from ``rng`` — the same numpy calls as the JAX engine, so the
    signatures are bit-identical for the same generator state."""
    rng = rng or np.random.default_rng(0)
    rows, cols = np.nonzero(fault_map)
    # leftmost-first repair priority (Section IV-B)
    order = np.argsort(cols, kind="stable")
    rows, cols = rows[order], cols[order]
    n = rows.size
    m = max_faults or max(n, 1)
    fpt = np.full((m, 2), -1, dtype=np.int32)
    fpt[:n, 0], fpt[:n, 1] = rows[:m], cols[:m]
    bits = rng.integers(0, 32, size=m).astype(np.int32)
    vals = rng.integers(0, 2, size=m).astype(np.int32)
    return FaultState(
        torch.from_numpy(fpt).to(device),
        torch.from_numpy(bits).to(device),
        torch.from_numpy(vals).to(device),
    )


def _stuck_at_i32(acc: torch.Tensor, bit: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    # int32 1 << 31 is INT32_MIN: a stuck bit 31 is the sign bit
    mask = torch.ones_like(bit, dtype=torch.int32) << bit.to(torch.int32)
    return torch.where(val > 0, acc | mask, acc & ~mask)


def _residues(m: int, n: int, rows: int, cols: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    mi = (torch.arange(m, device=device) % rows)[:, None]
    ni = (torch.arange(n, device=device) % cols)[None, :]
    return mi, ni


def _corrupt(out: torch.Tensor, pe_bit, pe_val, pe_faulty) -> torch.Tensor:
    """Apply per-PE stuck-at faults to an (M, N) output view (int dtypes on
    the int32 accumulator, float dtypes on the float32 bit pattern)."""
    m, n = out.shape
    rows, cols = pe_bit.shape
    mi, ni = _residues(m, n, rows, cols, out.device)
    return _corrupt_elems(out, pe_bit[mi, ni], pe_val[mi, ni], pe_faulty[mi, ni])


def _corrupt_elems(out: torch.Tensor, bi, vi, fi) -> torch.Tensor:
    """Stuck-at ``bi`` at ``vi`` wherever ``fi``, the three given per element
    (broadcast against ``out``).

    Float outputs take the stuck-at from the float32 bit pattern, but the
    select between it and ``out`` is made on floats, as the reference does:
    a bit view carries no gradient, so every element that is not faulty
    passes the gradient of ``out`` through and a faulty one passes none."""
    if not out.dtype.is_floating_point:
        acc = out.to(torch.int32)
        return torch.where(fi, _stuck_at_i32(acc, bi, vi), acc).to(out.dtype)
    out32 = out.to(torch.float32)
    bad = _stuck_at_i32(out32.detach().view(torch.int32), bi, vi).view(torch.float32)
    return torch.where(fi, bad, out32).to(out.dtype)


def _scatter_grid(state: FaultState, rows: int, cols: int, values, dtype, k: int | None = None):
    """Scatter the first ``k`` FPT entries' ``values`` into a dense (rows,
    cols) grid; padding lands in a discard slot past the grid."""
    fpt = state.fpt if k is None else state.fpt[:k]
    valid = fpt[:, 0] >= 0
    flat = torch.where(
        valid, fpt[:, 0].long() * cols + fpt[:, 1].long(),
        torch.full_like(fpt[:, 0], rows * cols, dtype=torch.long),
    )
    grid = torch.zeros(rows * cols + 1, dtype=dtype, device=fpt.device)
    grid[flat] = values
    return grid[: rows * cols].view(rows, cols)


def _pe_grids(state: FaultState, rows: int, cols: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter the FPT into dense (rows, cols) bit/val/faulty grids."""
    bit = _scatter_grid(state, rows, cols, state.stuck_bit.to(torch.int32), torch.int32)
    val = _scatter_grid(state, rows, cols, state.stuck_val.to(torch.int32), torch.int32)
    faulty = _scatter_grid(state, rows, cols, True, torch.bool)
    return bit, val, faulty


def repaired_grid(state: FaultState, rows: int, cols: int, n_repair: int) -> torch.Tensor:
    """Dense (rows, cols) bool grid of DPPU-repaired PEs: the first
    ``n_repair`` valid FPT entries (the FPT is leftmost-sorted)."""
    k = min(max(n_repair, 0), state.max_faults)
    if k == 0:
        return torch.zeros((rows, cols), dtype=torch.bool, device=state.device)
    return _scatter_grid(state, rows, cols, True, torch.bool, k=k)


def _repair_clamp(state: FaultState, cfg: HyCAConfig, n_repair: int | None) -> int:
    # the DPPU can never repair more faults than it has capacity for
    return cfg.capacity if n_repair is None else min(n_repair, state.max_faults, cfg.capacity)


def _int_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int32 accumulate of an integer matmul (wraps mod 2**32 like the
    int32 accumulator).  A broadcast sum: CUDA has no integer GEMM."""
    prod = x.to(torch.int64)[..., :, None] * w.to(torch.int64)
    return prod.sum(dim=-2).to(torch.int32)


def _accumulate(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The clean accumulate: int32 for integer operands, float32 otherwise
    (a bf16 x bf16 product is exact in float32)."""
    if not x.dtype.is_floating_point:
        return _int_matmul(x, w)
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def hyca_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    state: FaultState | None,
    *,
    cfg: HyCAConfig,
    n_repair: int | None = None,
    plan: RepairPlan | None = None,
) -> torch.Tensor:
    """x: (..., K) @ w: (K, N) through the HyCA-protected virtual array (fault
    semantics on the flattened (M, N) output view) — the two-pass engine:
    corrupt every fault, overwrite the repaired ones, zero the pruned ones.

    ``n_repair``: how many FPT entries the DPPU repairs (default: up to
    capacity).  ``plan``: optional :class:`RepairPlan`; ``None`` and the
    identity plan are bit-exact.  Returns int32 or float32.
    """
    if state is not None:
        validate_fault_state(state, cfg.rows, cfg.cols)
    if plan is not None:
        validate_repair_plan(plan, cfg.rows, cfg.cols)
    out = _accumulate(x, w)
    if cfg.mode == "off" or state is None:
        return out
    shape = out.shape
    out2 = out.reshape(-1, shape[-1])
    bit, val, faulty = _pe_grids(state, cfg.rows, cfg.cols)
    if cfg.mode == "unprotected":
        repaired = torch.zeros((cfg.rows, cfg.cols), dtype=torch.bool, device=out.device)
    else:
        repaired = repaired_grid(state, cfg.rows, cfg.cols, _repair_clamp(state, cfg, n_repair))
    prune = None
    if plan is not None:
        # remap: residue class c is computed by PE column col_map[c]
        cm = plan.col_map.long()
        bit, val, faulty, repaired = bit[:, cm], val[:, cm], faulty[:, cm], repaired[:, cm]
        prune = plan.prune[:, cm]
    corrupted = _corrupt(out2, bit, val, faulty)
    mi, ni = _residues(*out2.shape, cfg.rows, cfg.cols, out.device)
    # DPPU overwrite: the recomputed (correct) value wherever repaired
    res = torch.where(repaired[mi, ni], out2, corrupted)
    if prune is not None:
        res = torch.where(prune[mi, ni], torch.zeros((), dtype=res.dtype, device=res.device), res)
    return res.reshape(shape)


# --------------------------------------------------------------------------- #
# single-pass fused epilogue (the fused dispatch's element-granular path)
# --------------------------------------------------------------------------- #
META_BIT_MASK = 31       # bits 0..4: stuck accumulator bit index (0..31)
META_VAL_SHIFT = 5       # bit 5: stuck-at value
META_EFF_SHIFT = 6       # bit 6: effective fault (faulty & ~repaired)
META_PRUNE_SHIFT = 7     # bit 7: RepairPlan prune mask


def fault_meta_grid(
    state: FaultState,
    cfg: HyCAConfig,
    plan: RepairPlan | None = None,
    *,
    n_repair: int | None = None,
) -> torch.Tensor:
    """Packed (rows, cols) int32 meta grid for the fused single-pass epilogue:
    the two-pass decision tree folded to per-PE bits (``eff`` = faulty &
    ~repaired with the capacity clamp of :func:`hyca_matmul`; the plan's
    column gather applied to the grid; its prune mask as bit 7)."""
    bit, val, faulty = _pe_grids(state, cfg.rows, cfg.cols)
    if cfg.mode == "unprotected":
        repaired = torch.zeros((cfg.rows, cfg.cols), dtype=torch.bool, device=state.device)
    else:
        repaired = repaired_grid(state, cfg.rows, cfg.cols, _repair_clamp(state, cfg, n_repair))
    if plan is not None:
        cm = plan.col_map.long()
        bit, val, faulty, repaired = bit[:, cm], val[:, cm], faulty[:, cm], repaired[:, cm]
        prune = plan.prune[:, cm].to(torch.int32)
    else:
        prune = torch.zeros((cfg.rows, cfg.cols), dtype=torch.int32, device=state.device)
    eff = (faulty & ~repaired).to(torch.int32)
    return bit | (val << META_VAL_SHIFT) | (eff << META_EFF_SHIFT) | (prune << META_PRUNE_SHIFT)


def fault_mask_grids(meta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-PE AND/OR mask pair a packed meta grid lowers to:

      * clean / repaired      — ``(raw & ~0) | 0``
      * stuck-at-1 on bit b   — ``(raw & ~0) | (1 << b)``
      * stuck-at-0 on bit b   — ``(raw & ~(1 << b)) | 0``
      * pruned                — ``(raw & 0) | 0``  (bit pattern 0 is +0.0)

    Both are (rows, cols) int32; the CUDA ``ft_matmul`` applies them to its
    accumulator in registers."""
    bit = meta & META_BIT_MASK
    val = (meta >> META_VAL_SHIFT) & 1
    eff = (meta >> META_EFF_SHIFT) & 1
    prune = (meta >> META_PRUNE_SHIFT) & 1
    mask = torch.ones_like(bit) << bit
    keep = torch.full_like(bit, -1)
    zero = torch.zeros_like(bit)
    and_grid = torch.where(prune > 0, zero, torch.where((eff > 0) & (val == 0), ~mask, keep))
    or_grid = torch.where((prune == 0) & (eff > 0) & (val > 0), mask, zero)
    return and_grid, or_grid


def apply_fault_epilogue(
    out: torch.Tensor,
    meta: torch.Tensor,
    rows: int,
    cols: int,
    *,
    row_residue: torch.Tensor | None = None,
    col_residue: torch.Tensor | None = None,
) -> torch.Tensor:
    """Apply a packed fault meta grid to an ``(M, N)`` output view in one
    pass — bit-identical to the two-pass corrupt + DPPU-overwrite + prune
    sequence of :func:`hyca_matmul` (``repaired`` is a subset of ``faulty``).

    ``row_residue`` / ``col_residue``: precomputed ``i % rows`` / ``j % cols``
    indices broadcastable against the view (default: the view's own)."""
    and_grid, or_grid = fault_mask_grids(meta)
    return apply_mask_grids(out, and_grid, or_grid, row_residue=row_residue, col_residue=col_residue)


def apply_mask_grids(
    out: torch.Tensor,
    and_grid: torch.Tensor,
    or_grid: torch.Tensor,
    *,
    row_residue: torch.Tensor | None = None,
    col_residue: torch.Tensor | None = None,
) -> torch.Tensor:
    """``(raw & and_grid[pe]) | or_grid[pe]`` on the int32 accumulator (the
    float32 bit pattern for float dtypes) of every element of an (M, N)
    view, with out[i, j] on PE(i % rows, j % cols) — the epilogue the CUDA
    ``ft_matmul`` applies in registers."""
    rows, cols = and_grid.shape
    if row_residue is None:
        row_residue = (torch.arange(out.shape[0], device=out.device) % rows)[:, None]
    if col_residue is None:
        col_residue = torch.arange(out.shape[-1], device=out.device) % cols
    am = and_grid[row_residue, col_residue]
    om = or_grid[row_residue, col_residue]
    if not out.dtype.is_floating_point:
        return ((out.to(torch.int32) & am) | om).to(out.dtype)
    raw = out.to(torch.float32).view(torch.int32)
    return ((raw & am) | om).view(torch.float32).to(out.dtype)


# --------------------------------------------------------------------------- #
# ABFT checksum carriers (the decision lives in repro_torch.transient.abft)
# --------------------------------------------------------------------------- #
def abft_encode(w: torch.Tensor) -> torch.Tensor:
    """Encode-time ABFT weight checksum: ``wc[k] = sum_j w[k, j]`` in the
    accumulator dtype (int32, wrapping, for integer weights; float32
    otherwise).  Computed once at weight load and stored: a weight bit
    flipped in memory after encode breaks ``x @ wc == out.sum(-1)``, the
    only way ABFT sees weight-memory upsets."""
    if w.dtype.is_floating_point:
        return w.to(torch.float32).sum(dim=-1)
    return _i32(w.to(torch.int64).sum(dim=-1))


def _lane_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A checksum lane's product in the accumulator dtype: the exact int32
    accumulate for integers, a float32 matmul otherwise."""
    if not a.dtype.is_floating_point:
        return _int_matmul(a, b)
    return torch.matmul(a, b.to(torch.float32))


def abft_checksums(
    x: torch.Tensor,
    w: torch.Tensor,
    state: FaultState | None,
    *,
    cfg: HyCAConfig,
    plan: RepairPlan | None = None,
    n_repair: int | None = None,
    wc: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The ABFT checksum lanes of ``x @ w`` carried through the virtual
    array, corrupted / repaired / pruned by the same packed fault meta as the
    data.  Returns ``(chk_row, chk_col)``:

      * ``chk_row`` — (1, N) ``colsum(x) @ w``, output row M of the augmented
        view (PE row ``M % rows``); its syndrome against ``out.sum(rows)``
        flags corrupted accumulations.  It reads the same ``w`` as the data,
        so it is blind to weight-memory flips;
      * ``chk_col`` — (M, 1) ``x @ wc`` with the encode-time ``wc``
        (:func:`abft_encode`), output column N (PE col ``N % cols``);
        ``None`` without ``wc``.

    The lanes are computed beside the data matmul, never inside it, so
    turning them on moves no output bit.  Integer lanes are exact (int32
    wraps like the accumulator); float lanes reassociate the reduction."""
    x2 = x.reshape(-1, x.shape[-1])
    m, n = x2.shape[0], w.shape[-1]
    if x.dtype.is_floating_point:
        pref = torch.float32
        x2 = x2.to(pref)
        colsum = x2.sum(dim=0, keepdim=True)
    else:
        pref = torch.int32
        colsum = _i32(x2.to(torch.int64).sum(dim=0, keepdim=True))
    chk_row = _lane_matmul(colsum, w)
    chk_col = None
    if wc is not None:
        chk_col = _lane_matmul(x2, wc.reshape(-1, 1).to(pref))
    if cfg.mode != "off" and state is not None:
        meta = fault_meta_grid(state, cfg, plan, n_repair=n_repair)
        chk_row = apply_fault_epilogue(
            chk_row, meta, cfg.rows, cfg.cols,
            row_residue=torch.full((1, 1), m % cfg.rows, dtype=torch.long, device=meta.device),
        )
        if chk_col is not None:
            chk_col = apply_fault_epilogue(
                chk_col, meta, cfg.rows, cfg.cols,
                col_residue=torch.full((1,), n % cfg.cols, dtype=torch.long, device=meta.device),
            )
    return chk_row, chk_col


def hyca_matmul_abft(
    x: torch.Tensor,
    w: torch.Tensor,
    state: FaultState | None,
    *,
    cfg: HyCAConfig,
    n_repair: int | None = None,
    plan: RepairPlan | None = None,
    wc: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """:func:`hyca_matmul` plus the ABFT lanes: ``(out, chk_row, chk_col)``,
    ``out`` bit for bit the plain :func:`hyca_matmul` result."""
    out = hyca_matmul(x, w, state, cfg=cfg, n_repair=n_repair, plan=plan)
    chk_row, chk_col = abft_checksums(x, w, state, cfg=cfg, plan=plan, n_repair=n_repair, wc=wc)
    return out, chk_row, chk_col


# --------------------------------------------------------------------------- #
# element-exact fault accounting (the device side of the obs counters)
# --------------------------------------------------------------------------- #
def _pe_multiplicity(m: int, n: int, rows: int, cols: int) -> np.ndarray:
    """Static (rows, cols) int32 grid: how many elements of an (m, n) output
    view map onto each PE under out[i, j] -> PE(i % rows, j % cols)."""
    ri = np.bincount(np.arange(m) % rows, minlength=rows)
    ci = np.bincount(np.arange(n) % cols, minlength=cols)
    return np.outer(ri, ci).astype(np.int32)


def _i32(t: torch.Tensor) -> torch.Tensor:
    """An integer count as int32, wrapping as the reference's int32 sums do."""
    return t.to(torch.int64).to(torch.int32)


def protected_view_stats(
    state: FaultState | None,
    cfg: HyCAConfig,
    plan: RepairPlan | None,
    m: int,
    n: int,
    *,
    n_repair: int | None = None,
) -> dict[str, torch.Tensor]:
    """Element-exact fault accounting for one (m, n) protected output view.

    Reduces the same grids, capacity clamp and plan gather that
    :func:`hyca_matmul` applies to values down to int32 element counts (0-d
    tensors on the state's device).  Each count depends only on (state,
    plan, geometry, m, n), never on the activations:

      * ``total_elems``      — m·n, every element of the view;
      * ``fault_elems``      — elements mapped onto faulty PEs;
      * ``recomputed_elems`` — fault elements the DPPU overwrites (0 in
        unprotected mode);
      * ``corrupted_elems``  — fault elements neither recomputed nor pruned;
      * ``pruned_elems``     — elements the RepairPlan zeroes;
      * ``fault_col_elems``  — elements in output channels whose PE column
        carries a corrupting fault.
    """
    device = state.device if state is not None else "cpu"
    total = torch.tensor(m * n, dtype=torch.int32, device=device)
    if cfg.mode == "off" or state is None:
        zero = torch.zeros((), dtype=torch.int32, device=device)
        return {
            "total_elems": total, "fault_elems": zero, "recomputed_elems": zero,
            "corrupted_elems": zero, "pruned_elems": zero, "fault_col_elems": zero,
        }
    _, _, faulty = _pe_grids(state, cfg.rows, cfg.cols)
    if cfg.mode == "unprotected":
        repaired = torch.zeros((cfg.rows, cfg.cols), dtype=torch.bool, device=device)
    else:
        repaired = repaired_grid(state, cfg.rows, cfg.cols, _repair_clamp(state, cfg, n_repair))
    if plan is not None:
        cm = plan.col_map.long()
        faulty, repaired = faulty[:, cm], repaired[:, cm]
        prune = plan.prune[:, cm]
    else:
        prune = torch.zeros((cfg.rows, cfg.cols), dtype=torch.bool, device=device)
    mult = torch.from_numpy(_pe_multiplicity(m, n, cfg.rows, cfg.cols)).to(device, torch.int64)

    def count(mask: torch.Tensor) -> torch.Tensor:
        return _i32((mult * mask).sum())

    corrupting = faulty & ~repaired & ~prune
    # channels (j values) per PE column: a column with a corrupting fault
    # taints every element of every channel mapped onto it
    chan = torch.from_numpy(np.bincount(np.arange(n) % cfg.cols, minlength=cfg.cols)).to(device, torch.int64)
    return {
        "total_elems": total,
        "fault_elems": count(faulty),
        "recomputed_elems": count(faulty & repaired),
        "corrupted_elems": count(corrupting),
        "pruned_elems": count(prune),
        "fault_col_elems": _i32(m * (chan * corrupting.any(dim=0)).sum()),
    }


def surviving_columns(state: FaultState, cfg: HyCAConfig) -> int:
    """Column-prefix degradation when #faults > capacity (host-side helper)."""
    fpt = state.fpt.detach().cpu().numpy()
    n = int((fpt[:, 0] >= 0).sum())
    if n <= cfg.capacity:
        return cfg.cols
    return int(fpt[cfg.capacity, 1])
