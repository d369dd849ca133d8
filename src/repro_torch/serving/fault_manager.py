"""PE fault lifecycle for the serving runtime (paper Sections IV-C/IV-D).

Two actors, deliberately separated:

  * :class:`FaultInjector` — the *hardware*.  Owns the ground-truth fault map
    and per-PE stuck-at signatures (host numpy, the same RNG calls as the JAX
    package, so the same seed gives the same faults), can accumulate new
    faults over time, and exposes the two ways software observes it: the
    :class:`~repro_torch.core.engine.FaultState` that corrupts the protected
    matmul path, and corrupted *probe* computations.
  * :class:`FaultManager` — the *runtime*.  Never reads the truth directly.
    One batched probe step per decode step checks a whole row-block of the PE
    grid against the complementary ±probe pair on the
    :class:`~repro_torch.core.scan.ScanEngine` (the CUDA probe kernel on a
    card) and drives each PE through the lifecycle

        HEALTHY -> SUSPECT -> CONFIRMED -> REPAIRED | REMAPPED | RETIRED

    ``confirm_hits`` flags promote a PE to CONFIRMED and merge it into the
    FPT (batched, deduped, leftmost-sorted).  Confirmed faults within DPPU
    capacity are REPAIRED; the leftmost-first overflow is REMAPPED (with
    ``FaultManagerConfig.remap``, up to ``max_remap_fraction`` of the
    columns) or RETIRED with its column region, which the manager publishes
    as ``capacity_fraction``.

With ``FaultManagerConfig.abft`` each scan step also runs the ABFT canary
(:meth:`FaultManager.abft_check`): the probe matmul's checksum pair over the
whole array, host numpy, exact int32 syndromes, ``abft.alarm`` on any
non-zero one.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.engine import FaultState, HyCAConfig, fault_state_from_map, surviving_columns
from repro_torch.core.scan import ScanState, build_scan_engine, probe_operands

HEALTHY, SUSPECT, CONFIRMED, REPAIRED, RETIRED = "healthy", "suspect", "confirmed", "repaired", "retired"
# an over-capacity confirmed fault whose PE column is handled model-side: a
# least-salient (pruned) output residue class is routed onto it
REMAPPED = "remapped"
_LIFECYCLE = (HEALTHY, SUSPECT, CONFIRMED, REPAIRED, REMAPPED, RETIRED)


# --------------------------------------------------------------------------- #
# hardware
# --------------------------------------------------------------------------- #
class FaultInjector:
    """Ground-truth fault map + stuck-at signatures for one rows×cols array
    (host numpy)."""

    def __init__(self, rows: int, cols: int, *, seed: int = 0):
        self.rows, self.cols = rows, cols
        self.rng = np.random.default_rng(seed)
        self.fault_map = np.zeros((rows, cols), bool)
        self.stuck_bit = np.zeros((rows, cols), np.int32)
        self.stuck_val = np.zeros((rows, cols), np.int32)
        self.version = 0  # bumped on every change; lets callers cache states
        # optional EventLog (the server attaches its own): every injection is
        # stamped with the log's current step, so detection latency is measured
        self.log = None

    @property
    def n_faults(self) -> int:
        return int(self.fault_map.sum())

    def coords(self) -> list[tuple[int, int]]:
        return [(int(r), int(c)) for r, c in zip(*np.nonzero(self.fault_map))]

    def inject_at(self, row: int, col: int, *, bit: int | None = None, val: int | None = None) -> None:
        if self.fault_map[row, col]:
            return
        self.fault_map[row, col] = True
        self.stuck_bit[row, col] = self.rng.integers(0, 32) if bit is None else bit
        self.stuck_val[row, col] = self.rng.integers(0, 2) if val is None else val
        self.version += 1
        if self.log is not None:
            self.log.emit("fault.injected", row=int(row), col=int(col),
                          bit=int(self.stuck_bit[row, col]),
                          val=int(self.stuck_val[row, col]))

    def inject_n(self, n: int) -> None:
        """n new faults at uniform-random healthy PEs."""
        free = np.argwhere(~self.fault_map)
        if free.size == 0 or n <= 0:
            return
        pick = self.rng.choice(len(free), size=min(n, len(free)), replace=False)
        for r, c in free[np.atleast_1d(pick)]:
            self.inject_at(int(r), int(c))

    def inject_map(self, fault_map: np.ndarray) -> None:
        """Every PE of ``fault_map`` (row-major order), each through
        :meth:`inject_at`, so the RNG is consumed as the reference's is."""
        for r, c in np.argwhere(fault_map):
            self.inject_at(int(r), int(c))

    def step(self, rate: float) -> int:
        """Accumulate Poisson(rate) new faults (one serving step's wearout)."""
        n = int(self.rng.poisson(rate)) if rate > 0 else 0
        if n:
            self.inject_n(n)
        return n

    # -- software-visible views ------------------------------------------- #
    def fault_state(self, *, exclude: frozenset[tuple[int, int]] = frozenset(),
                    max_faults: int | None = None, device="cpu") -> FaultState:
        """Engine FaultState of the truth minus ``exclude`` (confirmed faults
        are repaired or remapped, so they no longer corrupt), on ``device``."""
        m = self.fault_map.copy()
        for r, c in exclude:
            m[r, c] = False
        state = fault_state_from_map(m, max_faults=max_faults or self.rows * self.cols)
        # fault_state_from_map samples fresh signatures; overwrite with truth
        fpt = state.fpt.numpy()
        bits = state.stuck_bit.numpy().copy()
        vals = state.stuck_val.numpy().copy()
        for i, (r, c) in enumerate(fpt):
            if r >= 0:
                bits[i] = self.stuck_bit[r, c]
                vals[i] = self.stuck_val[r, c]
        return FaultState(state.fpt, torch.from_numpy(bits), torch.from_numpy(vals)).to(device)

    def truth_grids(self, device="cpu") -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Dense (rows, cols) grids of the truth on ``device`` — the hardware
        the batched scan probes (``scan.corrupt_probe`` is the device mirror
        of :meth:`corrupted_probe`)."""
        return (
            torch.from_numpy(self.fault_map.copy()).to(device),
            torch.from_numpy(self.stuck_bit.copy()).to(device),
            torch.from_numpy(self.stuck_val.copy()).to(device),
        )

    def probe_operands(self, sweep: int, window: int = 8) -> tuple[np.ndarray, np.ndarray]:
        """Deterministic small-int probe operands, fresh per sweep (one shared
        recipe: :func:`repro_torch.core.scan.probe_operands`)."""
        return probe_operands(self.rows, self.cols, sweep, window)

    def corrupted_probe(self, px: np.ndarray, pw: np.ndarray, row0: int = 0) -> np.ndarray:
        """What the faulty array returns for the probe matmul: out[i, j] is
        PE(row0 + i, j)'s accumulator with its stuck bit forced."""
        sl = slice(row0, row0 + px.shape[0])
        out = (px.astype(np.int64) @ pw.astype(np.int64)).astype(np.int32)
        mask = (np.int32(1) << self.stuck_bit[sl]).astype(np.int32)
        stuck_on = (out | mask).astype(np.int32)
        stuck_off = (out & ~mask).astype(np.int32)
        bad = np.where(self.stuck_val[sl] > 0, stuck_on, stuck_off)
        return np.where(self.fault_map[sl], bad, out)


# --------------------------------------------------------------------------- #
# runtime lifecycle
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class FaultManagerConfig:
    confirm_hits: int = 2      # probe flags needed to promote SUSPECT -> CONFIRMED
    probe_window: int = 8      # S — MACs recomputed per check
    max_boot_sweeps: int = 4   # whole-array sweeps in the power-on scan
    scan_block: int = 1        # PE-grid rows probed per scan step (p = scan_block·cols)
    # over-capacity confirmed faults become REMAPPED instead of RETIRED, up
    # to max_remap_fraction of the columns
    remap: bool = False
    max_remap_fraction: float = 0.5
    # ABFT canary: carry the checksum pair beside each probe matmul and
    # alarm on non-zero syndromes (exact: the probe datapath is int32) —
    # whole-array, step-granular, including rows the cursor meets next sweep
    abft: bool = False


class FaultManager:
    """HEALTHY → SUSPECT → CONFIRMED → REPAIRED/RETIRED state machine, driven
    by the batched ScanEngine on ``device``."""

    def __init__(self, hyca: HyCAConfig, injector: FaultInjector,
                 cfg: FaultManagerConfig | None = None, *, device="cuda"):
        if (hyca.rows, hyca.cols) != (injector.rows, injector.cols):
            raise ValueError("injector and array geometry differ")
        self.hyca = hyca
        self.injector = injector
        self.cfg = cfg or FaultManagerConfig()
        self.device = torch.device(device)
        self.engine = build_scan_engine(
            hyca.rows, hyca.cols,
            window=self.cfg.probe_window, block_rows=self.cfg.scan_block,
            confirm_hits=self.cfg.confirm_hits, device=self.device,
        )
        self.scan_state = self.engine.init_state()
        self.pe_state = np.full((hyca.rows, hyca.cols), HEALTHY, dtype=object)
        n = hyca.rows * hyca.cols
        self._set_confirmed(FaultState(
            torch.full((n, 2), -1, dtype=torch.int32, device=self.device),
            torch.zeros(n, dtype=torch.int32, device=self.device),
            torch.zeros(n, dtype=torch.int32, device=self.device),
        ))
        self.scans = 0
        self.repairs = 0
        self.remaps = 0
        self.abft_alarms = 0
        # optional EventLog (shared with the injector): lifecycle transitions
        # and sweep completions are emitted here, one event per (label, PE)
        self.log = None
        self._emitted: set[tuple[str, int, int]] = set()

    def _emit(self, kind: str, **data) -> None:
        if self.log is not None:
            self.log.emit(kind, **data)

    def _emit_lifecycle(self, label: str, row: int, col: int) -> None:
        key = (label, row, col)
        if key not in self._emitted:
            self._emitted.add(key)
            self._emit(f"fault.{label}", row=row, col=col)

    def _set_confirmed(self, state: FaultState) -> None:
        # the host copy of the FPT is read several times per step; keep it
        # beside the device table instead of syncing for each read
        self.confirmed_state = state
        self._confirmed_fpt = state.fpt.cpu().numpy()

    # ------------------------------------------------------------------ #
    @property
    def hits(self) -> np.ndarray:
        return self.scan_state.hits.cpu().numpy()

    @property
    def steps_per_sweep(self) -> int:
        """Probe steps per whole-array sweep (rows / scan_block)."""
        return self.engine.cfg.steps_per_sweep

    def scan_cycles(self) -> int:
        """Analytical sweep latency at this grouping: ⌈Row·Col/p⌉ + Col."""
        return self.engine.cfg.scan_cycles()

    def confirmed_coords(self) -> frozenset[tuple[int, int]]:
        return frozenset((int(r), int(c)) for r, c in self._confirmed_fpt if r >= 0)

    def _label_coords(self, label: str) -> frozenset[tuple[int, int]]:
        return frozenset(
            (int(r), int(c)) for r, c in np.argwhere(self.pe_state == label)
        )

    def repaired_coords(self) -> frozenset[tuple[int, int]]:
        return self._label_coords(REPAIRED)

    def remapped_coords(self) -> frozenset[tuple[int, int]]:
        return self._label_coords(REMAPPED)

    def retired_coords(self) -> frozenset[tuple[int, int]]:
        return self._label_coords(RETIRED)

    @property
    def n_confirmed(self) -> int:
        return len(self.confirmed_coords())

    @property
    def n_remapped(self) -> int:
        return len(self.remapped_coords())

    @property
    def remapped_cols(self) -> frozenset[int]:
        """Distinct PE columns carrying a pruned (remapped) residue class."""
        return frozenset(c for _, c in self.remapped_coords())

    @property
    def surviving_cols(self) -> int:
        if self.n_confirmed <= self.hyca.capacity:
            return self.hyca.cols
        retired = self.retired_coords()
        if not retired:
            return self.hyca.cols  # every overflow fault is remapped
        if not self.cfg.remap:
            return surviving_columns(self.confirmed_state, self.hyca)
        return min(c for _, c in retired)

    @property
    def capacity_fraction(self) -> float:
        """1.0 while confirmed faults fit the DPPU (or are remapped); the
        surviving column prefix fraction once faults retire columns."""
        return self.surviving_cols / self.hyca.cols

    @property
    def quality_fraction(self) -> float:
        """Fraction of PE columns producing trusted (non-pruned) output."""
        return 1.0 - len(self.remapped_cols) / self.hyca.cols

    def counts(self) -> dict[str, int]:
        return {s: int((self.pe_state == s).sum()) for s in _LIFECYCLE}

    # ------------------------------------------------------------------ #
    def _reassign_repair(self) -> None:
        """Leftmost-first: the first ``capacity`` confirmed faults are DPPU-
        repaired; the overflow is REMAPPED (when enabled and within the
        column budget) or retired with its column region."""
        coords = sorted(self.confirmed_coords(), key=lambda rc: (rc[1], rc[0]))
        max_remap_cols = (
            int(np.floor(self.cfg.max_remap_fraction * self.hyca.cols))
            if self.cfg.remap else 0
        )
        remap_cols: set[int] = set()
        for i, (r, c) in enumerate(coords):
            if i < self.hyca.capacity:
                new = REPAIRED
            elif c in remap_cols or len(remap_cols) < max_remap_cols:
                remap_cols.add(c)
                new = REMAPPED
            else:
                new = RETIRED
            if self.pe_state[r, c] != new:
                self.pe_state[r, c] = new
                self._emit_lifecycle(new, r, c)
                if new == REPAIRED:
                    self.repairs += 1
                elif new == REMAPPED:
                    self.remaps += 1

    def _sync(self) -> None:
        """Fold the engine's hit counters into lifecycle labels and merge the
        confirmed set into the FPT."""
        hits = self.scan_state.hits.cpu().numpy()
        confirmed = hits >= self.cfg.confirm_hits
        suspect = (hits >= 1) & ~confirmed
        ps = self.pe_state
        newly_suspect = suspect & (ps == HEALTHY)
        for r, c in np.argwhere(newly_suspect):
            self._emit_lifecycle("suspect", int(r), int(c))
        ps[newly_suspect] = SUSPECT
        known = (ps == CONFIRMED) | (ps == REPAIRED) | (ps == RETIRED)
        newly = confirmed & ~known
        if newly.any():
            for r, c in np.argwhere(newly):
                self._emit_lifecycle("confirmed", int(r), int(c))
            ps[newly] = CONFIRMED
            self._set_confirmed(self.confirmed_state.merge(torch.from_numpy(confirmed).to(self.device)))
            self._reassign_repair()

    def abft_check(self) -> bool:
        """ABFT canary over the whole probe matmul: carry the checksum pair
        beside the sweep's probe computation and compare against the array's
        actual accumulators.  The probe datapath is int32 with small
        operands, so both syndromes are exact: zero means the whole array's
        probe output is sum-consistent this step, non-zero means real
        corruption, including faults in row blocks the cursor will not visit
        for another ``steps_per_sweep`` steps.

        The lanes ride the augmented view as in
        :func:`repro_torch.core.engine.abft_checksums`: the appended row lands
        on PE row ``rows % rows == 0`` and the appended column on PE col
        ``cols % cols == 0``, so the truth grids of PE row/column 0 corrupt
        them.  Host numpy, outside any captured graph.  Returns True and
        emits ``abft.alarm`` when any syndrome is non-zero."""
        inj = self.injector
        px, pw = inj.probe_operands(self.scan_state.sweep, self.cfg.probe_window)
        ar = inj.corrupted_probe(px, pw).astype(np.int64)

        def stuck(v, sl_r, sl_c):
            mask = (np.int32(1) << inj.stuck_bit[sl_r, sl_c]).astype(np.int32)
            bad = np.where(inj.stuck_val[sl_r, sl_c] > 0, v | mask, v & ~mask)
            return np.where(inj.fault_map[sl_r, sl_c], bad, v).astype(np.int32)

        chk_row = (px.sum(axis=0).astype(np.int64) @ pw.astype(np.int64)).astype(np.int32)
        chk_col = (px.astype(np.int64) @ pw.sum(axis=1).astype(np.int64)).astype(np.int32)
        chk_row = stuck(chk_row, 0, slice(None))
        chk_col = stuck(chk_col, slice(None), 0)
        syn_col = chk_row.astype(np.int64) - ar.sum(axis=0)
        syn_row = chk_col.astype(np.int64) - ar.sum(axis=1)
        n_flagged = int((syn_col != 0).sum() + (syn_row != 0).sum())
        if n_flagged == 0:
            return False
        self.abft_alarms += 1
        self._emit(
            "abft.alarm", site="probe", n_flagged=n_flagged,
            syndrome_max=int(max(np.abs(syn_col).max(), np.abs(syn_row).max())),
        )
        return True

    def scan_step(self) -> tuple[bool, tuple[int, int]]:
        """One batched probe step (call once per decode step): checks
        ``scan_block`` grid rows × all columns against the complementary
        ±probe pair.  Returns (block all-clean, (first row, one-past-last
        row) of the scanned block)."""
        block = self.engine.cfg.block_rows
        sweep = self.scan_state.sweep
        r0 = self.scan_state.cursor * block
        px, pw = self.injector.probe_operands(sweep, self.cfg.probe_window)
        # only the scanned block's rows are materialized and corrupted
        px_b = px[r0 : r0 + block]
        ar_b = self.injector.corrupted_probe(px_b, pw, row0=r0)
        arn_b = self.injector.corrupted_probe(px_b, -pw, row0=r0)
        # the four operands in one int32 host buffer, one copy to the device
        parts = (px_b, pw, ar_b, arn_b)
        packed = torch.from_numpy(np.concatenate([a.ravel() for a in parts]).astype(np.int32)).to(self.device)
        operands = [t.view(a.shape) for t, a in zip(packed.split([a.size for a in parts]), parts)]
        self.scan_state, flags, _ = self.engine.probe_presliced(self.scan_state, *operands)
        self.scans += 1
        if self.scan_state.sweep > sweep:
            self._emit("scan.sweep", sweep=sweep, steps=self.engine.cfg.steps_per_sweep)
        if self.cfg.abft:
            self.abft_check()
        self._sync()
        return not bool(flags.any()), (r0, r0 + block)

    def boot_scan(self, *, batched: bool = True) -> int:
        """Power-on scan: ``max_boot_sweeps`` whole-array sweeps.

        ``batched=True`` (default): the engine probes whole row-blocks on the
        device and merges detections into the FPT there.  ``batched=False``
        keeps the legacy per-PE host loop (identical probes, so an identical
        confirmed set; the reference the batched path is held to).  Returns
        #confirmed."""
        c = self.engine.cfg
        sweep0 = self.scan_state.sweep
        n_sweeps = self.cfg.max_boot_sweeps
        ops = [self.injector.probe_operands(sweep0 + s, self.cfg.probe_window)
               for s in range(n_sweeps)]
        if batched:
            fmap, sbit, sval = self.injector.truth_grids(self.device)
            px_stack = torch.from_numpy(np.stack([px for px, _ in ops])).to(self.device)
            pw_stack = torch.from_numpy(np.stack([pw for _, pw in ops])).to(self.device)
            self.scan_state, fs = self.engine.boot_scan(
                self.scan_state, self.confirmed_state, fmap, sbit, sval, px_stack, pw_stack,
            )
            self._set_confirmed(fs)
            self.scans += n_sweeps * c.steps_per_sweep
        else:
            hits = self.scan_state.hits.cpu().numpy().copy()
            for px, pw in ops:
                ar = self.injector.corrupted_probe(px, pw)
                ar_neg = self.injector.corrupted_probe(px, -pw)
                expect = (px.astype(np.int64) @ pw.astype(np.int64)).astype(np.int32)
                expect_neg = (px.astype(np.int64) @ -pw.astype(np.int64)).astype(np.int32)
                for r in range(c.rows):          # one PE per iteration, the
                    for col in range(c.cols):    # pre-ScanEngine behaviour
                        self.scans += 1
                        bad = bool(ar[r, col] != expect[r, col]) or bool(ar_neg[r, col] != expect_neg[r, col])
                        if bad and hits[r, col] < c.confirm_hits:
                            hits[r, col] += 1
            self.scan_state = ScanState(self.scan_state.cursor, sweep0 + n_sweeps,
                                        torch.from_numpy(hits).to(self.device))
        self._sync()
        self._emit("scan.boot", sweeps=n_sweeps, confirmed=self.n_confirmed)
        return self.n_confirmed

    def bist(self) -> int:
        """Built-in self test: trust the factory fault map.  Seeds the
        engine's hit counters at the confirmation threshold for every current
        truth fault — the engine stays the single source of detection
        state."""
        hits = np.maximum(
            self.scan_state.hits.cpu().numpy(),
            np.where(self.injector.fault_map, self.cfg.confirm_hits, 0),
        ).astype(np.int32)
        self.scan_state = dataclasses.replace(self.scan_state, hits=torch.from_numpy(hits).to(self.device))
        self._sync()
        self._emit("scan.bist", confirmed=self.n_confirmed)
        return self.n_confirmed
