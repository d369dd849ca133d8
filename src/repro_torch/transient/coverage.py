"""Detector-coverage campaign: fault class × detector matrix.

Which detector sees which fault class.  Three classes:

  * ``permanent``         — stuck-at PE accumulator fault;
  * ``transient_mac``     — one-shot SEU in an accumulator during one step's
    matmul (one output element's bit XORed);
  * ``transient_weight``  — SEU in stored weight memory (one weight bit
    XORed before the matmul reads it).

against three detectors, each modelled by its contract:

  * ``scan``   — the ScanEngine's ± complementary probe pair
    (:func:`repro_torch.core.scan.probe_operands`).  It sees the PE array,
    never the operands: a permanent fault is caught whenever the probes
    expose the stuck bit, a MAC transient only if the cursor was on that row
    block at upset time, a weight flip never;
  * ``verify`` — the OnlineVerifier's output-block recompute (the
    ``output_block_check`` contract, here over a per-config row window).  It
    recomputes from the operands as stored, so a weight flip is invisible;
  * ``abft``   — the checksum pair (:mod:`repro_torch.transient.abft`): the
    carried column checksum catches MAC corruption anywhere in the array,
    the encode-time weight checksum catches weight flips.

Each class is ONE batched program over a leading config axis, on the
device, with an int32 small-integer datapath so every comparison is exact.
A program is built once per (spec, class): the build computes the operands,
the clean products and the checksum lanes on the device, and every later
call only feeds it draws.  ``retraces`` in :func:`run_coverage`'s report
counts these builds (the reference counts its jit traces); a seed swap
reuses the built program, so each class reports 1.  Coverage is conditional
on manifestation: configs whose fault changed no output element are not
counted against any detector.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.campaign import binomial_halfwidth
from repro_torch.core.engine import _i32, _int_matmul, _stuck_at_i32, abft_encode
from repro_torch.core.scan import probe_operands
from repro_torch.transient.abft import abft_flags
from repro_torch.transient.seu import flip_bits

FAULT_CLASSES = ("permanent", "transient_mac", "transient_weight")
DETECTORS = ("scan", "verify", "abft")


@dataclasses.dataclass(frozen=True)
class CoverageSpec:
    """Static geometry of one coverage campaign.

    ``rows``/``cols`` — PE array; ``m``/``k``/``n`` — the probed matmul;
    ``scan_block`` — rows probed per serving step (the cursor's stride);
    ``verify_rows`` — the OnlineVerifier's per-step output row window."""

    rows: int = 8
    cols: int = 8
    m: int = 32
    k: int = 16
    n: int = 32
    n_configs: int = 64
    scan_block: int = 1
    verify_rows: int = 4
    seed: int = 0

    @property
    def n_blocks(self) -> int:
        return -(-self.rows // self.scan_block)


def _operands(spec: CoverageSpec) -> tuple[np.ndarray, np.ndarray]:
    """Small-int int32 operands (magnitudes far below 2^30, so every bit
    position is writable without overflow); the reference's numpy draws."""
    rng = np.random.default_rng(spec.seed * 7919 + 17)
    x = rng.integers(-4, 8, size=(spec.m, spec.k)).astype(np.int32)
    w = rng.integers(-4, 8, size=(spec.k, spec.n)).astype(np.int32)
    return x, w


def _colsum(x: torch.Tensor) -> torch.Tensor:
    return _i32(x.to(torch.int64).sum(dim=-2, keepdim=True))


def _verify_detects(out_f: torch.Tensor, out_clean: torch.Tensor, vr0: torch.Tensor,
                    vrows: int) -> torch.Tensor:
    """OnlineVerifier model: an exact int recompute over output rows
    [vr0, vr0 + vrows) of each config flags iff the corruption manifests
    inside the window.  The start is clamped as a dynamic slice clamps it."""
    m = out_clean.shape[-2]
    vr0 = vr0.clamp(0, max(m - vrows, 0))[:, None]
    rows = torch.arange(m, device=out_f.device)[None, :]
    in_win = (rows >= vr0) & (rows < vr0 + vrows)
    changed = (out_f != out_clean).any(dim=-1)
    return (changed & in_win).any(dim=-1)


def _abft_detects(out_f, chk_row, chk_col) -> torch.Tensor:
    col, row = abft_flags(out_f, chk_row, chk_col)
    return col.any(dim=-1) | row.any(dim=-1)


def _build_permanent(spec: CoverageSpec, x, w, wc):
    out_clean = _int_matmul(x, w)
    acc_pos = _int_matmul(_colsum(x), w)
    chk_col_clean = _int_matmul(x, wc.reshape(-1, 1))
    m, n = out_clean.shape
    mi = (torch.arange(m, device=x.device) % spec.rows)[:, None]
    ni = (torch.arange(n, device=x.device) % spec.cols)[None, :]
    # the probe accumulators: PE(i, j)'s value for the ± complementary pair
    px, pw = probe_operands(spec.rows, spec.cols, 0, window=8)
    probe = _int_matmul(torch.from_numpy(px).to(x.device), torch.from_numpy(pw).to(x.device))

    def program(r, c, bit, val, vr0):
        r3, c3, b3, v3 = (t[:, None, None] for t in (r, c, bit, val))
        hit = (mi == r3) & (ni == c3)
        out_f = torch.where(hit, _stuck_at_i32(out_clean, b3, v3), out_clean)
        manifested = (out_f != out_clean).flatten(1).any(dim=1)
        # scan: a persistent fault; the sweep reaches every block, so
        # detection hinges only on the ± probes exposing the stuck bit
        a = probe[r.long(), c.long()]
        scan = (_stuck_at_i32(a, bit, val) != a) | (_stuck_at_i32(-a, bit, val) != -a)
        verify = _verify_detects(out_f, out_clean, vr0, spec.verify_rows)
        # the lanes ride the augmented view: row M on PE row M % rows, col N
        # on PE col N % cols, corrupted by the same persistent fault
        chk_row = torch.where((m % spec.rows == r3) & (ni == c3), _stuck_at_i32(acc_pos, b3, v3), acc_pos)
        chk_col = torch.where((mi == r3) & (n % spec.cols == c3), _stuck_at_i32(chk_col_clean, b3, v3),
                              chk_col_clean)
        abft = _abft_detects(out_f, chk_row, chk_col)
        return manifested, scan & manifested, verify, abft

    return program


def _build_transient_mac(spec: CoverageSpec, x, w, wc):
    out_clean = _int_matmul(x, w)
    chk_row = _int_matmul(_colsum(x), w)
    chk_col = _int_matmul(x, wc.reshape(-1, 1))
    m, n = out_clean.shape

    def program(idx, bit, cur, vr0):
        nc = idx.shape[0]
        # one flip per config: config i's word idx[i] of its own copy
        base = torch.arange(nc, device=idx.device) * (m * n)
        out_f = flip_bits(out_clean.expand(nc, m, n), base + idx, bit)
        pe_row = (idx // n) % spec.rows
        # the probe only witnesses the upset if it was scanning that block
        # at upset time (an XOR always changes the probe accumulator)
        scan = pe_row // spec.scan_block == cur
        verify = _verify_detects(out_f, out_clean, vr0, spec.verify_rows)
        # the lane accumulated in its own PE: it stays clean and the column
        # syndrome flags the corrupted data lane
        abft = _abft_detects(out_f, chk_row.expand(nc, 1, n), chk_col.expand(nc, m, 1))
        return torch.ones(nc, dtype=torch.bool, device=idx.device), scan, verify, abft

    return program


def _build_transient_weight(spec: CoverageSpec, x, w, wc):
    out_clean = _int_matmul(x, w)
    chk_col = _int_matmul(x, wc.reshape(-1, 1))
    colsum = _colsum(x)
    k, n = w.shape
    m = out_clean.shape[0]

    def program(widx, wbit, vr0):
        nc = widx.shape[0]
        base = torch.arange(nc, device=widx.device) * (k * n)
        w_f = flip_bits(w.expand(nc, k, n), base + widx, wbit)[:, None]  # (nc, 1, k, n)
        out_f = _int_matmul(x, w_f)
        manifested = (out_f != out_clean).flatten(1).any(dim=1)
        false = torch.zeros(nc, dtype=torch.bool, device=widx.device)
        # the probes never touch model weights (scan), and the verifier
        # recomputes from the same stored, flipped weights (verify)
        chk_row = _int_matmul(colsum, w_f)
        abft = _abft_detects(out_f, chk_row, chk_col.expand(nc, m, 1))
        return manifested, false, false, abft

    return program


_PROGRAMS = {
    "permanent": _build_permanent,
    "transient_mac": _build_transient_mac,
    "transient_weight": _build_transient_weight,
}


def _draws(spec: CoverageSpec, fault_class: str, seed: int):
    rng = np.random.default_rng(seed)
    nc = spec.n_configs
    vr0 = rng.integers(0, spec.m - spec.verify_rows + 1, size=nc).astype(np.int32)
    if fault_class == "permanent":
        r = rng.integers(0, spec.rows, size=nc).astype(np.int32)
        c = rng.integers(0, spec.cols, size=nc).astype(np.int32)
        bit = rng.integers(0, 32, size=nc).astype(np.int32)
        val = rng.integers(0, 2, size=nc).astype(np.int32)
        return (r, c, bit, val, vr0)
    if fault_class == "transient_mac":
        idx = rng.integers(0, spec.m * spec.n, size=nc).astype(np.int32)
        bit = rng.integers(0, 32, size=nc).astype(np.int32)
        cur = rng.integers(0, spec.n_blocks, size=nc).astype(np.int32)
        return (idx, bit, cur, vr0)
    if fault_class == "transient_weight":
        widx = rng.integers(0, spec.k * spec.n, size=nc).astype(np.int32)
        wbit = rng.integers(0, 32, size=nc).astype(np.int32)
        return (widx, wbit, vr0)
    raise ValueError(f"unknown fault class {fault_class!r}")


def build_program(spec: CoverageSpec, fault_class: str, *, device="cuda"):
    """Build one class's batched program on ``device``: the operands, the
    encode-time checksum and every seed-independent product, held by a
    closure that maps a class's draws (int32 tensors, leading config axis)
    to (manifested, scan, verify, abft) bool tensors."""
    if fault_class not in _PROGRAMS:
        raise ValueError(f"unknown fault class {fault_class!r}")
    x, w = (torch.from_numpy(a).to(device) for a in _operands(spec))
    return _PROGRAMS[fault_class](spec, x, w, abft_encode(w))


def run_class(spec: CoverageSpec, fault_class: str, *, seed: int | None = None,
              programs: dict | None = None, device="cuda") -> dict:
    """Evaluate one fault class: per-detector coverage conditional on
    manifestation, with binomial CIs.  ``programs`` caches built programs by
    (spec, class, device): a call with another ``seed`` feeds new draws
    through the same program."""
    programs = {} if programs is None else programs
    key = (spec, fault_class, str(torch.device(device)))
    if key not in programs:
        programs[key] = build_program(spec, fault_class, device=device)
    draws = _draws(spec, fault_class, spec.seed if seed is None else seed)
    packed = torch.from_numpy(np.stack(draws)).to(device)
    manifested, scan, verify, abft = (t.cpu().numpy() for t in programs[key](*packed))
    n_corrupted = int(manifested.sum())
    per_detector = {}
    for name, hits in (("scan", scan), ("verify", verify), ("abft", abft)):
        caught = int((hits & manifested).sum())
        cov = caught / n_corrupted if n_corrupted else 0.0
        per_detector[name] = {
            "coverage": cov,
            "ci95": float(binomial_halfwidth(cov, max(n_corrupted, 1))),
            "n_detected": caught,
        }
    return {
        "fault_class": fault_class,
        "n": spec.n_configs,
        "n_corrupted": n_corrupted,
        "detectors": per_detector,
    }


def run_coverage(spec: CoverageSpec, *, device="cuda") -> dict:
    """The full fault-class × detector matrix plus the build evidence: each
    class program is run with TWO config seeds, and the second run must not
    build it again (fault configs are data).  ``retraces`` holds the builds
    of each class in this call."""
    programs: dict = {}
    classes = {}
    for fc in FAULT_CLASSES:
        classes[fc] = run_class(spec, fc, seed=spec.seed, programs=programs, device=device)
        run_class(spec, fc, seed=spec.seed + 1, programs=programs, device=device)  # no rebuild
    retraces = {fc: sum(key[1] == fc for key in programs) for fc in FAULT_CLASSES}
    matrix = [
        {
            "fault_class": fc,
            "detector": det,
            "coverage": classes[fc]["detectors"][det]["coverage"],
            "ci95": classes[fc]["detectors"][det]["ci95"],
            "n": classes[fc]["n"],
            "n_corrupted": classes[fc]["n_corrupted"],
        }
        for fc in FAULT_CLASSES
        for det in DETECTORS
    ]
    return {"matrix": matrix, "classes": classes, "retraces": retraces}
