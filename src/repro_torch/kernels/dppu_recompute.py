"""The DPPU's kernels: the scan probe and the grouped recompute, each a CUDA
kernel with its plain PyTorch twin.

``probe_check`` replaces the Pallas TPU kernel
``repro/kernels/dppu_recompute.py::probe_check`` (the AR == BAR + PR check of
paper Section IV-D over one row-block of the virtual PE array).
``csrc/probe_check.cu`` accumulates in int32, which is exactly
:func:`probe_check_ref`.  The scan step runs :func:`probe_check_pair`, the
same check of both halves of its complementary ±probe pair in one launch:
the probe is a few hundred bytes, so a launch is all it costs.

``dppu_recompute`` replaces the Pallas TPU kernel
``repro/kernels/dppu_recompute.py::dppu_recompute`` (paper Section IV-C1):
pass 2 of the two-pass pipeline.  It recomputes the (bm, bn) output tiles
named by a tile-level fault PE table, reading only each tile's x row-panel
and w column-panel (the paper's AGU).  ``csrc/dppu_recompute.cu`` runs the
main loop ``csrc/os_array_matmul.cu`` runs for the operands' dtype (for bf16
the tensor cores', on the same array-aligned pieces, so it takes the same
layouts, :func:`~repro_torch.kernels.os_array_matmul.check_tma_layout`), so
a recomputed tile equals the fault-free array's output bit for bit.  Its
partner :func:`scatter_overwrite` (the output-buffer overwrite) is plain
PyTorch.

Each wrapper launches its kernel for CUDA tensors and computes its plain
twin for CPU tensors.  ``probe_check.launches``,
``probe_check_pair.launches`` and ``dppu_recompute.launches`` count kernel
launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.engine import _int_matmul
from repro_torch.kernels import _build
from repro_torch.kernels.os_array_matmul import MAX_GRID_Y, check_blocks, check_cuda_operands, check_tma_layout


def probe_check_ref(px: torch.Tensor, pw: torch.Tensor, ar: torch.Tensor, *,
                    window: int) -> torch.Tensor:
    """Reference AR == BAR + PR mismatch check over a row-block of PEs.

    ``px``: (block, K) probe activations, ``pw``: (K, cols) probe weights,
    ``ar``: (block, cols) accumulators read back from the array.  The DPPU
    lanes recompute the partial result PR over the first ``window`` MACs and
    the before-window accumulation BAR over the rest; a PE is flagged iff
    AR != BAR + PR.  int32-exact.  Returns a (block, cols) bool mask."""
    w = min(window, px.shape[-1])
    pr = _int_matmul(px[..., :w], pw[:w])
    bar = _int_matmul(px[..., w:], pw[w:])
    return ar.to(torch.int32) != pr + bar


def probe_check_pair_ref(px: torch.Tensor, pw: torch.Tensor, ar: torch.Tensor, ar_neg: torch.Tensor, *,
                         window: int) -> torch.Tensor:
    """Plain version of :func:`probe_check_pair`: the OR of the two
    :func:`probe_check_ref` checks, ``ar`` against ``pw`` and ``ar_neg``
    against ``-pw``.  Returns a (block, cols) bool mask."""
    return probe_check_ref(px, pw, ar, window=window) | probe_check_ref(px, -pw, ar_neg, window=window)


def _probe_lib() -> ctypes.CDLL:
    lib = _build.load("probe_check")
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (("probe_check_launch", [p, p, p, p, i, i, i, p]),
                       ("probe_check_pair_launch", [p, p, p, p, p, i, i, i, p]),
                       ("empty_launch", [p])):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def _probe_operands(name: str, px: torch.Tensor, pw: torch.Tensor, *ars: torch.Tensor) -> list[torch.Tensor]:
    """The checks both probe wrappers make before a launch; returns the
    operands as contiguous int32."""
    if px.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda (kernel) or cpu (plain), got {px.device}")
    b, k = px.shape
    if pw.shape[0] != k or any(ar.shape != (b, pw.shape[1]) for ar in ars):
        raise ValueError(
            f"{name} needs px (B, K), pw (K, C) and (B, C) readbacks; got "
            f"{tuple(px.shape)}, {tuple(pw.shape)}, {[tuple(ar.shape) for ar in ars]}"
        )
    for t in (pw, *ars):
        if t.device != px.device:
            raise ValueError(f"{name} operands must share {px.device}, got {t.device}")
    return [t.to(torch.int32).contiguous() for t in (px, pw, *ars)]


def probe_check(px: torch.Tensor, pw: torch.Tensor, ar: torch.Tensor) -> torch.Tensor:
    """The scan probe in one pass over the row-block: (block, cols) int32
    mismatch flags (1 = the PE's accumulator disagrees with the recompute)."""
    if px.device.type == "cpu":
        return probe_check_ref(px, pw, ar, window=px.shape[-1]).to(torch.int32)
    px32, pw32, ar32 = _probe_operands("probe_check", px, pw, ar)
    (b, k), c = px32.shape, pw32.shape[1]
    flags = torch.empty((b, c), dtype=torch.int32, device=px.device)
    rc = _probe_lib().probe_check_launch(
        px32.data_ptr(), pw32.data_ptr(), ar32.data_ptr(), flags.data_ptr(), b, c, k,
        torch.cuda.current_stream(px.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"probe_check kernel launch failed: CUDA error {rc}")
    probe_check.launches += 1
    return flags


probe_check.launches = 0


def probe_check_pair(px: torch.Tensor, pw: torch.Tensor, ar: torch.Tensor, ar_neg: torch.Tensor) -> torch.Tensor:
    """The scan step's whole probe in one launch: ``ar`` checked against
    ``px @ pw`` and ``ar_neg`` against ``px @ (-pw)``, the complementary
    pair.  Returns (block, cols) int32 flags, 1 where either check fails."""
    if px.device.type == "cpu":
        return probe_check_pair_ref(px, pw, ar, ar_neg, window=px.shape[-1]).to(torch.int32)
    px32, pw32, ar32, arn32 = _probe_operands("probe_check_pair", px, pw, ar, ar_neg)
    (b, k), c = px32.shape, pw32.shape[1]
    flags = torch.empty((b, c), dtype=torch.int32, device=px.device)
    rc = _probe_lib().probe_check_pair_launch(
        px32.data_ptr(), pw32.data_ptr(), ar32.data_ptr(), arn32.data_ptr(), flags.data_ptr(), b, c, k,
        torch.cuda.current_stream(px.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"probe_check_pair kernel launch failed: CUDA error {rc}")
    probe_check_pair.launches += 1
    return flags


probe_check_pair.launches = 0


def empty_launch(device=None) -> None:
    """Launch a kernel that does nothing, on ``device``'s current stream: the
    card's per-launch floor, which the probe kernels are timed against."""
    rc = _probe_lib().empty_launch(torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {rc}")


# --------------------------------------------------------------------------- #
# grouped-DPPU recompute (pass 2 of the two-pass pipeline)
# --------------------------------------------------------------------------- #
def tile_panels(fpt: torch.Tensor, bm: int, bn: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(F, bm) rows and (F, bn) columns of each FPT entry's tile, padding
    (-1) clamped to tile (0, 0)."""
    t = fpt.to(device=device, dtype=torch.long).clamp_min(0)
    rows = t[:, :1] * bm + torch.arange(bm, device=device)
    cols = t[:, 1:] * bn + torch.arange(bn, device=device)
    return rows, cols


def dppu_recompute_plain(x: torch.Tensor, w: torch.Tensor, fpt: torch.Tensor, *, bm: int,
                         bn: int) -> torch.Tensor:
    """Plain PyTorch version: gather each entry's x row-panel and w
    column-panel, one f32 ``torch.bmm``.  Returns float32 (F, bm, bn)."""
    rows, cols = tile_panels(fpt, bm, bn, x.device)
    xs = x[rows].to(torch.float32)                               # (F, bm, K)
    ws = w[:, cols].permute(1, 0, 2).to(torch.float32)           # (F, K, bn)
    return torch.bmm(xs, ws)


def _dppu_lib() -> ctypes.CDLL:
    lib = _build.load("dppu_recompute")
    fn = lib.dppu_recompute_launch
    if fn.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [p, p, p, p, i, i, i, i, i64, i64, i64, i64, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def dppu_recompute(x: torch.Tensor, w: torch.Tensor, fpt: torch.Tensor, *, bm: int = 128,
                   bn: int = 128, bk: int = 128) -> torch.Tensor:
    """The (bm, bn) tiles of ``x (M, K) @ w (K, N)`` named by the tile-level
    FPT ``fpt (F, 2)`` (tile coordinates, ``-1`` padded; a padded entry
    returns tile (0, 0)).  Returns float32 (F, bm, bn)."""
    check_blocks("dppu_recompute", x, w, bm, bn, bk)
    if fpt.dim() != 2 or fpt.shape[1] != 2 or fpt.dtype.is_floating_point:
        raise ValueError(f"dppu_recompute needs an integer (F, 2) fault table, got {tuple(fpt.shape)} {fpt.dtype}")
    gm, gn = x.shape[0] // bm, w.shape[1] // bn
    host = fpt.cpu()
    if bool(((host[:, 0] >= gm) | (host[:, 1] >= gn)).any()):
        raise ValueError(f"dppu_recompute: a fault table entry lies outside the {gm} x {gn} tile grid")
    if x.device.type == "cpu":
        return dppu_recompute_plain(x, w, host, bm=bm, bn=bn)
    code = check_cuda_operands("dppu_recompute", x, w)
    if x.dtype == torch.bfloat16:
        check_tma_layout("dppu_recompute", x, w)
    # grid (F, pieces of bm, pieces of bn): 64 x 128 on the tensor cores, 128 x 128 else
    if bm // 64 + 2 > MAX_GRID_Y or bn // 128 + 2 > MAX_GRID_Y:
        raise ValueError(f"dppu_recompute takes bm up to {64 * (MAX_GRID_Y - 2)} and bn up to "
                         f"{128 * (MAX_GRID_Y - 2)}, got {(bm, bn)}")
    f = fpt.shape[0]
    out = torch.empty((f, bm, bn), dtype=torch.float32, device=x.device)
    if f == 0:
        return out
    table = host.to(torch.int32).contiguous().to(x.device)
    rc = _dppu_lib().dppu_recompute_launch(
        x.data_ptr(), w.data_ptr(), table.data_ptr(), out.data_ptr(), f, x.shape[0], w.shape[1], x.shape[1],
        x.stride(0), x.stride(1), w.stride(0), w.stride(1), code, bm, bn,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"dppu_recompute kernel launch failed: CUDA error {rc}")
    dppu_recompute.launches += 1
    return out


dppu_recompute.launches = 0


def scatter_overwrite(corrupted: torch.Tensor, tiles: torch.Tensor, fpt: torch.Tensor, *,
                      bm: int, bn: int) -> torch.Tensor:
    """Output-buffer overwrite with byte mask (paper Fig. 5 step 4): write each
    recomputed tile ``tiles (F, bm, bn)`` over the faulty PE's output region
    of ``corrupted (M, N)``; padded entries are no-ops.  One indexed write of
    all valid tiles, in place: ``corrupted`` is the output buffer, and is
    returned."""
    fpt = fpt.to(corrupted.device)
    keep = fpt[:, 0] >= 0
    rows, cols = tile_panels(fpt[keep], bm, bn, corrupted.device)
    corrupted[rows[:, :, None], cols[:, None, :]] = tiles[keep].to(corrupted.dtype)
    return corrupted
