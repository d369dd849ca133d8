"""Pass 1 of the paper's two-pass pipeline: the CUDA kernel and its plain twin.

Replaces the Pallas TPU kernel ``repro/kernels/os_array_matmul.py::
os_array_matmul``: the output-stationary 2-D array's matmul with per-PE
stuck-at faults on the float32 accumulator and no repair.  Output (i, j)
belongs to PE((i // bm) % rows, (j // bn) % cols): (bm, bn) is the tile of
the fault placement, not the kernel's block, so any bm, bn >= 1 works
(bm = bn = 1 is the engine's element placement).

``bk``, in this module's and ``dppu_recompute``'s wrappers and in the entry
points of ``kernels/ops.py``, is the JAX signature's parity argument: it set
the Pallas kernels' K block, which changed only their accumulation order.
The CUDA kernels never read it (their K stage is a compile-time constant
that both share); it is kept with its divisibility check
(:func:`check_blocks`) because ``kernels/ops.py`` mirrors JAX's API and the
parity tests pass it.

``csrc/os_array_matmul.cu`` takes f32, bf16 or int8 operands (both of one
dtype).  bf16 runs on the tensor cores (TMA + wgmma, ``csrc/
array_tile_wgmma.cuh``), which read x and w through TMA descriptors: x with
unit stride along K, w with unit stride along N or, as the LM head's
``table.T``, along K (never copied), 16-byte aligned, the other strides
multiples of 16 bytes (:func:`check_tma_layout` raises on anything else).
f32 and int8 run on the CUDA cores (``csrc/array_tile.cuh``) through any
strides.  The wrapper lowers the (bit, val, faulty) grids to the AND/OR mask
pair of :func:`repro_torch.core.engine.fault_mask_grids`, which the kernel
applies to each output's bit pattern.

:func:`os_array_matmul` launches the kernel for CUDA tensors and raises for
anything it cannot take; for CPU tensors it computes
:func:`os_array_matmul_plain`.  ``os_array_matmul.launches`` counts kernel
launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.engine import META_EFF_SHIFT, META_VAL_SHIFT, apply_mask_grids, fault_mask_grids
from repro_torch.kernels import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
CTA_TILE = 128  # the kernels' block tile in N (and in M on the CUDA cores)
MAX_GRID_Y = 65535
TMA_BYTES = 16  # TMA's base alignment and stride granule


def _tile_grids(m: int, n: int, bm: int, bn: int, rows: int, cols: int, device=None):
    """(M, 1) and (1, N) PE-row / PE-column indices of every output element."""
    ti = torch.arange(m, device=device) // bm
    tj = torch.arange(n, device=device) // bn
    return (ti % rows)[:, None], (tj % cols)[None, :]


def stuck_at_mask_grids(pe_bit: torch.Tensor, pe_val: torch.Tensor,
                        pe_faulty: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The (rows, cols) int32 AND/OR mask pair of per-PE stuck-at faults:
    ``raw | (1 << bit)`` where faulty with val > 0, ``raw & ~(1 << bit)``
    where faulty with val == 0, ``raw`` elsewhere."""
    meta = (pe_bit.to(torch.int32)
            | ((pe_val > 0).to(torch.int32) << META_VAL_SHIFT)
            | ((pe_faulty != 0).to(torch.int32) << META_EFF_SHIFT))
    return fault_mask_grids(meta)


def os_array_matmul_plain(x: torch.Tensor, w: torch.Tensor, pe_bit: torch.Tensor,
                          pe_val: torch.Tensor, pe_faulty: torch.Tensor, *, bm: int,
                          bn: int) -> torch.Tensor:
    """Plain PyTorch version: ``torch.matmul`` in float32, then the
    tile-granular stuck-at masks.  Returns float32 (M, N).  On a card it is an
    f32 oracle only with TF32 off."""
    rows, cols = pe_faulty.shape
    out = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    and_g, or_g = (g.to(out.device) for g in stuck_at_mask_grids(pe_bit, pe_val, pe_faulty))
    ri, ci = _tile_grids(out.shape[0], out.shape[1], bm, bn, rows, cols, out.device)
    return apply_mask_grids(out, and_g, or_g, row_residue=ri, col_residue=ci)


def check_blocks(name: str, x: torch.Tensor, w: torch.Tensor, bm: int, bn: int, bk: int) -> None:
    """The operand checks of both passes: (M, K) @ (K, N), tiles that divide
    (``bk`` included, though the kernels do not read it)."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{name} needs (M, K) @ (K, N), got {tuple(x.shape)} @ {tuple(w.shape)}")
    (m, k), n = x.shape, w.shape[1]
    if min(bm, bn, bk) < 1 or m % bm or n % bn or k % bk:
        raise ValueError(f"{name}: (M, N, K) = {(m, n, k)} is not tiled by (bm, bn, bk) = {(bm, bn, bk)}")


def check_cuda_operands(name: str, x: torch.Tensor, w: torch.Tensor) -> int:
    """The checks both kernels make before a launch; returns the dtype code."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda (kernel) or cpu (plain), got {x.device}")
    if w.device != x.device:
        raise ValueError(f"{name} operands must share {x.device}, got {w.device}")
    if x.dtype != w.dtype or x.dtype not in DTYPE_CODES:
        raise TypeError(f"{name} takes two float32, bfloat16 or int8 operands, got {x.dtype}, {w.dtype}")
    return DTYPE_CODES[x.dtype]


def check_tma_layout(name: str, x: torch.Tensor, w: torch.Tensor) -> None:
    """The layouts the bf16 tensor-core path reads through TMA, or a
    ``ValueError`` naming the stride or base at fault: x (M, K) with unit
    stride along K; w (K, N) with unit stride along N, or along K as the
    transposed view of an (N, K) table; both bases 16-byte aligned and the
    other strides multiples of 16 bytes."""
    size = x.element_size()
    if x.stride(1) != 1:
        raise ValueError(f"{name}: bf16 x needs unit stride along K, got strides {x.stride()}")
    w_k_major = w.stride(0) == 1 and w.stride(1) != 1
    if not w_k_major and w.stride(1) != 1:
        raise ValueError(f"{name}: bf16 w needs unit stride along K or N, got strides {w.stride()}")
    for t, label, stride in ((x, "x", x.stride(0)), (w, "w", w.stride(1) if w_k_major else w.stride(0))):
        if (stride * size) % TMA_BYTES:
            raise ValueError(f"{name}: bf16 {label} stride {stride} ({stride * size} bytes) is not a "
                             f"multiple of {TMA_BYTES} bytes, as TMA needs")
        if t.data_ptr() % TMA_BYTES:
            raise ValueError(f"{name}: bf16 {label} base is not {TMA_BYTES}-byte aligned, as TMA needs")


def _lib() -> ctypes.CDLL:
    lib = _build.load("os_array_matmul")
    fn = lib.os_array_matmul_launch
    if fn.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [p, p, p, p, p, i, i, i, i64, i64, i64, i64, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def os_array_matmul(x: torch.Tensor, w: torch.Tensor, pe_bit: torch.Tensor, pe_val: torch.Tensor,
                    pe_faulty: torch.Tensor, *, bm: int = 128, bn: int = 128, bk: int = 128,
                    rows: int = 32, cols: int = 32) -> torch.Tensor:
    """``x (M, K) @ w (K, N)`` on the faulty array: every output of a PE whose
    ``pe_faulty`` is set gets its ``pe_bit`` stuck at ``pe_val`` on its f32
    bit pattern.  The grids are (rows, cols), on any device.  Returns float32
    (M, N)."""
    check_blocks("os_array_matmul", x, w, bm, bn, bk)
    for g in (pe_bit, pe_val, pe_faulty):
        if tuple(g.shape) != (rows, cols):
            raise ValueError(f"os_array_matmul fault grids must be (rows, cols) = {(rows, cols)}, got {tuple(g.shape)}")
    if x.device.type == "cpu":
        return os_array_matmul_plain(x, w, pe_bit, pe_val, pe_faulty, bm=bm, bn=bn)
    code = check_cuda_operands("os_array_matmul", x, w)
    if x.dtype == torch.bfloat16:
        check_tma_layout("os_array_matmul", x, w)
    (m, k), n = x.shape, w.shape[1]
    if -(-n // CTA_TILE) > MAX_GRID_Y:
        raise ValueError(f"os_array_matmul takes N up to {CTA_TILE * MAX_GRID_Y}, got {n}")
    and_g, or_g = (g.to(x.device).contiguous() for g in stuck_at_mask_grids(pe_bit, pe_val, pe_faulty))
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    rc = _lib().os_array_matmul_launch(
        x.data_ptr(), w.data_ptr(), and_g.data_ptr(), or_g.data_ptr(), out.data_ptr(),
        m, n, k, x.stride(0), x.stride(1), w.stride(0), w.stride(1), code, bm, bn, rows, cols,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"os_array_matmul kernel launch failed: CUDA error {rc}")
    os_array_matmul.launches += 1
    return out


os_array_matmul.launches = 0
