"""Fused fault-tolerant matmul: the CUDA kernel and its plain PyTorch twins.

Replaces the Pallas TPU kernels ``repro/kernels/ft_matmul.py::ft_matmul``
and ``::ft_matmul_batched``.
One pass computes ``x @ w`` with a float32 accumulate and applies the whole
fault story — stuck-at mux for effective faults, DPPU repair (skipping the
mux), the RepairPlan's column remap and prune — as one AND/OR mask pair on
the accumulator's bit pattern, per output element: ``out[i, j]`` maps to
PE(i % rows, j % cols), the engine's element-granular placement.

On the serving path M is the decode batch, so each call is a matrix-vector
product bound by the bytes of ``w``; ``csrc/ft_matmul.cu`` says how the
kernel reads them.  It takes bf16 or f32 operands, widens them in registers,
and reads ``w`` through its strides (the LM head's ``table.T`` is never
copied).

:func:`ft_matmul_batched` is the MoE expert form, ``x (E, M, K) @ w (E, K,
N)`` in one launch: the same kernel body with the expert as a grid axis.
Each expert's matmul is one virtual-array execution, so the PE map repeats
per expert: ``out[e, i, j]`` maps to PE(i % rows, j % cols).

Each wrapper launches the kernel for CUDA tensors and raises for anything it
cannot take; for CPU tensors it computes its plain twin
(:func:`ft_matmul_ref`, :func:`ft_matmul_batched_ref`).  ``ft_matmul.launches``
and ``ft_matmul_batched.launches`` count kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.engine import apply_mask_grids
from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)


def ft_matmul_ref(x: torch.Tensor, w: torch.Tensor, and_grid: torch.Tensor,
                  or_grid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``torch.matmul`` in float32, then the same
    element-granular AND/OR epilogue.  Returns float32 (M, N).  On a card it
    is an f32 oracle only with TF32 off
    (``torch.backends.cuda.matmul.allow_tf32 = False``)."""
    return apply_mask_grids(torch.matmul(x.to(torch.float32), w.to(torch.float32)), and_grid, or_grid)


def ft_matmul_batched_ref(x: torch.Tensor, w: torch.Tensor, and_grid: torch.Tensor,
                          or_grid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`ft_matmul_batched`: a batched f32
    ``torch.matmul``, then the AND/OR epilogue broadcast over the expert axis
    with the row residue taken within each expert.  Returns float32 (E, M, N)."""
    out = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    rows = and_grid.shape[0]
    row_res = (torch.arange(out.shape[1], device=out.device) % rows)[None, :, None]
    return apply_mask_grids(out, and_grid, or_grid, row_residue=row_res)


def _lib() -> ctypes.CDLL:
    lib = _build.load("ft_matmul")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn = lib.ft_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = [p, p, p, p, p, i, i, i, i64, i64, i64, i64, i, i, i, i, p]
        fn.restype = ctypes.c_int
    fn = lib.ft_matmul_batched_launch
    if fn.argtypes is None:
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i64, i64, i64, i64, i64, i64, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def _check_operands(name: str, x: torch.Tensor, w: torch.Tensor, and_grid: torch.Tensor,
                    or_grid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The checks both wrappers make before a launch; returns the contiguous
    mask grids."""
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16 operands, got {x.dtype}, {w.dtype}")
    for t in (w, and_grid, or_grid):
        if t.device != x.device:
            raise ValueError(f"{name} operands must share {x.device}, got {t.device}")
    if and_grid.dtype != torch.int32 or or_grid.dtype != torch.int32:
        raise TypeError(f"{name} mask grids must be int32")
    if and_grid.shape != or_grid.shape or and_grid.dim() != 2:
        raise ValueError(f"{name} mask grids must be one (rows, cols) pair")
    return and_grid.contiguous(), or_grid.contiguous()


def ft_matmul(x: torch.Tensor, w: torch.Tensor, and_grid: torch.Tensor,
              or_grid: torch.Tensor) -> torch.Tensor:
    """``x (M, K) @ w (K, N)`` through the faulty virtual array; ``and_grid``
    / ``or_grid`` are the (rows, cols) int32 mask pair of
    :func:`repro_torch.core.engine.fault_mask_grids`.  Returns float32 (M, N).
    """
    if x.device.type == "cpu":
        return ft_matmul_ref(x, w, and_grid, or_grid)
    if x.device.type != "cuda":
        raise ValueError(f"ft_matmul runs on cuda (kernel) or cpu (plain), got {x.device}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"ft_matmul needs (M, K) @ (K, N), got {tuple(x.shape)} @ {tuple(w.shape)}")
    ag, og = _check_operands("ft_matmul", x, w, and_grid, or_grid)
    rows, cols = ag.shape
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    rc = _lib().ft_matmul_launch(
        x.data_ptr(), w.data_ptr(), ag.data_ptr(), og.data_ptr(), out.data_ptr(),
        m, n, k, x.stride(0), x.stride(1), w.stride(0), w.stride(1),
        int(x.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16), rows, cols,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"ft_matmul kernel launch failed: CUDA error {rc}")
    ft_matmul.launches += 1
    return out


ft_matmul.launches = 0


def ft_matmul_batched(x: torch.Tensor, w: torch.Tensor, and_grid: torch.Tensor,
                      or_grid: torch.Tensor) -> torch.Tensor:
    """``x (E, M, K) @ w (E, K, N)`` through the faulty virtual array, one
    virtual-array execution per expert, in one launch.  ``x`` and ``w`` are
    read through their strides.  Returns float32 (E, M, N)."""
    if x.device.type == "cpu":
        return ft_matmul_batched_ref(x, w, and_grid, or_grid)
    if x.device.type != "cuda":
        raise ValueError(f"ft_matmul_batched runs on cuda (kernel) or cpu (plain), got {x.device}")
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(
            f"ft_matmul_batched needs (E, M, K) @ (E, K, N), got {tuple(x.shape)} @ {tuple(w.shape)}"
        )
    if x.shape[0] > 65535:
        raise ValueError(f"ft_matmul_batched takes at most 65535 experts, got {x.shape[0]}")
    ag, og = _check_operands("ft_matmul_batched", x, w, and_grid, or_grid)
    rows, cols = ag.shape
    e, m, k = x.shape
    n = w.shape[2]
    out = torch.empty((e, m, n), dtype=torch.float32, device=x.device)
    rc = _lib().ft_matmul_batched_launch(
        x.data_ptr(), w.data_ptr(), ag.data_ptr(), og.data_ptr(), out.data_ptr(),
        e, m, n, k, *x.stride(), *w.stride(),
        int(x.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16), rows, cols,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"ft_matmul_batched kernel launch failed: CUDA error {rc}")
    ft_matmul_batched.launches += 1
    return out


ft_matmul_batched.launches = 0
