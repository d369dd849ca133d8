"""Fused fault-tolerant matmul: the CUDA kernel and its plain PyTorch twin.

Replaces the Pallas TPU kernel ``repro/kernels/ft_matmul.py::ft_matmul``.
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

:func:`ft_matmul` launches the kernel for CUDA tensors and raises for
anything it cannot take; for CPU tensors it computes :func:`ft_matmul_ref`.
``ft_matmul.launches`` counts kernel launches and nothing else.
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


def _lib() -> ctypes.CDLL:
    lib = _build.load("ft_matmul")
    fn = lib.ft_matmul_launch
    if fn.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [p, p, p, p, p, i, i, i, i64, i64, i64, i64, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


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
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"ft_matmul takes float32 or bfloat16 operands, got {x.dtype}, {w.dtype}")
    for t in (w, and_grid, or_grid):
        if t.device != x.device:
            raise ValueError(f"ft_matmul operands must share {x.device}, got {t.device}")
    if and_grid.dtype != torch.int32 or or_grid.dtype != torch.int32:
        raise TypeError("ft_matmul mask grids must be int32")
    if and_grid.shape != or_grid.shape or and_grid.dim() != 2:
        raise ValueError("ft_matmul mask grids must be one (rows, cols) pair")
    ag, og = and_grid.contiguous(), or_grid.contiguous()
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
