"""Fused fault-tolerant matmul: the CUDA kernels, their plan and their plain
PyTorch twins.

Replaces the Pallas TPU kernels ``repro/kernels/ft_matmul.py::ft_matmul``
and ``::ft_matmul_batched``.
One pass computes ``x @ w`` with a float32 accumulate and applies the whole
fault story — stuck-at mux for effective faults, DPPU repair (skipping the
mux), the RepairPlan's column remap and prune — as one AND/OR mask pair on
the accumulator's bit pattern, per output element: ``out[i, j]`` maps to
PE(i % rows, j % cols), the engine's element-granular placement.  The result
is stored as float32 (the JAX signature's dtype) or, with
``out_dtype=torch.bfloat16``, rounded to bf16 after the epilogue, which is
what the serving path works in.

On the serving path M is the decode batch, so each call is a matrix-vector
product bound by the bytes of ``w``; ``csrc/ft_matmul.cu`` says how its
kernels keep those bytes in flight.  :func:`ft_plan` is the launch plan, a
fixed function of the shape, ``w``'s dtype and ``w``'s layout
(:func:`w_layout`): never of the card or the masks, so a call's sum order is
the same on every run:

* ``n_fast`` — ``w`` row-major ``(K, N)``, 16-byte aligned: a strip
  kernel, 64-column strips, K split across a thread-block cluster of
  ``split`` ranks (1–8) whose partials rank 0 adds in rank order through
  distributed shared memory; 16-byte ``cp.async`` copies along N into a
  ring in shared memory; bf16 × bf16 multiplies on the tensor cores
  (``mma.sync``, f32 accumulate), any other dtype pair on the CUDA cores;
* ``k_fast`` — ``w`` the transposed view of a table (strides ``(1, K)``),
  16-byte aligned, as the LM head reads the tied embedding: a warp owns
  whole columns and walks each table row with 16-byte loads; no split;
* ``scalar`` — any other strides or alignment: the strip kernel with scalar
  loads through ``w``'s strides, split as ``n_fast`` is.

It takes bf16 or f32 operands and reads ``w`` through its strides (the LM
head's ``table.T`` is never copied).

:func:`ft_matmul_batched` is the MoE expert form, ``x (E, M, K) @ w (E, K,
N)`` in one launch: the same kernels with the expert as a grid axis.
Each expert's matmul is one virtual-array execution, so the PE map repeats
per expert: ``out[e, i, j]`` maps to PE(i % rows, j % cols).

Each wrapper launches its kernel once for CUDA tensors and raises for
anything it cannot take; for CPU tensors it computes its plain twin
(:func:`ft_matmul_ref`, :func:`ft_matmul_batched_ref`).  ``ft_matmul.launches``
and ``ft_matmul_batched.launches`` count kernel launches and nothing else; a
call made while a CUDA graph is captured launches nothing, so the captured
serving step (``serving/server.py::CapturedStep``) takes its calls back off
the counters and adds them on every replay.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.core.engine import apply_mask_grids
from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)

# the kernels' geometry (csrc/ft_matmul.cu)
BM = 4                  # output rows per block
STRIP = 64              # strip kernel: output columns per block
KFAST_COLS = 32         # K-fast kernel: output columns per block
KFAST_X_BYTES = 48 * 1024  # K-fast: x's (K padded to a step, 4 rows) f32 copy in shared memory
MAX_SPLIT = 8           # the portable cluster size
SPLITS = (1, 2, 4, 8)   # the cluster sizes a strip plan may take
# the split rule: the smallest power of two that gives TARGET_BLOCKS blocks,
# as long as each rank still reads at least MIN_SLICE_BYTES of w.  Measured
# on an H100 at the decode shapes (tools/ft_matmul_sweep.py, PERF.md): past
# about 64 blocks a larger cluster costs more in its sum than its shorter
# slice saves.
TARGET_BLOCKS = 64
MIN_SLICE_BYTES = 8 * 1024
LAYOUTS = ("n_fast", "k_fast", "scalar")


@dataclasses.dataclass(frozen=True)
class FTPlan:
    """How one call launches: ``layout`` (one of :data:`LAYOUTS`), ``split``
    (the cluster size along K) and ``bn`` (output columns per block)."""
    layout: str
    split: int
    bn: int


def w_layout(w: torch.Tensor) -> str:
    """Which instantiation reads ``w`` (``(K, N)``, or ``(E, K, N)``): the
    16-byte ones need a 16-byte aligned base, expert stride and row pitch and
    a whole number of 16-byte vectors along the unit-stride axis."""
    *lead, swk, swn = w.stride()
    k, n = w.shape[-2:]
    vec = 16 // w.element_size()
    aligned = w.data_ptr() % 16 == 0 and all(s % vec == 0 for s in lead)
    if aligned and swn == 1 and swk % vec == 0 and n % vec == 0:
        return "n_fast"
    step = 32 * vec  # K a warp covers per step
    if (aligned and swk == 1 and swn % vec == 0 and k % vec == 0
            and -(-k // step) * step * 4 * BM <= KFAST_X_BYTES):
        return "k_fast"
    return "scalar"


def ft_plan(e: int, m: int, n: int, k: int, dtype: torch.dtype, layout: str) -> FTPlan:
    """The launch plan of an ``(E, M, K) @ (E, K, N)`` call (``e = 1`` for
    :func:`ft_matmul`) with ``w`` of ``dtype`` in ``layout``.  A fixed rule of
    these arguments alone, so the sum order never depends on the card."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; known: {LAYOUTS}")
    if layout == "k_fast":
        return FTPlan(layout, 1, KFAST_COLS)
    elt = torch.empty((), dtype=dtype).element_size()
    base = e * -(-m // BM) * -(-n // STRIP)
    split = 1
    while (split < MAX_SPLIT and base * split < TARGET_BLOCKS
           and -(-k // (2 * split)) * STRIP * elt >= MIN_SLICE_BYTES):
        split *= 2
    return FTPlan(layout, split, STRIP)


def plan_candidates(layout: str) -> tuple[FTPlan, ...]:
    """Every plan the kernels take for ``w`` in ``layout``: a strip layout
    at each split of :data:`SPLITS`, the K-fast one at its single plan."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; known: {LAYOUTS}")
    if layout == "k_fast":
        return (FTPlan(layout, 1, KFAST_COLS),)
    return tuple(FTPlan(layout, s, STRIP) for s in SPLITS)


def validate_plan(plan: FTPlan, w: torch.Tensor) -> FTPlan:
    """``plan`` if the kernels can run it on ``w``: its layout must be
    :func:`w_layout` of ``w``, its split one of :data:`SPLITS` (1 for
    ``k_fast``) and its ``bn`` the layout's (``STRIP``, or ``KFAST_COLS`` for
    ``k_fast``); else ValueError."""
    if not isinstance(plan, FTPlan):
        raise TypeError(f"a plan is an FTPlan, got {plan!r}")
    layout = w_layout(w)
    if plan.layout != layout:
        raise ValueError(f"{plan}: w of shape {tuple(w.shape)} and strides {w.stride()} takes the "
                         f"{layout!r} layout")
    if plan not in plan_candidates(layout):
        raise ValueError(f"{plan}: the {layout!r} layout takes {plan_candidates(layout)}")
    return plan


def plan_of(x: torch.Tensor, w: torch.Tensor) -> FTPlan:
    """:func:`ft_plan` of the call ``ft_matmul(x, w)`` (2-D) or
    ``ft_matmul_batched(x, w)`` (3-D)."""
    e = x.shape[0] if x.dim() == 3 else 1
    m, k = x.shape[-2:]
    return ft_plan(e, m, w.shape[-1], k, w.dtype, w_layout(w))


def _check_out_dtype(name: str, out_dtype: torch.dtype) -> None:
    if out_dtype not in _DTYPES:
        raise TypeError(f"{name} stores float32 or bfloat16, got out_dtype={out_dtype}")


def ft_matmul_ref(x: torch.Tensor, w: torch.Tensor, and_grid: torch.Tensor,
                  or_grid: torch.Tensor, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version: ``torch.matmul`` in float32, then the same
    element-granular AND/OR epilogue, then ``.to(out_dtype)``.  Returns
    (M, N).  On a card it is an f32 oracle only with TF32 off
    (``torch.backends.cuda.matmul.allow_tf32 = False``)."""
    out = apply_mask_grids(torch.matmul(x.to(torch.float32), w.to(torch.float32)), and_grid, or_grid)
    return out.to(out_dtype)


def ft_matmul_batched_ref(x: torch.Tensor, w: torch.Tensor, and_grid: torch.Tensor,
                          or_grid: torch.Tensor, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of :func:`ft_matmul_batched`: a batched f32
    ``torch.matmul``, then the AND/OR epilogue broadcast over the expert axis
    with the row residue taken within each expert, then ``.to(out_dtype)``.
    Returns (E, M, N)."""
    out = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    rows = and_grid.shape[0]
    row_res = (torch.arange(out.shape[1], device=out.device) % rows)[None, :, None]
    return apply_mask_grids(out, and_grid, or_grid, row_residue=row_res).to(out_dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("ft_matmul")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn = lib.ft_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = [p, p, p, p, p, i, i, i, i64, i64, i64, i64, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    fn = lib.ft_matmul_batched_launch
    if fn.argtypes is None:
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i64, i64, i64, i64, i64, i64, i, i, i, i, i, i, i, i, p]
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
              or_grid: torch.Tensor, out_dtype: torch.dtype = torch.float32,
              plan: FTPlan | None = None) -> torch.Tensor:
    """``x (M, K) @ w (K, N)`` through the faulty virtual array; ``and_grid``
    / ``or_grid`` are the (rows, cols) int32 mask pair of
    :func:`repro_torch.core.engine.fault_mask_grids`.  Returns (M, N) of
    ``out_dtype`` (float32 or bfloat16, rounded after the epilogue).
    ``plan``: None launches :func:`plan_of`'s; an explicit plan (the
    autotuner's, ``kernels/autotune.py``) is checked by :func:`validate_plan`
    first.  A split changes the order of the K sum, so another plan's float
    output may differ from ``plan_of``'s in its last bits."""
    _check_out_dtype("ft_matmul", out_dtype)
    if plan is not None:
        validate_plan(plan, w)
    if x.device.type == "cpu":
        return ft_matmul_ref(x, w, and_grid, or_grid, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"ft_matmul runs on cuda (kernel) or cpu (plain), got {x.device}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"ft_matmul needs (M, K) @ (K, N), got {tuple(x.shape)} @ {tuple(w.shape)}")
    ag, og = _check_operands("ft_matmul", x, w, and_grid, or_grid)
    rows, cols = ag.shape
    m, k = x.shape
    n = w.shape[1]
    plan = plan_of(x, w) if plan is None else plan
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    rc = _lib().ft_matmul_launch(
        x.data_ptr(), w.data_ptr(), ag.data_ptr(), og.data_ptr(), out.data_ptr(),
        m, n, k, x.stride(0), x.stride(1), w.stride(0), w.stride(1),
        int(x.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16), rows, cols,
        LAYOUTS.index(plan.layout), plan.split, plan.bn, int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"ft_matmul kernel launch failed: CUDA error {rc} ({plan})")
    ft_matmul.launches += 1
    return out


ft_matmul.launches = 0


def ft_matmul_batched(x: torch.Tensor, w: torch.Tensor, and_grid: torch.Tensor,
                      or_grid: torch.Tensor, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x (E, M, K) @ w (E, K, N)`` through the faulty virtual array, one
    virtual-array execution per expert, in one launch.  ``x`` and ``w`` are
    read through their strides.  Returns (E, M, N) of ``out_dtype``."""
    _check_out_dtype("ft_matmul_batched", out_dtype)
    if x.device.type == "cpu":
        return ft_matmul_batched_ref(x, w, and_grid, or_grid, out_dtype)
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
    plan = plan_of(x, w)
    out = torch.empty((e, m, n), dtype=out_dtype, device=x.device)
    rc = _lib().ft_matmul_batched_launch(
        x.data_ptr(), w.data_ptr(), ag.data_ptr(), og.data_ptr(), out.data_ptr(),
        e, m, n, k, *x.stride(), *w.stride(),
        int(x.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16), rows, cols,
        LAYOUTS.index(plan.layout), plan.split, plan.bn, int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"ft_matmul_batched kernel launch failed: CUDA error {rc} ({plan})")
    ft_matmul_batched.launches += 1
    return out


ft_matmul_batched.launches = 0
