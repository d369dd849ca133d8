"""DPPU scan probe: the CUDA kernel and its plain PyTorch twin.

Replaces the Pallas TPU kernel ``repro/kernels/dppu_recompute.py::probe_check``
(the AR == BAR + PR check of paper Section IV-D over one row-block of the
virtual PE array).  ``csrc/probe_check.cu`` accumulates in int32, which is
exactly :func:`probe_check_ref`.  The grouped-DPPU recompute kernel
``dppu_recompute`` and its ``scatter_overwrite`` partner come with a later
slice.

:func:`probe_check` launches the kernel for CUDA tensors and computes the
plain version for CPU tensors.  ``probe_check.launches`` counts kernel
launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.engine import _int_matmul
from repro_torch.kernels import _build


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


def _lib() -> ctypes.CDLL:
    lib = _build.load("probe_check")
    fn = lib.probe_check_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def probe_check(px: torch.Tensor, pw: torch.Tensor, ar: torch.Tensor) -> torch.Tensor:
    """The scan probe in one pass over the row-block: (block, cols) int32
    mismatch flags (1 = the PE's accumulator disagrees with the recompute)."""
    if px.device.type == "cpu":
        return probe_check_ref(px, pw, ar, window=px.shape[-1]).to(torch.int32)
    if px.device.type != "cuda":
        raise ValueError(f"probe_check runs on cuda (kernel) or cpu (plain), got {px.device}")
    b, k = px.shape
    if pw.shape[0] != k or ar.shape != (b, pw.shape[1]):
        raise ValueError(
            f"probe_check needs px (B, K), pw (K, C), ar (B, C); got "
            f"{tuple(px.shape)}, {tuple(pw.shape)}, {tuple(ar.shape)}"
        )
    for t in (pw, ar):
        if t.device != px.device:
            raise ValueError(f"probe_check operands must share {px.device}, got {t.device}")
    px32, pw32, ar32 = (t.to(torch.int32).contiguous() for t in (px, pw, ar))
    c = pw32.shape[1]
    flags = torch.empty((b, c), dtype=torch.int32, device=px.device)
    rc = _lib().probe_check_launch(
        px32.data_ptr(), pw32.data_ptr(), ar32.data_ptr(), flags.data_ptr(), b, c, k,
        torch.cuda.current_stream(px.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"probe_check kernel launch failed: CUDA error {rc}")
    probe_check.launches += 1
    return flags


probe_check.launches = 0
