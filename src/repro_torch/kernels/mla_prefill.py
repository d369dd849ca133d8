"""The MLA prefill attention core: a CUDA kernel and its plain PyTorch
version.

It replaces no TPU kernel: the JAX package left MLA attention to XLA
(``src/repro/models/attention.py``), outside any Pallas kernel.  It was added
because the port's plain core, f32 passes on the CUDA cores over each query
block's keys, held 61.5% of the device time of the DeepSeek-V3 prefill on an
H100, at 1.5% of its bound (``PERF.md``).

:func:`mla_prefill` computes, for every head of a batch of causal sequences,
``softmax(q k^T * scale) v`` with ``q = (q_nope, q_rope)`` per head and
``k = (k_nope, k_rope)``, the rope key shared by every head: the core of
:func:`~repro_torch.models.attention.mla_forward`, from the keys and values
that ``wkv_b`` expanded to the heads' output.

Its bound, per layer: ``B H S(S+1)/2 * 2 (dn + dr + dv)`` operations at the
bf16 peak against q, k, v read once and the output written once at the HBM
peak.  At DeepSeek-V3's widths (dn, dr, dv = 128, 64, 128; 128 heads) the
operations are the bound from S = 2048 on and about equal the bytes at
S = 1024 (0.174 against 0.180 ms for 4 × 1024); at MiniCPM3's (64, 32, 64;
40 heads; 4 × 512) the bytes are.  What the design does about it
(``csrc/mla_prefill.cu``): one launch a layer, bf16 operands on the tensor
cores (``wgmma``) fed by TMA, the causal half never loaded, the scores and
the softmax kept in registers (an online softmax in f32, P rounded to bf16
as the P·V operand, as FlashAttention-3 does), k_nope and V read in place
from the ``wkv_b`` output and the rope key as extra key columns of the same
tile.  The one rounding the plain version has not is P's to bf16.  f32
operands, the exact configurations', take the kernel's f32 instance: the same
core in f32 arithmetic on the CUDA cores, at any widths up to
:data:`F32_MAX_D` (no cell runs it).

:func:`mla_prefill` is where the core's path is chosen: CPU tensors and
DTensors compute :func:`mla_prefill_ref` (and ``meta`` tensors its shapes);
CUDA tensors launch the kernel or raise.  ``mla_prefill.launches`` counts
kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.dist.sharding import einsum, is_dtensor
from repro_torch.kernels import _build

# (dn, dr, dv): the bf16 kernel's template instances, DeepSeek-V3's and MiniCPM3's
LAYOUTS = ((128, 64, 128), (64, 32, 64))
# the f32 instance's widest dn + dr and dv
F32_MAX_D = 256


def mla_prefill_ref(q_nope: torch.Tensor, q_rope: torch.Tensor, k_nope: torch.Tensor, k_rope: torch.Tensor,
                    v: torch.Tensor, scale: float, q_block: int = 512) -> torch.Tensor:
    """Plain PyTorch version: q_nope (B,S,H,dn), q_rope (B,S,H,dr), k_nope
    (B,S,H,dn), k_rope (B,S,dr), v (B,S,H,dv) -> (B,S,H,dv) in v's dtype.

    Query blocks of ``q_block`` rows in a Python loop, each block's scores
    (the nope and rope parts summed) masked causally to -1e30, softmax and
    weighted sum in f32, over the keys up to the block's last row (the rest
    have weight exactly 0); on DTensors each block reads the whole panel, as
    a slice of a sharded sequence would gather it."""
    b, s = q_nope.shape[:2]
    qb = min(q_block, s)
    if s % qb:
        raise ValueError(f"sequence length {s} is not a multiple of the query block {qb}")
    dev = q_nope.device
    k_nope32, v32 = k_nope.to(torch.float32), v.to(torch.float32)
    k_rope32 = k_rope.to(torch.float32)
    kpos = torch.arange(s, device=dev)
    neg = torch.full((), -1e30, device=dev)
    outs = []
    for blk in range(s // qb):
        rows = slice(blk * qb, (blk + 1) * qb)
        keys = slice(0, s if is_dtensor(q_nope) else (blk + 1) * qb)
        qpos = blk * qb + torch.arange(qb, device=dev)
        sc = (einsum("bqhd,bshd->bqhs", q_nope[:, rows].to(torch.float32), k_nope32[:, keys])
              + einsum("bqhd,bsd->bqhs", q_rope[:, rows].to(torch.float32), k_rope32[:, keys])) * scale
        mask = kpos[None, keys] <= qpos[:, None]
        sc = torch.where(mask[None, :, None, :], sc, neg)
        wts = torch.softmax(sc, dim=-1)
        outs.append(einsum("bqhs,bshd->bqhd", wts, v32[:, keys]).to(v.dtype))
    return torch.cat(outs, dim=1)


def check_operands(q_nope: torch.Tensor, q_rope: torch.Tensor, k_nope: torch.Tensor, k_rope: torch.Tensor,
                   v: torch.Tensor) -> tuple[int, int, int]:
    """The checks the kernel's launch needs, on any device: one dtype, bf16
    or f32, and unit stride along the last dim; for bf16 the shapes of one
    MLA layout of :data:`LAYOUTS`, every other stride a whole number of 16
    bytes (TMA) and 16-byte aligned bases; for f32 dn + dr and dv up to
    :data:`F32_MAX_D`; and no autograd record (the kernel has no backward).
    Returns (dn, dr, dv); raises TypeError or ValueError, and RuntimeError
    where autograd would record."""
    ops = {"q_nope": q_nope, "q_rope": q_rope, "k_nope": k_nope, "k_rope": k_rope, "v": v}
    dtype = q_nope.dtype
    for name, t in ops.items():
        if t.dtype not in (torch.bfloat16, torch.float32) or t.dtype != dtype:
            raise TypeError(f"mla_prefill takes bfloat16 or float32 operands of one dtype, got {name} of {t.dtype} "
                            f"beside q_nope of {dtype}")
        if t.device != q_nope.device:
            raise ValueError(f"mla_prefill operands must share {q_nope.device}, got {name} on {t.device}")
    if q_nope.dim() != 4 or q_rope.dim() != 4 or k_nope.dim() != 4 or v.dim() != 4 or k_rope.dim() != 3:
        raise ValueError("mla_prefill takes q_nope, q_rope, k_nope, v of (B, S, H, d) and k_rope of (B, S, dr)")
    b, s, h, dn = q_nope.shape
    dr, dv = q_rope.shape[-1], v.shape[-1]
    want = {"q_rope": (b, s, h, dr), "k_nope": (b, s, h, dn), "k_rope": (b, s, dr), "v": (b, s, h, dv)}
    for name, shape in want.items():
        if tuple(ops[name].shape) != shape:
            raise ValueError(f"mla_prefill: {name} is {tuple(ops[name].shape)}, q_nope {tuple(q_nope.shape)} "
                             f"wants {shape}")
    tma = dtype == torch.bfloat16  # the bf16 instances read through TMA
    if not tma and (dn + dr > F32_MAX_D or dv > F32_MAX_D):
        raise ValueError(f"mla_prefill in float32 takes dn + dr and dv up to {F32_MAX_D}, got {(dn, dr, dv)}")
    if tma and (dn, dr, dv) not in LAYOUTS:
        raise ValueError(f"mla_prefill takes the (dn, dr, dv) layouts {LAYOUTS} in bfloat16, got {(dn, dr, dv)}")
    for name, t in ops.items():
        if t.stride(-1) != 1 or tma and (any(st % 8 for st in t.stride()[:-1]) or t.data_ptr() % 16):
            raise ValueError(f"mla_prefill: {name} needs unit stride along its last dim and, in bfloat16, every "
                             f"other stride a multiple of 8 elements and a 16-byte aligned base, got strides "
                             f"{t.stride()}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops.values()):
        raise RuntimeError("mla_prefill has no backward: call it under torch.no_grad()")
    return dn, dr, dv


def _lib() -> ctypes.CDLL:
    lib = _build.load("mla_prefill")
    for fn in (lib.mla_prefill_launch, lib.mla_prefill_f32_launch):
        if fn.argtypes is None:
            p, i = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p, ctypes.c_float, p]
            fn.restype = ctypes.c_int
    return lib


def mla_prefill(q_nope: torch.Tensor, q_rope: torch.Tensor, k_nope: torch.Tensor, k_rope: torch.Tensor,
                v: torch.Tensor, scale: float, q_block: int = 512) -> torch.Tensor:
    """The causal MLA core: q_nope (B,S,H,dn), q_rope (B,S,H,dr), k_nope
    (B,S,H,dn), k_rope (B,S,dr), v (B,S,H,dv) -> (B,S,H,dv) in the operands'
    dtype.  ``scale`` multiplies the scores before the softmax.  CUDA
    tensors take one kernel launch, bf16 on the tensor cores or f32 on the
    CUDA cores, reading the operands through their strides (k_nope and v as
    views of one ``wkv_b`` output), or raise: :func:`check_operands` says
    what the kernel takes.  DTensors and tensors off the card (the CPU, and
    ``meta`` for shapes alone) compute :func:`mla_prefill_ref` in query
    blocks of ``q_block`` rows."""
    if q_nope.device.type != "cuda" or is_dtensor(q_nope):
        return mla_prefill_ref(q_nope, q_rope, k_nope, k_rope, v, scale, q_block=q_block)
    dn, dr, dv = check_operands(q_nope, q_rope, k_nope, k_rope, v)
    b, s, h, _ = q_nope.shape
    out = torch.empty((b, s, h, dv), dtype=q_nope.dtype, device=q_nope.device)
    strides = (ctypes.c_longlong * 14)(*q_nope.stride()[:3], *q_rope.stride()[:3], *k_nope.stride()[:3],
                                       *v.stride()[:3], *k_rope.stride()[:2])
    lib = _lib()
    launch = lib.mla_prefill_launch if q_nope.dtype == torch.bfloat16 else lib.mla_prefill_f32_launch
    rc = launch(
        q_nope.data_ptr(), q_rope.data_ptr(), k_nope.data_ptr(), k_rope.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, h, dn, dr, dv, ctypes.cast(strides, ctypes.c_void_p), float(scale),
        torch.cuda.current_stream(q_nope.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"mla_prefill kernel launch failed: CUDA error {rc}")
    mla_prefill.launches += 1
    return out


mla_prefill.launches = 0
