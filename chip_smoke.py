"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:

  1. device   — require CUDA; print the card's name and power limit;
  2. build    — compile every kernel under src/repro_torch/csrc with nvcc,
     one nvcc per source in parallel, and print each kernel's registers,
     shared memory and spill bytes as nvcc -Xptxas -v reported them;
  3. ft_matmul against ft_matmul_ref at every shape of the decode steps of
     every served model (M = 4; whisper's cross-attention K/V at M = 6000;
     each distinct shape once) plus ragged ones (M = 3 and
     37, a 66-byte row pitch that takes the scalar instantiation, a
     transposed table at a K that ends inside a step), bf16 and f32, on an
     8x8 array with stuck-at-0/1 faults (bits 30 and 31 included), a remap
     and a prune mask: bitwise on integer-valued operands and on f32
     operands that bf16 cannot hold, within a stated tolerance of the plain
     version and of an f64 product on random operands; the same call twice
     gives the same bits, and the kernel's bf16 store is bitwise its f32
     output cast to bf16; each shape's plan (instantiation, cluster split,
     strip width) is printed; then an f32 x against a bf16 w, RWKV6's decay
     LoRA call (w_b), at 4 x 64 -> 4096 and 2048 x 64 -> 4096, the same way
     (bitwise on an f32 x that bf16 cannot hold);
  4. ft_matmul_batched against ft_matmul_batched_ref in the same way, at the
     granite expert shapes (48 experts x 4 rows, 1536->512 and 512->1536)
     and ragged ones (5x3x1000->1000, M = 37, a 66-byte row pitch), with x
     read as the strided view of the (b, e, c, d) dispatch layout that the
     MoE path hands it;
  5. probe_check against probe_check_ref over every row-block, ± probes,
     with and without faults; probe_check_pair (the scan step's one launch
     for both halves of the pair) against probe_check_pair_ref on the same
     row-blocks and on random small and full-range int32 operands with
     stuck-at faults on bits 0, 15, 30 and 31, one launch a call;
  6. each served model at full width (random weights from a seed), through
     the decode step captured as one CUDA graph (the main path): off,
     protected with 3 BIST faults and a fourth that appears at step 2 on a
     PE row a 4-slot step never reaches (every step's logits and the tokens
     must equal off; the scan must confirm it), unprotected with a stuck-at-1
     on bit 30 of PE(0, 0) and another fault at step 2 (logits must differ);
     each run must capture once and replay every later step, swap its fault
     state after the capture without a recapture (protected, unprotected),
     and launch every kernel of its path the stated number of times per
     decode step (qwen: ft_matmul 169; granite: ft_matmul 161,
     ft_matmul_batched 96) and probe_check_pair once per protected step,
     counted by the wrappers, a replay adding what its capture recorded;
     each mode again through the eager step, which must give every step's
     logits and every token bit for bit and the same launch counts;
     serve_remap: repair="remap", six faults (REMAP_FAULTS) that appear at
     step 2 and a BIST confirms there, two past the DPPU: one repair.plan
     event after the capture, 4 effective slots and quality 0.75 at every
     step, the plan swapped into the captured step (grids rewritten at the
     same addresses), captured equal to eager bit for bit, the launches per
     step of the main path, one ft_matmul call on the live grids whose
     pruned outputs are exactly +0, the ms and device ops of a plan swap;
     and repair="none" on the same faults, which retires two columns;
     serve_counters: the protected run with counters and series on, bit
     for bit the counters-off run, protected_calls equal to the launches
     (a batched launch is one array execution per expert), one series row
     a step, the step ms on and off in turns and the device kernels, copies
     and syncs a replayed step adds; plus the model's smoke config on the
     card against the same server on the CPU, unprotected and remap;
  7. times, per model: per kernel and shape, the call the serving path
     makes (bf16 operands, the kernel's bf16 store) with its plan, its plain
     version, one PyTorch call of the same bf16 product (device times from
     the profiler, per-call times from CUDA events), the bound (2-byte
     output) and the achieved TFLOP/s; the probe kernels beside an empty
     kernel (the launch floor); the decode-step time and tokens/s; a profile
     of eager and of replayed protected steps: step ms, device busy share,
     host launch calls and device kernels a step, each csrc kernel's device
     launches a step (for the replayed steps exactly 169, or 161 + 96, and
     1 pair probe), the casts (aten::_to_copy) a step, and fused bf16
     FTContext.matmul calls held to one kernel each and no cast; the
     protected trace 3 times with the eager and the captured step in turns
     (median step ms, tokens/s, capture seconds, graph pool bytes).
     qwen1.5-0.5b is served, timed and freed before granite-moe-3b-a800m is
     built;
  8. the paper's two-pass pipeline (kernels/ops.py), run on qwen1.5-0.5b's
     full-width weights before they are freed: layer 0's q, up and down
     matrices and the tied head's table.T, at M = 4096 tokens, on the
     paper's 32x32 array with a DPPU of 32 and (bm, bn, bk) = 128.
     os_array_matmul and dppu_recompute against their plain versions bit
     for bit on integer-valued bf16, f32 and int8 operands (placement tiles
     (1, 1) and (128, 256) too), and within RAND_TOL on the weights; the
     twopass with 24 faults bitwise equal to the fault-free array, with 40
     faults differing in exactly the tiles of the 8 PEs the DPPU cannot
     repair; the fused single pass bitwise equal to the twopass; 1
     os_array_matmul + 1 dppu_recompute launch per twopass call with faults,
     1 with none; per shape the kernels' times and TFLOP/s beside bound,
     plain and library.  bf16 runs both kernels on the tensor cores (TMA +
     wgmma), f32 and int8 on the CUDA cores;
  9. the transients slice, on qwen1.5-0.5b before it is freed:
     abft_lanes — FTContext.abft_matmul under fused on layer 0's q, up and
     down and the head's table.T at M = 4 (f32 masters, then bf16): out
     bitwise FTContext.matmul's with one ft_matmul launch a call, the
     checksum lanes within ABFT_TOL of the same call on the CPU; at f32 no
     flag fault-free or with four faults the DPPU repairs, chk_row flags the
     faulty column class of an unprotected stuck-at, chk_col flags every
     row after a weight bit flipped after encoding; at bf16 the flag counts
     are printed; serve_abft — the captured protected server with the ABFT
     canary and a fault appearing at step 2: tokens and every step's logits
     bitwise the canary-off run's, one capture, 169 ft_matmul and 1
     probe_check_pair a step, no alarm before step 2, the first alarm
     against the scan's suspect and confirm steps, step ms with the canary
     on and off in turns; coverage — run_coverage at the detector-coverage
     benchmark's spec (256 configs, seed 7) on the card: counts equal to the
     CPU run's, the benchmark's five claims, one build a class, each class's
     seconds; verify — OnlineVerifier.check_block over one sweep of an
     unprotected ft_matmul output at qwen's up shape flags exactly the
     faulty PE, nothing fault-free, and scan_array on the paper's 32 x 32
     array has no false positive or negative.
  10. the training and prefill slice.  prefill_kernels: ft_matmul and
     ft_matmul_batched against their plain versions at the fused prefill's
     shapes (M = 2048; the experts 48 x 512 rows), as in 3 and 4.  On
     qwen1.5-0.5b before it is freed: serve_retrain — repair="retrain" with
     the six faults of serve_remap at step 2, where the hook plans the remap
     and fine-tunes this server's f32 masters (4 steps, twopass) and its
     step recaptures once over its own working copies: 4 slots, quality
     0.75, captured equal to eager bit for bit, the main path's launches a
     step, the retrain seconds, and a sibling on the same bundle serving
     the protected scenario bitwise as before with one capture;
     train_step — launch/train.py's step at the reference CLI's defaults
     (batch 8, seq 128, 2 microbatches, lr 1e-3, 4 seeded faults on the
     32 x 32 array, twopass, remat on), in deterministic mode with TF32
     off: 5 steps with finite losses and gnorm > 0, the params after 2
     steps bitwise those with an empty fault table, different unprotected,
     every frozen leaf bit for bit under a grad mask of ("ffn",), a fused
     train step refused (C5), the step ms, peak memory and device busy
     share; checkpoint — that state after 2 steps saved (one .npy a leaf,
     sha256 digests) and restored bit for bit, 2 more steps from it bitwise
     the straight run's 4, a tampered checkpoint re-fetched from a pristine
     copy and then refused without one, with memory_fault_records of both.
     Each model at the end: prefill_fused — forward(last_only=True) on 4 x
     512 tokens under fused: off, protected with the 3 BIST faults (bitwise
     off), unprotected (differs), twopass within TWOPASS_PREFILL_TOL of
     fused; ft_matmul 169 (granite 161, ft_matmul_batched 96) launches a
     prefill, counted from 0 just before the protected prefill; the
     prefill's ms and per prefill shape the kernels' times beside the
     library call and the bound.
  11. the attention families, each at full width after granite-moe-3b-a800m
     is freed and freed before the next: granite-8b (llama-style, untied
     head), starcoder2-3b (LayerNorm, non-gated GELU FFN, QKV bias),
     minicpm3-4b (MLA), llava-next-mistral-7b (vlm) and whisper-tiny
     (encdec, served over a zero encoder output as the reference serves it).
     The decode step's call ledger, recorded on the meta device, equals
     DECODE_SHAPES (ft_matmul a step: 253, 181, 435, 225, 41); then the
     modes of 6 through the captured step and the eager one, with the same
     checks (launches a step, one capture, captured equal to eager bit for
     bit, protected equal to off at every step, unprotected different).
     whisper's cross-attention K/V (M = 4 x 1500 rows) reaches every PE
     row, so its protected fault of step 2 is confirmed by a BIST at step 2
     rather than by the scan; the others keep the scan.  The kernel times
     a decode step against the library call and the bound, the captured
     step's ms and tokens/s.  minicpm3-4b (4 x 512 tokens: wkv_b on the
     array), llava (1 x 3072 tokens and 2880 patches through mm.proj) and
     whisper (4 x 448 tokens over 4 x 1500 frames through the encoder): the
     fused prefill off, protected (bitwise off) and unprotected (differs),
     ft_matmul launching the forward's ledger count.  Phase 3 holds
     ft_matmul to its plain version at each of these models' decode shapes
     (N = 288, K = 384, the 73472- and 51968-wide heads, whisper's M = 6000
     call).
  12. the recurrent families, after the attention families and in the same
     way (family_server_phase, timing_phase, prefill_phase, one bundle at a
     time): rwkv6-7b (32 RWKV6 layers, d 4096, untied 65536-wide head; the
     WKV recurrence stays off the array, its state S, x_tm, x_cm written in
     place by the captured step; ft_matmul 321 a step, w_b with an f32 x)
     and zamba2-1.2b (38 Mamba2 layers, the shared attention + FFN block
     after each of 7 groups, all protected whatever the layer fraction; the
     SSD state written in place; ft_matmul 126 a step), each at full width:
     the three modes captured and eager (captured equal to eager and
     protected to off bit for bit, unprotected different), the kernel times
     a decode step, and the fused prefill of 4 x 512 tokens.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int32: 67e12}
L2_BYTES = 50 * 2**20

ROWS = COLS = 8
QWEN, GRANITE = "qwen1.5-0.5b", "granite-moe-3b-a800m"
# the attention families, served after the two models above
GRANITE8B, STARCODER2, MINICPM3 = "granite-8b", "starcoder2-3b", "minicpm3-4b"
LLAVA, WHISPER = "llava-next-mistral-7b", "whisper-tiny"
# the recurrent families, served after the attention families
RWKV6, ZAMBA2 = "rwkv6-7b", "zamba2-1.2b"
FAMILIES = (GRANITE8B, STARCODER2, MINICPM3, LLAVA, WHISPER, RWKV6, ZAMBA2)
# (name, M, K, N, launches per decode step) of each model's ft_matmul calls
DECODE_SHAPES = {
    QWEN: (
        ("qkv_1024x1024", 4, 1024, 1024, 24 * 3),
        ("out_1024x1024", 4, 1024, 1024, 24),
        ("up_gate_1024x2816", 4, 1024, 2816, 24 * 2),
        ("down_2816x1024", 4, 2816, 1024, 24),
        ("head_1024x152064", 4, 1024, 152064, 1),
    ),
    GRANITE: (
        ("q_out_1536x1536", 4, 1536, 1536, 32 * 2),
        ("kv_1536x512", 4, 1536, 512, 32 * 2),
        ("router_1536x48", 4, 1536, 48, 32),
        ("head_1536x49408", 4, 1536, 49408, 1),
    ),
    GRANITE8B: (  # llama-style, untied lm_head
        ("q_out_4096x4096", 4, 4096, 4096, 36 * 2),
        ("kv_4096x1024", 4, 4096, 1024, 36 * 2),
        ("gate_up_4096x14336", 4, 4096, 14336, 36 * 2),
        ("down_14336x4096", 4, 14336, 4096, 36),
        ("head_4096x49152", 4, 4096, 49152, 1),
    ),
    STARCODER2: (  # non-gated FFN, tied
        ("q_out_3072x3072", 4, 3072, 3072, 30 * 2),
        ("kv_3072x256", 4, 3072, 256, 30 * 2),
        ("up_3072x12288", 4, 3072, 12288, 30),
        ("down_12288x3072", 4, 12288, 3072, 30),
        ("head_3072x49152", 4, 3072, 49152, 1),
    ),
    MINICPM3: (  # MLA: the q LoRA pair, wkv_a (kv_lora + d_rope = 288), wo
        ("wq_a_2560x768", 4, 2560, 768, 62),
        ("wq_b_768x3840", 4, 768, 3840, 62),
        ("wkv_a_2560x288", 4, 2560, 288, 62),
        ("wo_2560x2560", 4, 2560, 2560, 62),
        ("gate_up_2560x6400", 4, 2560, 6400, 62 * 2),
        ("down_6400x2560", 4, 6400, 2560, 62),
        ("head_2560x73472", 4, 2560, 73472, 1),
    ),
    LLAVA: (  # the mistral backbone, untied lm_head
        ("q_out_4096x4096", 4, 4096, 4096, 32 * 2),
        ("kv_4096x1024", 4, 4096, 1024, 32 * 2),
        ("gate_up_4096x14336", 4, 4096, 14336, 32 * 2),
        ("down_14336x4096", 4, 14336, 4096, 32),
        ("head_4096x32000", 4, 4096, 32000, 1),
    ),
    WHISPER: (  # self q/k/v/o, cross q/o; cross k/v over 4 x 1500 encoder frames
        ("qkvo_384x384", 4, 384, 384, 4 * 6),
        ("cross_kv_6000x384x384", 6000, 384, 384, 4 * 2),
        ("up_384x1536", 4, 384, 1536, 4),
        ("down_1536x384", 4, 1536, 384, 4),
        ("head_384x51968", 4, 384, 51968, 1),
    ),
    RWKV6: (  # r/k/v/g/o and ffr; the decay LoRA pair, w_b with f32 x; ffk/ffv; untied head
        ("rkvgo_ffr_4096x4096", 4, 4096, 4096, 32 * 6),
        ("w_a_4096x64", 4, 4096, 64, 32),
        ("w_b_64x4096", 4, 64, 4096, 32),
        ("ffk_4096x14336", 4, 4096, 14336, 32),
        ("ffv_14336x4096", 4, 14336, 4096, 32),
        ("head_4096x65536", 4, 4096, 65536, 1),
    ),
    ZAMBA2: (  # 38 mamba layers; the shared attention + FFN block after each of 7 groups; tied head
        ("in_proj_2048x8384", 4, 2048, 8384, 38),
        ("out_proj_4096x2048", 4, 4096, 2048, 38),
        ("qkvo_2048x2048", 4, 2048, 2048, 7 * 4),
        ("gate_up_2048x8192", 4, 2048, 8192, 7 * 2),
        ("down_8192x2048", 4, 8192, 2048, 7),
        ("head_2048x32000", 4, 2048, 32000, 1),
    ),
}
# the shapes whose x is float32 against a bf16 w: RWKV6's decay LoRA feeds
# its f32 tanh to w_b; the call runs the CUDA-core instantiation and stores f32
F32_X_SHAPES = ("w_b_64x4096", "w_b_2048x64x4096")
# (name, E, M, K, N, launches per decode step) of ft_matmul_batched
EXPERT_SHAPES = {
    **{arch: () for arch in FAMILIES},
    QWEN: (),
    GRANITE: (
        ("gate_up_48x1536x512", 48, 4, 1536, 512, 32 * 2),
        ("down_48x512x1536", 48, 4, 512, 1536, 32),
    ),
}
# shapes beside the main path's: ragged M, N and K; M = 37 (ten row tiles);
# a row pitch that 16-byte loads cannot read (33 bf16 = 66 bytes: the scalar
# instantiation); a transposed table (the K-fast kernel) at a K that ends
# inside its last step
EXTRA_SHAPES = (
    ("ragged_3x1000x1000", 3, 1000, 1000),
    ("m37_37x1024x1024", 37, 1024, 1024),
    ("unaligned_5x70x33", 5, 70, 33),
    ("head_ragged_4x1000x3000", 4, 1000, 3000),
)
EXTRA_EXPERT_SHAPES = (
    ("ragged_5x3x1000x1000", 5, 3, 1000, 1000),
    ("m37_4x37x512x256", 4, 37, 512, 256),
    ("unaligned_3x5x70x33", 3, 5, 70, 33),
)
# random operands: |kernel - plain| and |kernel - f64| <= RAND_TOL * (|x| @ |w|).
# An f32 accumulate over K terms reads ~2e-7 of that scale; an operand rounded
# to bf16 on its way in reads ~5e-5 to 1e-4 at K = 1024..2816.
RAND_TOL = 1e-5
FRAC = 1 + 2**-8  # exact in f32, not in bf16: a ±FRAC operand shows any rounding to bf16


def per_step(arch: str) -> dict[str, int]:
    """Launches per decode step of each matmul kernel on ``arch``'s path."""
    return {"ft_matmul": sum(s[-1] for s in DECODE_SHAPES[arch]),
            "ft_matmul_batched": sum(s[-1] for s in EXPERT_SHAPES[arch])}


def phase(name: str, /, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


# --------------------------------------------------------------------------- #
def device_phase() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
          nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    return smi


def build_phase() -> None:
    """Build every kernel, then print what ``nvcc -Xptxas -v`` reported for
    each: registers a thread, static shared memory and spill bytes, and for
    the libraries with a TMA ring its dynamic shared memory."""
    import ctypes

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    phase("build", seconds=round(time.perf_counter() - t0, 3), libraries=sorted(libs))
    for name in sorted(libs):
        ring = getattr(_build.load(name), f"{name}_dynamic_smem", None)
        if ring is not None:
            ring.restype = ctypes.c_longlong
        usage = _build.ptxas_usage(name)
        for k in usage:
            # the tensor-core kernels hold their accumulators in registers, the
            # ft_matmul kernels their loads in flight
            if "wgmma" in k["kernel"] or name == "ft_matmul":
                check(k["spill_stores"] == k["spill_loads"] == 0, f"{k['kernel']} spills: {k}")
        phase("ptxas", library=name, kernels=usage, dynamic_smem_bytes=None if ring is None else ring())


# --------------------------------------------------------------------------- #
def fault_grids(dev):
    """An 8x8 array: stuck-at-1 and stuck-at-0 faults incl. bit 31, a column
    remap and two pruned PEs, lowered to the kernel's AND/OR pair."""
    from repro_torch.core.engine import FaultState, HyCAConfig, RepairPlan, fault_mask_grids, fault_meta_grid

    faults = [(0, 0, 31, 1), (1, 3, 31, 0), (2, 5, 30, 1), (3, 7, 22, 0), (5, 1, 5, 1), (7, 6, 23, 1)]
    fpt = torch.full((len(faults) + 2, 2), -1, dtype=torch.int32)
    bit = torch.zeros(len(faults) + 2, dtype=torch.int32)
    val = torch.zeros_like(bit)
    for i, (r, c, b, v) in enumerate(sorted(faults, key=lambda f: (f[1], f[0]))):
        fpt[i, 0], fpt[i, 1], bit[i], val[i] = r, c, b, v
    prune = torch.zeros((ROWS, COLS), dtype=torch.bool)
    prune[4, 4] = prune[6, 2] = True
    plan = RepairPlan(torch.tensor([1, 0, 2, 3, 4, 5, 7, 6], dtype=torch.int32), prune)
    state = FaultState(fpt, bit, val).to(dev)
    hyca = HyCAConfig(rows=ROWS, cols=COLS, mode="unprotected")
    meta = fault_meta_grid(state, hyca, plan.to(dev))
    return fault_mask_grids(meta)


def _kernel_checks(name: str, kernel, plain, operands, and_g, or_g, dtype, kinds=None) -> tuple[float, float]:
    """One kernel against its plain version on one shape and dtype.
    ``operands(kind)`` draws (x, w).  Integer-valued operands, and in f32 one
    operand of ±(1 + 2^-8) entries: every partial sum is a multiple of 2^-8
    below 2^16, so exact in f32 in any order, and the kernel and the plain
    version must agree bit for bit (rounding the f32 operand to bf16 drops the
    2^-8 and shows here).  Random operands: the clean accumulate within
    RAND_TOL of the plain version and of an f64 product, and the faulted
    output exactly the epilogue of the kernel's own clean accumulate.
    ``kinds``: the exact operand kinds to draw (default: by ``dtype``).
    Returns (max |Δ| against the plain version, max |Δ| / scale)."""
    from repro_torch.core.engine import apply_mask_grids

    keep = torch.full_like(and_g, -1)
    zero = torch.zeros_like(or_g)
    if kinds is None:
        kinds = ("integer",) + (("frac_x", "frac_w") if dtype == torch.float32 else ())
    for kind in kinds:
        x, w = operands(kind)
        if kind != "integer":
            t = x if kind == "frac_x" else w
            check(not torch.equal(t, t.to(torch.bfloat16).float()), f"{kind}: operand exact in bf16")
        got = kernel(x, w, and_g, or_g)
        ref = plain(x, w, and_g, or_g)
        torch.cuda.synchronize()
        check(torch.equal(got.view(torch.int32), ref.view(torch.int32)),
              f"{name} {dtype} {kind} operands: not bitwise equal")
        _bf16_store_check(name, kernel, x, w, and_g, or_g, got)
    x, w = operands("random")
    clean = kernel(x, w, keep, zero)
    faulted = kernel(x, w, and_g, or_g)
    check(torch.equal(kernel(x, w, and_g, or_g).view(torch.int32), faulted.view(torch.int32)),
          f"{name} {dtype}: the same call twice gave other bits")
    _bf16_store_check(name, kernel, x, w, and_g, or_g, faulted)
    ref = plain(x, w, keep, zero)
    exact = torch.matmul(x.double(), w.double())
    scale = torch.matmul(x.double().abs(), w.double().abs()) + 1e-30
    err = (clean.double() - ref.double()).abs()
    err64 = (clean.double() - exact).abs()
    check(bool((err <= RAND_TOL * scale).all()), f"{name} {dtype} random operands: beyond tolerance of the plain version")
    check(bool((err64 <= RAND_TOL * scale).all()), f"{name} {dtype} random operands: beyond tolerance of the f64 product")
    rows = and_g.shape[0]
    row_res = (torch.arange(clean.shape[-2], device=clean.device) % rows)[:, None]
    check(torch.equal(faulted.view(torch.int32),
                      apply_mask_grids(clean, and_g, or_g, row_residue=row_res).view(torch.int32)),
          f"{name} {dtype}: faulted output is not the epilogue of the accumulate")
    return float(err.max()), max(float((err / scale).max()), float((err64 / scale).max()))


def _bf16_store_check(name: str, kernel, x, w, and_g, or_g, f32_out) -> None:
    """The kernel's bf16 store bitwise equal to its f32 output cast to bf16
    on the card, NaNs (stuck exponent bits) and their payloads included:
    both round with cvt.rn.bf16.f32."""
    got = kernel(x, w, and_g, or_g, out_dtype=torch.bfloat16)
    want = f32_out.to(torch.bfloat16)
    check(got.dtype == torch.bfloat16 and torch.equal(got.view(torch.int16), want.view(torch.int16)),
          f"{name}: bf16 store is not the f32 output cast to bf16 "
          f"({int((got.view(torch.int16) != want.view(torch.int16)).sum())} elements, "
          f"{int(torch.isnan(want).sum())} NaN in the cast)")


def _draw(g, dev, dtype, kind: str, shape, scale: float, frac: bool):
    if kind == "random":
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)
    a = torch.randint(-4, 5, shape, generator=g, device=dev).to(torch.float32)
    if frac:
        sign = torch.randint(0, 2, shape, generator=g, device=dev) * 2 - 1
        a = torch.where(torch.rand(shape, generator=g, device=dev) < 0.25, sign * FRAC, a)
    return a.to(dtype)


def ft_matmul_phase(dev) -> float:
    from repro_torch.kernels.ft_matmul import ft_matmul, ft_matmul_ref, plan_of

    g = torch.Generator(device=dev).manual_seed(0)
    and_g, or_g = fault_grids(dev)
    max_err = max_rel = 0.0
    plans = {}
    seen, shapes = set(), []
    for arch, arch_shapes in DECODE_SHAPES.items():
        for n, m, k, nn, _ in arch_shapes:
            if (m, k, nn, n.startswith("head")) not in seen:  # granite-8b and llava share their layers'
                seen.add((m, k, nn, n.startswith("head")))
                shapes.append((n if arch in (QWEN, GRANITE) else f"{n}@{arch}", m, k, nn))
    shapes += list(EXTRA_SHAPES)
    for name, m, k, n in shapes:
        head = name.startswith("head")
        for dtype in (torch.bfloat16, torch.float32):
            def operands(kind: str):
                x = _draw(g, dev, dtype, kind, (m, k), 1.0, kind == "frac_x")
                # the head reads the (vocab, d) table through a transposed view
                fw = kind == "frac_w"
                w = _draw(g, dev, dtype, kind, (n, k), 0.02, fw).T if head else _draw(g, dev, dtype, kind, (k, n), 0.02, fw)
                return x, w

            e, r = _kernel_checks(f"ft_matmul {name}", ft_matmul, ft_matmul_ref, operands, and_g, or_g, dtype)
            max_err, max_rel = max(max_err, e), max(max_rel, r)
            plans[f"{name} {str(dtype)[6:]}"] = _plan_str(plan_of(*operands("integer")))
    phase("ft_matmul", shapes=[s[0] for s in shapes], dtypes=["bf16", "f32"],
          bitwise=["integer", "f32 frac_x", "f32 frac_w", "bf16 store = f32 cast", "repeat call"],
          random_tol=f"{RAND_TOL}*(|x|@|w|)", max_abs_err=max_err, max_err_over_scale=max_rel, plans=plans)
    return max_err


def mixed_dtype_checks(dev) -> float:
    """``ft_matmul`` with float32 x against a bfloat16 w, the pair RWKV6's
    decay LoRA hands it (its f32 ``tanh`` against ``w_b``), at that call's
    decode and prefill shapes (``F32_X_SHAPES``): integer-valued operands and
    an f32 x of ±(1 + 2^-8) entries bitwise (a kernel that rounded x to bf16
    would drop the 2^-8), random operands within RAND_TOL of
    ``ft_matmul_ref`` and of the f64 product, the bf16 store bitwise the f32
    output cast, as :func:`_kernel_checks` holds every shape.  Returns the
    max |kernel - plain| on random operands."""
    from repro_torch.kernels.ft_matmul import ft_matmul, ft_matmul_ref, plan_of

    g = torch.Generator(device=dev).manual_seed(11)
    and_g, or_g = fault_grids(dev)
    max_err, rel, plans = 0.0, {}, {}
    shapes = [s[:4] for table in (DECODE_SHAPES, PREFILL_SHAPES) for s in table[RWKV6] if s[0] in F32_X_SHAPES]
    for name, m, k, n in shapes:
        def operands(kind: str):
            return (_draw(g, dev, torch.float32, kind, (m, k), 1.0, kind == "frac_x"),
                    _draw(g, dev, torch.bfloat16, kind, (k, n), 0.02, False))

        err, rel[name] = _kernel_checks(f"ft_matmul {name} f32 x bf16 w", ft_matmul, ft_matmul_ref, operands,
                                        and_g, or_g, torch.float32, kinds=("integer", "frac_x"))
        max_err = max(max_err, err)
        plans[name] = _plan_str(plan_of(*operands("integer")))
    phase("ft_matmul_mixed", shapes=[s[0] for s in shapes], x_dtype="f32", w_dtype="bf16", plans=plans,
          bitwise=["integer", "f32 frac_x", "bf16 store = f32 cast", "repeat call"],
          random_tol=f"{RAND_TOL}*(|x|@|w|)", max_abs_err=max_err, max_err_over_scale=rel)
    return max_err


def _plan_str(plan) -> str:
    return f"{plan.layout} S={plan.split} BN={plan.bn}"


def dispatch_view(t: torch.Tensor) -> torch.Tensor:
    """A (b, e, c, d) tensor with c = 1 as the (e, b·c, d) strided view that
    ``FTContext.einsum`` hands ``ft_matmul_batched`` at decode."""
    b, e, c, d = t.shape
    return t.transpose(0, 1).reshape(e, b * c, d)


def ft_matmul_batched_phase(dev) -> float:
    from repro_torch.kernels.ft_matmul import ft_matmul_batched, ft_matmul_batched_ref, plan_of

    g = torch.Generator(device=dev).manual_seed(2)
    and_g, or_g = fault_grids(dev)
    max_err = max_rel = 0.0
    plans = {}
    shapes = [s[:5] for s in EXPERT_SHAPES[GRANITE]] + list(EXTRA_EXPERT_SHAPES)
    for name, e, m, k, n in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            def operands(kind: str):
                x = dispatch_view(_draw(g, dev, dtype, kind, (m, e, 1, k), 1.0, kind == "frac_x"))
                w = _draw(g, dev, dtype, kind, (e, k, n), 0.02, kind == "frac_w")
                return x, w

            er, r = _kernel_checks(f"ft_matmul_batched {name}", ft_matmul_batched, ft_matmul_batched_ref,
                                   operands, and_g, or_g, dtype)
            max_err, max_rel = max(max_err, er), max(max_rel, r)
            plans[f"{name} {str(dtype)[6:]}"] = _plan_str(plan_of(*operands("integer")))
    phase("ft_matmul_batched", shapes=[s[0] for s in shapes], dtypes=["bf16", "f32"],
          x_layout="(b, e, c, d) strided view",
          bitwise=["integer", "f32 frac_x", "f32 frac_w", "bf16 store = f32 cast", "repeat call"],
          random_tol=f"{RAND_TOL}*(|x|@|w|)", max_abs_err=max_err, max_err_over_scale=max_rel, plans=plans)
    return max_err


def probe_check_phase(dev) -> None:
    """``probe_check`` against ``probe_check_ref`` over every row-block and
    both probe signs, with and without faults; ``probe_check_pair`` (the scan
    step's one launch) against ``probe_check_pair_ref`` on the same
    row-blocks, then on random operands (small probes and full-range int32
    ones whose sums wrap) with stuck-at faults on accumulator bits 0, 15, 30
    and 31 in both readbacks: bitwise, one launch a call."""
    from repro_torch.kernels.dppu_recompute import (
        probe_check, probe_check_pair, probe_check_pair_ref, probe_check_ref,
    )
    from repro_torch.serving.fault_manager import FaultInjector

    n = n_pair = 0
    pair0 = probe_check_pair.launches
    for faulty in (False, True):
        inj = FaultInjector(ROWS, COLS, seed=3)
        if faulty:
            for r, c, b, v in [(0, 0, 31, 1), (3, 4, 30, 1), (5, 2, 0, 0), (7, 7, 12, 1)]:
                inj.inject_at(r, c, bit=b, val=v)
        for sweep in range(2):
            px, pw = inj.probe_operands(sweep)
            for block in (1, 2, 8):
                for r0 in range(0, ROWS, block):
                    pxb = px[r0:r0 + block]
                    ars = {}
                    for sign in (1, -1):
                        ars[sign] = inj.corrupted_probe(pxb, sign * pw, row0=r0)
                        t = [torch.from_numpy(a).to(dev) for a in (pxb, sign * pw, ars[sign])]
                        got = probe_check(*t)
                        ref = probe_check_ref(*t, window=8).to(torch.int32)
                        check(torch.equal(got, ref), f"probe_check r0={r0} block={block} faulty={faulty}")
                        n += 1
                    t = [torch.from_numpy(a).to(dev) for a in (pxb, pw, ars[1], ars[-1])]
                    got = probe_check_pair(*t)
                    ref = probe_check_pair_ref(*t, window=8).to(torch.int32)
                    check(torch.equal(got, ref), f"probe_check_pair r0={r0} block={block} faulty={faulty}")
                    n_pair += 1
    g = torch.Generator(device=dev).manual_seed(8)
    flagged = 0
    for lo, hi in ((-4, 8), (-2**31, 2**31 - 1)):
        for block in (1, 8):
            px = torch.randint(lo, hi, (block, 8), generator=g, device=dev, dtype=torch.int32)
            pw = torch.randint(lo, hi, (8, COLS), generator=g, device=dev, dtype=torch.int32)
            ar = (px.long()[:, :, None] * pw.long()).sum(1).to(torch.int32)
            ar_neg = (px.long()[:, :, None] * (-pw).long()).sum(1).to(torch.int32)
            for i, bit in enumerate((0, 15, 30, 31)):
                mask = int(np.uint32(1 << bit).view(np.int32))
                for t, v in ((ar, i % 2), (ar_neg, 1 - i % 2)):
                    r, c = i % block, (3 * i + v) % COLS
                    t[r, c] = t[r, c] | mask if v else t[r, c] & ~mask
            got = probe_check_pair(px, pw, ar, ar_neg)
            ref = probe_check_pair_ref(px, pw, ar, ar_neg, window=8).to(torch.int32)
            check(torch.equal(got, ref), f"probe_check_pair random [{lo}, {hi}) block={block}")
            flagged += int(got.sum())
            n_pair += 1
    check(flagged > 0, "no stuck-at fault on bits 0, 15, 30, 31 was flagged")
    check(probe_check_pair.launches - pair0 == n_pair, f"probe_check_pair: {probe_check_pair.launches - pair0} "
          f"launches in {n_pair} calls")
    probe_check_pair.launches = pair0  # checks, not main-path launches
    phase("probe_check", comparisons=n, pair_comparisons=n_pair, pair_stuck_bits=[0, 15, 30, 31],
          pair_full_range_int32=True, launches_per_pair_call=1, exact=True)


# --------------------------------------------------------------------------- #
def trace(vocab: int, n: int = 6, prompt: int = 8, gen: int = 8):
    rng = np.random.default_rng(42)
    return [{"step": 0, "prompt": rng.integers(0, vocab, size=prompt), "max_new_tokens": gen}
            for _ in range(n)]


BIST_FAULTS = [(0, 1, 30, 1), (2, 3, 31, 0), (3, 6, 20, 1)]  # 3 <= the DPPU's 4
# the served runs: (mode, faults at power-on, (step, fault) appearing before
# that step).  The fault of step 2 makes the fault state swap after the
# capture: in protected mode on PE row 5, which a 4-slot step never reaches
# (output row i runs on PE row i % 8), so protected still serves off's bits
# while the scan finds it; in unprotected mode on PE row 1
SCENARIOS = (("off", (), ()), ("protected", BIST_FAULTS, ((2, (5, 3, 30, 1)),)),
             ("unprotected", [(0, 0, 30, 1)], ((2, (1, 2, 29, 1)),)))


def _kernels():
    from repro_torch.kernels.dppu_recompute import probe_check, probe_check_pair
    from repro_torch.kernels.ft_matmul import ft_matmul, ft_matmul_batched

    return {"ft_matmul": ft_matmul, "ft_matmul_batched": ft_matmul_batched, "probe_check": probe_check,
            "probe_check_pair": probe_check_pair}


def call_shapes(fn, ctx, *args) -> dict[tuple, int]:
    """{(kernel, E, M, K, N): launches} of one call of ``fn(ctx, *args)``:
    each protected ``matmul`` is one ``ft_matmul`` launch (E = 1), each
    protected ``einsum`` one ``ft_matmul_batched`` launch over its E
    experts.  Recorded through the stand-in context of the call ledger
    (:func:`repro_torch.obs.counters.trace_site_calls`), which keeps
    ``ctx``'s protection decisions and computes plain matmuls, so ``meta``
    tensors record shapes only; the ledger keeps (M, N), this adds K."""
    from repro_torch.obs.counters import _LedgerRecorder

    got: dict[tuple, int] = {}

    class Recorder(_LedgerRecorder):
        def _add(self, site, key):
            if self.protects(site) and self.ftc.dispatch != "plain":
                got[key] = got.get(key, 0) + 1

        def matmul(self, x, w, *, site):
            self._add(site, ("ft_matmul", 1, math.prod(x.shape[:-1]), x.shape[-1], w.shape[-1]))
            return super().matmul(x, w, site=site)

        def einsum(self, spec, x, w, *, site):
            self._add(site, ("ft_matmul_batched", x.shape[1], x.shape[0] * x.shape[2], x.shape[-1], w.shape[-1]))
            return super().einsum(spec, x, w, site=site)

    with torch.no_grad():
        fn(Recorder(ctx), *args)
    return got


def table_shapes(mm_shapes, expert_shapes) -> dict[tuple, int]:
    """A shape table's {(kernel, E, M, K, N): launches}, keyed as
    :func:`call_shapes` keys a recorded call."""
    want: dict[tuple, int] = {}
    for kname, shapes in (("ft_matmul", [(1, *s[1:]) for s in mm_shapes]),
                          ("ft_matmul_batched", [s[1:] for s in expert_shapes])):
        for e, m, k, n, per in shapes:
            want[(kname, e, m, k, n)] = want.get((kname, e, m, k, n), 0) + per
    return want


def meta_tree(tree):
    from repro_torch.tree import tree_map

    return tree_map(lambda a: torch.empty_like(a, device="meta"), tree)


def decode_shapes(lm, ctx, params, n_slots: int = 4) -> dict[tuple, int]:
    """:func:`call_shapes` of one decode step of ``n_slots`` on ``meta``."""
    from repro_torch.models.lm import decode_step, init_cache

    return call_shapes(lambda c, p, ch, t: decode_step(p, lm, ch, {"token": t}, ftc=c), ctx, meta_tree(params),
                       init_cache(lm, n_slots, 96, device="meta"),
                       torch.zeros((n_slots, 1), dtype=torch.int32, device="meta"))


def prefill_shapes(lm, ctx, params, batch: dict) -> dict[tuple, int]:
    """:func:`call_shapes` of the fused prefill, ``forward(last_only=True)``,
    of ``batch`` on ``meta``."""
    from repro_torch.models.lm import forward

    return call_shapes(lambda c, p, b: forward(p, lm, b, ftc=c, last_only=True), ctx, meta_tree(params),
                       meta_tree(batch))


def hold_shapes(what: str, got: dict, mm_shapes, expert_shapes) -> None:
    want = table_shapes(mm_shapes, expert_shapes)
    check(got == want, f"{what}: the path launches {sorted(got.items())}, the table says {sorted(want.items())}")


def serve(bundle, mode: str, vocab: int, *, faults=(), inject=(), bist_at=None, capture=None,
          record_logits=False, **cfg_kw) -> dict:
    """One server run over the 6-request trace.  ``faults`` are there at
    power-on; each ``(step, (r, c, bit, val))`` of ``inject`` appears just
    before that step, and at step ``bist_at`` a BIST confirms every fault
    there.  ``capture``: the server's (None: the captured step); ``cfg_kw``
    the ServerConfig fields beside the bundle's (repair, counters, series).
    Returns the tokens by rid, the summary, each step's seconds and tokens,
    every step's logits (with ``record_logits``), the launch counts of this
    run (set to 0 just before its first step, read just after its last), the
    step's captures, replays, capture seconds and pool bytes, the
    fault-state swaps after the first step, the addresses of the held mask
    grids at every step, and the server."""
    from repro_torch.serving import FaultInjector, FaultTolerantServer

    cfg = dataclasses.replace(bundle.cfg, mode=mode, **cfg_kw)
    inj = FaultInjector(cfg.rows, cfg.cols, seed=cfg.seed + 1)
    for r, c, b, v in faults:
        inj.inject_at(r, c, bit=b, val=v)
    srv = FaultTolerantServer(cfg, bundle=bundle, injector=inj, capture=capture)
    for t in trace(vocab):
        srv.submit(t["prompt"], t["max_new_tokens"])
    times, logits, grid_ptrs = [], [], []
    swaps = None
    kernels = _kernels()
    for k in kernels.values():
        k.launches = 0
    while srv.queue.depth() or srv.scheduler.active:
        for at, (r, c, b, v) in inject:
            if at == srv.step_idx:
                inj.inject_at(r, c, bit=b, val=v)
        if srv.step_idx == bist_at:
            srv.manager.bist()
        if srv.step_idx == 1:
            swaps = bundle.swaps
        t0 = time.perf_counter()
        srv.step()  # ends in the step's host sync
        times.append(time.perf_counter() - t0)
        if record_logits:
            logits.append(srv.decode.logits.clone())
        grid_ptrs.append([g.data_ptr() for _, pair in bundle.ftc._grids for g in pair])
    counts = {name: k.launches for name, k in kernels.items()}
    srv.metrics.finish()
    d = srv.decode
    return dict(tokens=srv.completions_by_rid(), summary=srv.metrics.summary(counters=srv.counters_host()),
                times=times, step_tokens=[r.tokens_generated for r in srv.metrics.steps], logits=logits,
                counts=counts, captures=d.captures, replays=d.replays, capture_s=d.capture_s,
                pool_bytes=d.pool_bytes, swaps_after_first_step=bundle.swaps - swaps, grid_ptrs=grid_ptrs,
                server=srv)


def _steady(run: dict, skip: int = 2) -> tuple[float, float]:
    """(median step ms, tokens/s) over the steps after the first ``skip``
    (the warm-up and capture, the first replay)."""
    times = run["times"][skip:]
    return 1e3 * float(np.median(times)), sum(run["step_tokens"][skip:]) / sum(times)


def _same_bits(a: list, b: list) -> bool:
    return len(a) == len(b) and all(torch.equal(x.view(torch.int16), y.view(torch.int16)) for x, y in zip(a, b))


def serve_modes(bundle, smi: str, arch: str, scenarios, bist_at=None) -> dict:
    """Serve each ``(mode, faults, inject)`` of ``scenarios`` through the
    captured step and again through the eager step (:func:`serve`); hold
    every captured run to the launch counts of ``arch``'s path, one capture,
    a fault-state swap after it and the eager run bit for bit; then off's
    tokens and logits to protected's bit for bit (the scan or ``bist_at``'s
    BIST confirming the fault that appears) and unprotected's first logits
    to differ.  First the decode step's calls, recorded on ``meta``, are
    held to ``DECODE_SHAPES`` and ``EXPERT_SHAPES``, the tables the launch
    counts and the kernel checks read.  Returns {mode: run}."""
    lm = bundle.lm
    hold_shapes(f"{arch} decode step", decode_shapes(lm, bundle.ftc, bundle.work, bundle.cfg.n_slots),
                DECODE_SHAPES[arch], EXPERT_SHAPES[arch])
    check(all(c.protected and c.dispatch == "fused" for c in bundle.ledger),
          f"{arch}: the call ledger {bundle.ledger} holds a call off the protected fused path")
    runs = {}
    want = per_step(arch)
    for mode, faults, inject in scenarios:
        at = bist_at if mode == "protected" else None
        run = serve(bundle, mode, lm.vocab, faults=faults, inject=inject, bist_at=at, record_logits=True)
        steps, counts = len(run["times"]), run["counts"]
        for name, n in want.items():
            check(counts[name] == n * steps, f"{arch} {mode}: {name} launched {counts[name]} times in {steps} steps")
        want_pair = steps if mode == "protected" else 0
        check(counts["probe_check_pair"] == want_pair and counts["probe_check"] == 0,
              f"{arch} {mode}: probe_check_pair launched {counts['probe_check_pair']} and probe_check "
              f"{counts['probe_check']} times in {steps} steps")
        check(run["captures"] == 1 and run["replays"] == steps - 1,
              f"{arch} {mode}: {run['captures']} captures and {run['replays']} replays in {steps} steps")
        if mode != "off":
            check(run["swaps_after_first_step"] >= 1, f"{arch} {mode}: no fault-state swap after the capture")
        shape = tuple(run["logits"][0].shape)
        check(shape == (4, 1, lm.padded_vocab), f"{mode}: logits shape {shape}")
        eager = serve(bundle, mode, lm.vocab, faults=faults, inject=inject, bist_at=at, capture=False,
                      record_logits=True)
        check(eager["captures"] == 0 and eager["counts"] == counts,
              f"{arch} {mode}: the eager step launched {eager['counts']}, the captured {counts}")
        check(eager["tokens"].keys() == run["tokens"].keys()
              and all(np.array_equal(eager["tokens"][r], run["tokens"][r]) for r in run["tokens"]),
              f"{arch} {mode}: the captured step's tokens differ from the eager step's")
        check(_same_bits(run["logits"], eager["logits"]),
              f"{arch} {mode}: the captured step's logits differ from the eager step's")
        runs[mode] = run
        (ms, tps), (ems, etps) = _steady(run), _steady(eager)
        phase(f"serve_{mode}", arch=arch, steps=steps, tokens=run["summary"]["tokens"],
              confirmed=run["summary"]["confirmed_faults_final"], launches=counts, captures=run["captures"],
              replays=run["replays"], swaps_after_capture=run["swaps_after_first_step"],
              capture_s=run["capture_s"], graph_pool_bytes=run["pool_bytes"], graph_equals_eager=True,
              step_ms_median=ms, tokens_per_s=tps, eager_step_ms_median=ems, eager_tokens_per_s=etps, card=smi)
        del eager

    off, prot, unprot = runs["off"], runs["protected"], runs["unprotected"]
    check(bool(torch.isfinite(off["logits"][0][..., :lm.vocab].float()).all()), f"{arch} off: non-finite logits")
    check(len(off["tokens"]) == 6 and all(len(t) == 8 and (t >= 0).all() and (t < lm.vocab).all()
                                          for t in off["tokens"].values()), f"{arch} off: token streams")
    check(off["tokens"].keys() == prot["tokens"].keys()
          and all(np.array_equal(off["tokens"][r], prot["tokens"][r]) for r in off["tokens"]),
          f"{arch}: protected (faults <= capacity) tokens differ from off")
    check(_same_bits(off["logits"], prot["logits"]), f"{arch}: protected logits differ from off")
    check(prot["summary"]["confirmed_faults_final"] == 4, f"{arch}: the fault of step 2 was not confirmed")
    check(not torch.equal(off["logits"][0].view(torch.int16), unprot["logits"][0].view(torch.int16)),
          f"{arch}: unprotected (PE(0,0) bit 30 stuck-at-1) logits equal off")
    phase("serve_checks", arch=arch, protected_equals_off=True, unprotected_differs=True,
          graph_equals_eager=["off", "protected", "unprotected"], compared="every step's logits, every token",
          confirmed_by="BIST at step 2" if bist_at is not None else "the scan")
    return runs


def full_bundle(dev, arch: str):
    """``arch``'s ModelBundle at full width: random f32 masters from seed 0,
    bf16 working copies, 4 slots, the 8x8 array with a DPPU of 4, fused."""
    from repro_torch.configs import get_config
    from repro_torch.serving import ModelBundle, ServerConfig

    lm = get_config(arch)
    cfg = ServerConfig(arch=arch, device=str(dev), dispatch="fused", n_slots=4, rows=ROWS, cols=COLS,
                       dppu_size=4, smax=96, seed=0)
    t0 = time.perf_counter()
    bundle = ModelBundle(cfg, lm=lm)
    torch.cuda.synchronize()
    phase("bundle", arch=lm.name, layers=lm.n_layers, d_model=lm.d_model, vocab=lm.padded_vocab,
          family=lm.family, attn=lm.attn_kind, norm=lm.norm, experts=lm.moe.n_padded if lm.moe else 0,
          seconds=round(time.perf_counter() - t0, 3), device_gib=round(torch.cuda.memory_allocated() / 2**30, 3))
    return bundle


def server_phase(dev, smi: str, arch: str):
    """Serve ``arch`` at full width off / protected / unprotected through the
    captured step, each mode also through the eager step; hold the captured
    runs to the launch counts, to the eager runs bit for bit and to each
    other; then the smoke config on the card against the CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.serving import ModelBundle

    bundle = full_bundle(dev, arch)
    lm, cfg = bundle.lm, bundle.cfg
    serve(bundle, "off", lm.vocab)  # warm-up: first launches, allocator, kernels loaded
    runs = serve_modes(bundle, smi, arch, SCENARIOS)
    plan = serve_remap_phase(bundle, smi, arch)
    serve_counters_phase(bundle, smi, arch, runs["protected"], BIST_FAULTS, SCENARIOS[1][2], plan)

    # the same smoke-size server on the card and on the CPU (plain versions)
    small = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    scfg = dataclasses.replace(cfg, smax=32)
    gb = ModelBundle(scfg, lm=small)
    cb = ModelBundle(dataclasses.replace(scfg, device="cpu"), lm=small,
                     params={k: v for k, v in gb.params.items()})
    gr = serve(gb, "unprotected", small.vocab, faults=[(1, 2, 20, 1)], record_logits=True)
    cr = serve(cb, "unprotected", small.vocab, faults=[(1, 2, 20, 1)], record_logits=True)
    gt, ct = gr["tokens"], cr["tokens"]
    err = float((gr["logits"][0].cpu() - cr["logits"][0]).abs()[..., :small.vocab].max())
    check(err <= 1e-4, f"{arch} smoke server on the card vs the CPU: first-step logits differ by {err}")
    check(all(np.array_equal(gt[r], ct[r]) for r in ct) and gt.keys() == ct.keys(),
          f"{arch} smoke server on the card vs the CPU: tokens differ")
    # the remap scenario: the plan swapped in at step 2, after the capture
    remap = dict(inject=tuple((REMAP_AT, f) for f in REMAP_FAULTS), bist_at=REMAP_AT, repair="remap")
    gm = serve(gb, "protected", small.vocab, record_logits=True, **remap)
    cm = serve(cb, "protected", small.vocab, record_logits=True, **remap)
    check(len(gm["server"].repair_events) == len(cm["server"].repair_events) == 1,
          f"{arch} smoke remap: repair events {gm['server'].repair_events} on the card, "
          f"{cm['server'].repair_events} on the CPU")
    rerr = [float((g.cpu() - c).abs()[..., :small.vocab].max()) for g, c in zip(gm["logits"], cm["logits"])]
    check(max(rerr) <= 1e-4, f"{arch} smoke remap on the card vs the CPU: logits differ by {max(rerr)}")
    check(gm["tokens"].keys() == cm["tokens"].keys()
          and all(np.array_equal(gm["tokens"][r], cm["tokens"][r]) for r in cm["tokens"]),
          f"{arch} smoke remap on the card vs the CPU: tokens differ")
    phase("serve_reference", arch=small.name, max_abs_err_logits=err, tokens_equal=True, card_captures=gr["captures"],
          remap_max_abs_err_logits=max(rerr), remap_tokens_equal=True, remap_card_captures=gm["captures"])
    return bundle, runs


# six faults in six PE columns, in PE rows 0-3 (a 4-slot step reaches them),
# on bits a bf16 output keeps; they appear at step 2, after the capture, and
# a BIST confirms them there: the DPPU (4) repairs columns 0, 2, 3, 4 and
# columns 6 and 7 are over capacity
REMAP_FAULTS = ((0, 0, 30, 1), (1, 2, 29, 1), (2, 3, 30, 1), (3, 4, 28, 1), (0, 6, 30, 1), (1, 7, 29, 1))
REMAP_AT = 2


def _pruned_outputs(plan, m: int, n: int, dev) -> torch.Tensor:
    """(m, n) bool: the outputs the plan zeroes, out[i, j] on
    PE(i % rows, col_map[j % cols])."""
    prune = plan.prune[:, plan.col_map.long()]
    rows, cols = prune.shape
    return prune[(torch.arange(m, device=dev) % rows)[:, None], torch.arange(n, device=dev) % cols]


def pruned_call_check(bundle, plan) -> dict:
    """One ``ft_matmul`` call on the server's live grids (the pair the graph
    reads, built for ``plan``) at layer 0's q projection: on a real
    activation (the normed embedding of four tokens, bf16, the bf16 store)
    every output on a pruned PE is exactly +0, the same in the plain
    version, and the rest within RAND_TOL of it; on integer-valued operands
    of the same shapes, bitwise the plain version.  Not main-path launches."""
    from repro_torch.kernels.ft_matmul import ft_matmul, ft_matmul_ref
    from repro_torch.models.layers import rmsnorm

    dev = bundle.device
    and_g, or_g = bundle.ftc.mask_grids(plan)
    launches0 = ft_matmul.launches
    blk = bundle.work["blocks"][0]
    tok = torch.tensor([1, 17, 301, 409], device=dev)
    x = rmsnorm(bundle.work["embed"][tok], blk["ln1"])
    w = blk["attn"]["wq"]
    pos = _pruned_outputs(plan, x.shape[0], w.shape[1], dev)
    check(bool(pos.any()) and bool(((and_g == 0) & (or_g == 0)).any()), "the plan prunes no output")
    out = ft_matmul(x, w, and_g, or_g, out_dtype=torch.bfloat16)
    ref = ft_matmul_ref(x, w, and_g, or_g, out_dtype=torch.bfloat16)
    check(bool((out.view(torch.int16)[pos] == 0).all()) and bool((ref.view(torch.int16)[pos] == 0).all()),
          "pruned outputs are not exactly +0")
    clean = torch.matmul(x.float(), w.float())
    check(bool((clean[pos] != 0).all()), "a pruned output is zero without the plan")
    scale = torch.matmul(x.float().abs(), w.float().abs()) + 1e-30
    # both store bf16: one bf16 rounding apart at most, beside the f32 sum order
    err = float(((out.float() - ref.float()).abs() / scale)[~pos].max())
    check(err <= 2**-7, f"pruned call: unpruned outputs {err} of |x|@|w| from the plain version")
    g = torch.Generator(device=dev).manual_seed(5)
    xi = torch.randint(-4, 5, tuple(x.shape), generator=g, device=dev).to(torch.bfloat16)
    wi = torch.randint(-4, 5, tuple(w.shape), generator=g, device=dev).to(torch.bfloat16)
    bit = torch.equal(ft_matmul(xi, wi, and_g, or_g).view(torch.int32), ft_matmul_ref(xi, wi, and_g, or_g).view(torch.int32))
    check(bit, "pruned call: integer-valued operands not bitwise equal to the plain version")
    ft_matmul.launches = launches0
    return dict(pruned_outputs=int(pos.sum()), outputs=pos.numel(), real_activation_unpruned_err_over_scale=err,
                integer_operands_bitwise=True)


def plan_swap_cost(bundle, plan, swaps: int = 20) -> dict:
    """The bundle's context swapped between ``plan`` and the identity plan
    ``swaps`` times: ms a swap (host clock around the swaps and a sync), the
    held grid pairs it rewrites, and its device kernels from the profiler."""
    from torch.profiler import ProfilerActivity, profile

    ftc, ident = bundle.ftc, bundle.identity_plan
    back = ftc.plan
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(swaps):
        ftc.swap(plan=ident if i % 2 == 0 else plan)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / swaps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(4):
            ftc.swap(plan=ident if i % 2 == 0 else plan)
        torch.cuda.synchronize()
    kernels = sum(e.count for e in _device_events(prof.key_averages())) / 4
    ftc.swap(plan=back)
    return dict(swap_ms=ms, grid_pairs_rewritten=len(ftc._grids), increment_rewritten=ftc._increment is not None,
                device_ops_per_swap=kernels)


def serve_remap_phase(bundle, smi: str, arch: str) -> dict:
    """``repair="remap"`` at full width: the six faults of REMAP_FAULTS
    appear at step 2 and a BIST confirms them; the scan, the manager
    (REMAPPED), the planner (salience of the f32 masters) and the plan swap
    into the captured step follow.  Captured and eager: one repair.plan
    event, after the capture; 4 effective slots and quality 0.75 throughout;
    every step's logits and every token bitwise equal; one capture; the
    launches per step of the main path; the grids at the same addresses;
    one pruned call on the live grids.  Then the same faults with
    ``repair="none"``: the two columns retire and the slots drop."""
    remap = dict(inject=tuple((REMAP_AT, f) for f in REMAP_FAULTS), bist_at=REMAP_AT)
    t0 = time.perf_counter()
    run = serve(bundle, "protected", bundle.lm.vocab, record_logits=True, repair="remap", **remap)
    srv, steps, counts = run["server"], len(run["times"]), run["counts"]
    events = srv.repair_events
    check(len(events) == 1 and events[0]["step"] == REMAP_AT and events[0]["remapped_cols"] == [6, 7],
          f"{arch} remap: repair events {events}")
    eff = [r.effective_slots for r in srv.metrics.steps]
    check(all(e == 4 for e in eff) and srv.manager.quality_fraction == 0.75 and srv.manager.n_remapped == 2,
          f"{arch} remap: effective slots {eff}, quality {srv.manager.quality_fraction}")
    check(run["captures"] == 1 and run["replays"] == steps - 1 and run["swaps_after_first_step"] >= 1,
          f"{arch} remap: {run['captures']} captures, {run['replays']} replays, "
          f"{run['swaps_after_first_step']} swaps after the capture in {steps} steps")
    for name, n in per_step(arch).items():
        check(counts[name] == n * steps, f"{arch} remap: {name} launched {counts[name]} times in {steps} steps")
    check(counts["probe_check_pair"] == steps, f"{arch} remap: {counts['probe_check_pair']} pair probes")
    check(all(p == run["grid_ptrs"][0] for p in run["grid_ptrs"]), f"{arch} remap: the held grids moved")
    check(bundle.ftc.plan is srv.plan and srv.plan is not bundle.identity_plan, f"{arch} remap: plan not in the context")
    pruned = pruned_call_check(bundle, srv.plan)
    check([g.data_ptr() for g in bundle.ftc.mask_grids(srv.plan)] == run["grid_ptrs"][-1][:2],
          f"{arch} remap: the pruned call's grids are not the live ones")
    swap = plan_swap_cost(bundle, srv.plan)
    eager = serve(bundle, "protected", bundle.lm.vocab, record_logits=True, capture=False, repair="remap", **remap)
    check(eager["counts"] == counts and eager["server"].repair_events == events,
          f"{arch} remap: the eager run launched {eager['counts']} with events {eager['server'].repair_events}")
    check(eager["tokens"].keys() == run["tokens"].keys()
          and all(np.array_equal(eager["tokens"][r], run["tokens"][r]) for r in run["tokens"]),
          f"{arch} remap: the captured step's tokens differ from the eager step's")
    check(_same_bits(run["logits"], eager["logits"]), f"{arch} remap: the captured step's logits differ from the eager's")
    none = serve(bundle, "protected", bundle.lm.vocab, repair="none", **remap)
    nsrv = none["server"]
    none_eff = [r.effective_slots for r in nsrv.metrics.steps]
    check(min(none_eff) < 4 and len(nsrv.manager.retired_coords()) == 2 and not nsrv.repair_events,
          f"{arch} repair=none: effective slots {none_eff}, retired {sorted(nsrv.manager.retired_coords())}")
    # the steps after the one that took the plan (its salience sweep)
    (ms, tps), (ems, etps) = _steady(run, skip=REMAP_AT + 1), _steady(eager, skip=REMAP_AT + 1)
    out = dict(arch=arch, steps=steps, repair_event=events[0], effective_slots=sorted(set(eff)),
               quality_fraction=srv.manager.quality_fraction, launches=counts, captures=run["captures"],
               graph_equals_eager=True, step_ms_median=ms, tokens_per_s=tps,
               repair_step_s=run["times"][REMAP_AT], eager_repair_step_s=eager["times"][REMAP_AT],
               eager_step_ms_median=ems, eager_tokens_per_s=etps, pruned_call=pruned, plan_swap=swap,
               repair_none_effective_slots=sorted(set(none_eff)), repair_none_retired=len(nsrv.manager.retired_coords()),
               phase_s=time.perf_counter() - t0, card=smi)
    phase("serve_remap", **out)
    plan = srv.plan
    del run, eager, none, srv, nsrv
    return plan


def kernels_per_replay(bundle, *, counters: bool, steps: int = 3, **serve_kw) -> dict:
    """Device kernels and copies a replayed protected step, from the
    profiler over ``steps`` steps after the warm-up and capture (a window
    that all device records reached: ``agreed_window``)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.serving import FaultInjector, FaultTolerantServer

    cfg = dataclasses.replace(bundle.cfg, mode="protected", counters=counters, series=counters)

    def window():
        srv = FaultTolerantServer(cfg, bundle=bundle, injector=FaultInjector(cfg.rows, cfg.cols, seed=cfg.seed + 1))
        for t in trace(bundle.lm.vocab):
            srv.submit(t["prompt"], t["max_new_tokens"])
        for _ in range(2):
            srv.step()
        torch.cuda.synchronize()
        launches0 = {name: k.launches for name, k in _kernels().items()}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=steps, repeat=1)) as prof:
            for _ in range(1 + steps):
                srv.step()
                prof.step()
        for name, k in _kernels().items():  # not main-path launches
            k.launches = launches0[name]
        return prof.key_averages(), None

    ka, _, seen = agreed_window(window)
    dev = _device_events(ka)
    return dict(device_kernels=sum(e.count for e in dev if not e.key.startswith(("Memcpy", "Memset"))) / steps,
                device_copies=sum(e.count for e in dev if e.key.startswith(("Memcpy", "Memset"))) / steps,
                host_syncs=sum(e.count for e in ka if e.key in ("cudaStreamSynchronize",
                                                                "cudaDeviceSynchronize")) / steps,
                window_device_events=seen)


def serve_counters_phase(bundle, smi: str, arch: str, prot: dict, bist, inject, plan) -> dict:
    """The protected scenario of ``serve_*`` with ``counters`` and ``series``
    on, through the captured step: every step's logits and every token
    bitwise the counters-off run's; ``protected_calls`` the launches of the
    run (a batched launch is one array execution per expert); the series
    one row a step.  Then the captured step's ms with and without them, in
    turns (off, on, on, off), the device kernels, copies and syncs a
    replayed step that they add, and the cost of a swap to ``plan`` (the
    remap phase's) now that the context also rewrites the increment."""
    t0 = time.perf_counter()
    run = serve(bundle, "protected", bundle.lm.vocab, faults=bist, inject=inject, record_logits=True,
                counters=True, series=True)
    srv, steps, counts = run["server"], len(run["times"]), run["counts"]
    check(run["tokens"].keys() == prot["tokens"].keys()
          and all(np.array_equal(run["tokens"][r], prot["tokens"][r]) for r in prot["tokens"]),
          f"{arch} counters: tokens differ from the counters-off run")
    check(_same_bits(run["logits"], prot["logits"]), f"{arch} counters: logits differ from the counters-off run")
    check(counts == prot["counts"] and run["captures"] == 1, f"{arch} counters: launches {counts}, {run['captures']} captures")
    c = srv.counters_host()
    experts = bundle.lm.moe.n_padded if bundle.lm.moe else 1
    want_calls = counts["ft_matmul"] + experts * counts["ft_matmul_batched"]
    check(c["steps"] == steps and c["protected_calls"] == want_calls and c["plain_calls"] == 0,
          f"{arch} counters: {c['steps']} steps, {c['protected_calls']} protected calls; the run launched "
          f"{counts} in {steps} steps ({want_calls} array executions)")
    series = srv.series_host()
    check(all(len(v) == steps for v in series.values())
          and series["tokens"].tolist() == run["step_tokens"], f"{arch} series: {len(series['tokens'])} rows")
    timing = {"off": [], "on": []}
    for on in (False, True, True, False):
        r = serve(bundle, "protected", bundle.lm.vocab, faults=bist, inject=inject, counters=on, series=on)
        timing["on" if on else "off"].append(_steady(r)[0])
    graph = {k: kernels_per_replay(bundle, counters=on) for k, on in (("off", False), ("on", True))}
    swap = plan_swap_cost(bundle, plan)
    check(swap["increment_rewritten"], f"{arch} counters: a swap did not rewrite the increment")
    out = dict(arch=arch, steps=steps, counters=c, series_rows=len(series["tokens"]), counters_equal_off=True,
               step_ms_median_off=timing["off"], step_ms_median_on=timing["on"], replayed_step=graph,
               plan_swap_with_increment=swap,
               graph_kernels_added=graph["on"]["device_kernels"] - graph["off"]["device_kernels"],
               phase_s=time.perf_counter() - t0, card=smi)
    phase("serve_counters", **out)
    return out


# --------------------------------------------------------------------------- #
def time_cuda(fn, args_list, iters: int) -> float:
    """Mean ms per call over ``iters`` calls, cycling through ``args_list``
    (enough operand copies that the weights come from device memory, not
    L2), after a warm-up."""
    for a in args_list[:3]:
        fn(*a)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, args_list, iters: int, only: str | None = None) -> float | None:
    """Mean device (kernel) ms per call from ``torch.profiler``, without
    the host's launch overhead: of every kernel the call launches, or of
    those whose name holds ``only``; None when the profiler reports no
    device time.  The profiler can drop some device events of a window (on
    an H100 with torch 2.11 it reported 18 or 19 of 20 launches), so
    each kernel's mean time per reported launch is taken times its launches
    per call, not its reported total over the calls."""
    from torch.profiler import ProfilerActivity, profile

    for a in args_list[:3]:
        fn(*a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
        torch.cuda.synchronize()
    us = sum(_self_device_us(e) / e.count * -(-e.count // iters) for e in prof.key_averages()
             if (only is None or only in e.key) and _self_device_us(e) > 0)
    return us / 1e3 if us > 0 else None


def _self_device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", getattr(evt, "self_cuda_time_total", 0.0)))


def bound_ms(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def tflops(ops: float, ms: float) -> float:
    """Achieved TFLOP/s of ``ops`` operations in ``ms`` milliseconds."""
    return ops / (ms * 1e-3) / 1e12


def measure(fn, args_list, iters: int) -> tuple[float, float | None]:
    """(ms per call on the stream with the host's launch overhead, device
    ms per call from the profiler or None)."""
    return time_cuda(fn, args_list, iters), device_ms(fn, args_list, iters)


def _time_shape(kernel, plain, library, x, ws, and_g, or_g, lib_ws=None):
    copies = len(ws)
    iters = max(20, 4 * copies)
    c_k, d_k = measure(kernel, [(x, w, and_g, or_g) for w in ws], iters)
    c_p, d_p = measure(plain, [(x, w, and_g, or_g) for w in ws], max(10, copies))
    c_l, d_l = measure(library, [(x, w) for w in (lib_ws or ws)], iters)
    use_dev = None not in (d_k, d_p, d_l)
    t = (d_k, d_p, d_l) if use_dev else (c_k, c_p, c_l)
    return t, (c_k, c_p, c_l), "profiler" if use_dev else "events"


def time_kernel_shapes(dev, smi: str, arch: str, mm_shapes, expert_shapes, where: str) -> dict[str, dict]:
    """Kernel, plain and library times per shape of ``arch``'s path
    ``where`` (``decode_step`` or ``prefill``), and each matmul kernel's
    totals per ``where``.  ``ms`` is the device time from the profiler
    where it reports one (else the per-call time); ``call_ms`` is the time
    per call as a Python loop sees it.  Returns {kernel: totals}."""
    from repro_torch.kernels import ft_matmul as FM

    # the call the serving path makes: bf16 operands, the kernel's bf16 store;
    # for F32_X_SHAPES an f32 x and the f32 store (FTContext stores x's dtype),
    # the library call on the same x and an f32 copy of w (no one call takes
    # the mixed pair)
    def bf16_store(fn):
        return lambda x, w, a, o: fn(x, w, a, o, out_dtype=torch.bfloat16)

    g = torch.Generator(device=dev).manual_seed(1)
    and_g, or_g = fault_grids(dev)
    totals = {}
    suffix = "" if where == "decode_step" else f"_{where}"
    launches0 = {name: k.launches for name, k in _kernels().items()}
    for kname, shapes in (("ft_matmul", mm_shapes), ("ft_matmul_batched", expert_shapes)):
        if not shapes:
            continue
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, call_ms=0.0)
        for shape in shapes:
            name, per = shape[0], shape[-1]
            mixed = name in F32_X_SHAPES
            if kname == "ft_matmul":
                _, m, k, n, _ = shape
                e = 1
                head = name.startswith("head")
                x = torch.randn((m, k), generator=g, device=dev).to(torch.float32 if mixed else torch.bfloat16)

                def weight():
                    if head:
                        return (torch.randn((n, k), generator=g, device=dev) * 0.02).to(torch.bfloat16).T
                    return (torch.randn((k, n), generator=g, device=dev) * 0.02).to(torch.bfloat16)
                kernel, plain, library = bf16_store(FM.ft_matmul), bf16_store(FM.ft_matmul_ref), torch.matmul
                if mixed:
                    kernel, plain = FM.ft_matmul, FM.ft_matmul_ref
            else:
                _, e, m, k, n, _ = shape
                x = dispatch_view(torch.randn((m, e, 1, k), generator=g, device=dev).to(torch.bfloat16))

                def weight():
                    return (torch.randn((e, k, n), generator=g, device=dev) * 0.02).to(torch.bfloat16)
                kernel, plain, library = (bf16_store(FM.ft_matmul_batched), bf16_store(FM.ft_matmul_batched_ref),
                                          torch.bmm)
            w_bytes = 2 * e * k * n
            ws = [weight() for _ in range(max(1, min(64, -(-2 * L2_BYTES // w_bytes))))]
            lib_ws = [w.float() for w in ws] if mixed else None
            (t_k, t_p, t_l), (c_k, c_p, c_l), src = _time_shape(kernel, plain, library, x, ws, and_g, or_g, lib_ws)
            # x and w read once, the output (bf16, or f32 for an f32 x) written
            # once, the mask pair; a mixed pair runs on the CUDA cores
            out_b = 4 if mixed else 2
            nbytes = x.element_size() * e * m * k + w_bytes + out_b * e * m * n + 2 * 4 * ROWS * COLS
            b, by = bound_ms(nbytes, 2 * e * m * n * k, torch.float32 if mixed else torch.bfloat16)
            phase(f"time_{kname}{suffix}", arch=arch, shape=name, E=e, M=m, K=k, N=n, **{f"launches_per_{where}": per},
                  plan=_plan_str(FM.plan_of(x, ws[0])), x_dtype=str(x.dtype)[6:], out_dtype="f32" if mixed else "bf16",
                  ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b, bound_by=by,
                  bound_share=b / t_k, tflops=tflops(2 * e * m * n * k, t_k), call_ms=c_k, plain_call_ms=c_p,
                  library_call_ms=c_l, ms_source=src, card=smi)
            for key, v in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l), ("bound_ms", b), ("call_ms", c_k)):
                tot[key] += per * v
            del ws, lib_ws
        totals[kname] = dict(tot, **{f"launches_per_{where}": sum(s[-1] for s in shapes)})
        phase(f"time_{kname}_per_{where}", arch=arch, **totals[kname], card=smi)
    # timing launches are not main-path launches
    for name, k in _kernels().items():
        k.launches = launches0[name]
    return totals


def timing_phase(dev, smi: str, arch: str, runs) -> dict[str, dict]:
    """Kernel, plain and library times per decode shape of ``arch``
    (:func:`time_kernel_shapes`), then the captured protected decode step's
    time.  Returns {kernel: per-step totals}."""
    totals = time_kernel_shapes(dev, smi, arch, DECODE_SHAPES[arch], EXPERT_SHAPES[arch], "decode_step")
    prot = runs["protected"]
    ms, tps = _steady(prot)
    phase("time_decode_step", arch=arch, mode="protected", step="captured", steps=len(prot["times"]),
          step_ms_median=ms, step_ms_mean=1e3 * float(np.mean(prot["times"][2:])),
          kernel_ms_per_step={k: v["ms"] for k, v in totals.items()}, tokens_per_s=tps, card=smi)
    return totals


def time_probe_check(dev, smi: str) -> dict:
    """The probe kernels at the serving scan shape, one grid row (1, 8) @
    (8, 8): ``probe_check`` (one half of the pair), ``probe_check_pair`` (the
    scan step's one launch) and an empty kernel, the card's launch floor,
    each beside its plain version.  Returns the pair's row of the kernel
    table with the single probe's and the floor's times."""
    from repro_torch.kernels.dppu_recompute import (
        empty_launch, probe_check, probe_check_pair, probe_check_pair_ref, probe_check_ref,
    )

    g = torch.Generator(device=dev).manual_seed(1)
    px = torch.randint(-4, 8, (1, 8), generator=g, device=dev, dtype=torch.int32)
    pw = torch.randint(-4, 8, (8, COLS), generator=g, device=dev, dtype=torch.int32)
    ar = torch.randint(-4, 8, (1, COLS), generator=g, device=dev, dtype=torch.int32)
    ar_neg = torch.randint(-4, 8, (1, COLS), generator=g, device=dev, dtype=torch.int32)
    launches0 = (probe_check.launches, probe_check_pair.launches)
    timed = {}
    for name, fn, args in (
        ("probe_check", probe_check, (px, pw, ar)),
        ("probe_check_plain", lambda a, b, c: probe_check_ref(a, b, c, window=8), (px, pw, ar)),
        ("probe_check_pair", probe_check_pair, (px, pw, ar, ar_neg)),
        ("probe_check_pair_plain", lambda a, b, c, d: probe_check_pair_ref(a, b, c, d, window=8), (px, pw, ar, ar_neg)),
        ("empty_kernel", lambda: empty_launch(dev), ()),
    ):
        timed[name] = measure(fn, [args], 200)
    probe_check.launches, probe_check_pair.launches = launches0
    use_dev = all(d is not None for _, d in timed.values())
    t = {k: (d if use_dev else c) for k, (c, d) in timed.items()}
    # one probe: px, pw and one readback read, the flags written; the pair reads a second readback
    pb, pby = bound_ms(4 * (8 + 8 * COLS + COLS + COLS), 2 * 8 * COLS, torch.int32)
    pair_b, pair_by = bound_ms(4 * (8 + 8 * COLS + 2 * COLS + COLS), 2 * 2 * 8 * COLS, torch.int32)
    phase("time_probe_check", shape="1x8x8", ms=t["probe_check"], plain_ms=t["probe_check_plain"], bound_ms=pb,
          bound_by=pby, pair_ms=t["probe_check_pair"], pair_plain_ms=t["probe_check_pair_plain"],
          pair_bound_ms=pair_b, empty_kernel_ms=t["empty_kernel"],
          call_ms={k: c for k, (c, _) in timed.items()}, ms_source="profiler" if use_dev else "events", card=smi)
    return dict(ms=t["probe_check_pair"], plain_ms=t["probe_check_pair_plain"], bound_ms=pair_b, bound_by=pair_by,
                launch_floor_ms=t["empty_kernel"],
                single_probe=dict(ms=t["probe_check"], plain_ms=t["probe_check_plain"], bound_ms=pb, bound_by=pby))


LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch", "cuGraphLaunch")


def fused_call_launches(bundle) -> dict:
    """Protected ``FTContext.matmul`` calls at the served model's decode
    shape under ``dispatch="fused"``, profiled after a warm-up (mask grids
    cached): each must launch the kernel once and nothing else, with no cast
    after it, and return bf16 (the kernel's own store)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.engine import HyCAConfig, empty_fault_state
    from repro_torch.core.ftcontext import build_ftcontext
    from repro_torch.kernels import ft_matmul as FM

    dev = torch.device("cuda")
    d = bundle.lm.d_model
    ftc = build_ftcontext(empty_fault_state(1).to(dev), HyCAConfig(rows=ROWS, cols=COLS, mode="protected"),
                          dispatch="fused")
    x = torch.randn((4, 1, d), device=dev).to(torch.bfloat16)
    w = torch.randn((d, d), device=dev).to(torch.bfloat16)
    ftc.matmul(x, w, site="ffn")
    torch.cuda.synchronize()
    calls = 20
    launches0 = FM.ft_matmul.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        outs = [ftc.matmul(x, w, site="ffn") for _ in range(calls)]
        torch.cuda.synchronize()
    ka = prof.key_averages()
    got = dict(calls=calls, kernel_launches=FM.ft_matmul.launches - launches0,
               device_kernels=[[e.key[:60], e.count] for e in ka if _self_device_us(e) > 0],
               casts=sum(e.count for e in ka if e.key == "aten::_to_copy"), dtype=str(outs[0].dtype))
    FM.ft_matmul.launches = launches0
    # the profiler may drop device events of a short window; what it does
    # report must be the kernel alone
    check(got["kernel_launches"] == calls and got["casts"] == 0 and outs[0].dtype == torch.bfloat16
          and all("ft_strip" in k for k, _ in got["device_kernels"]),
          f"a fused bf16 matmul launched more than the kernel or was cast: {got}")
    return got


def _device_events(ka) -> list:
    """The device activity of a profile's averages: kernels, copies and
    fills.  A CPU op carries its kernels' device time too, so summing every
    entry would count each kernel twice."""
    from torch.autograd import DeviceType

    return [e for e in ka if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


def agreed_window(window, tries: int = 6):
    """A profiled window that every device record reached.  ``window()``
    profiles a fresh window and returns (its key averages, what it
    measured).  torch.profiler can lose device records of a window at
    random (on an H100 with torch 2.11 a window of four replayed qwen steps
    once reported 3 of its 4 pair probes while every ``ft_matmul`` record
    arrived) and never adds one, so windows are taken until the largest
    count of device events has been reported twice; the checks read that
    window.  Returns (key averages, measured, device events of each window
    taken).  Fails when no two windows agree in ``tries``."""
    seen, taken = [], []
    for _ in range(tries):
        ka, got = window()
        seen.append(sum(e.count for e in _device_events(ka)))
        taken.append((ka, got))
        if seen.count(max(seen)) == 2:  # only a window at the largest count can make it two
            return (*taken[-1], seen)
    check(False, f"no two of {tries} profiled windows reported the same device events: {seen}")


# the csrc kernels a served step launches, by the name the profiler reports
STEP_KERNEL_NAMES = {"ft_matmul.cu": ("ft_strip_kernel", "ft_strip_mma_kernel", "ft_kfast_kernel"),
                     "probe_check_pair": ("probe_check_pair_kernel",), "probe_check": ("probe_check_kernel",)}


def profile_phase(bundle, smi: str, *, capture: bool, steps: int = 4) -> dict:
    """Where a protected decode step's time goes, for the captured step
    (replays) or the eager one: wall time, device busy time (the device
    events' time, on the one stream), host launch calls and device kernels
    a step, each csrc kernel's device launches a step, and the top device
    kernels and host ops, from ``torch.profiler`` over ``steps`` steady
    steps (its schedule drops one warm-up step, so no event at the window's
    start is lost) of a window that every device record reached
    (``agreed_window``).  The captured step's csrc kernels must be exactly
    the main path's: the matmul kernels of ``per_step`` and one pair
    probe."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.serving import FaultInjector, FaultTolerantServer

    cfg = dataclasses.replace(bundle.cfg, mode="protected")

    def window():
        inj = FaultInjector(cfg.rows, cfg.cols, seed=cfg.seed + 1)
        inj.inject_at(0, 1, bit=30, val=1)
        srv = FaultTolerantServer(cfg, bundle=bundle, injector=inj, capture=None if capture else False)
        for t in trace(bundle.lm.vocab):
            srv.submit(t["prompt"], t["max_new_tokens"])
        for _ in range(2):  # the warm-up and capture, the first replay
            srv.step()
        torch.cuda.synchronize()
        wall = 0.0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=steps, repeat=1)) as prof:
            for i in range(1 + steps):
                t0 = time.perf_counter()
                srv.step()  # ends in the step's host sync
                if i:
                    wall += time.perf_counter() - t0
                prof.step()
        return prof.key_averages(), wall / steps

    ka, wall, seen = agreed_window(window)
    dev = _device_events(ka)
    dev_us = sum(_self_device_us(e) for e in dev)
    kernels = [e for e in dev if not e.key.startswith(("Memcpy", "Memset"))]
    per_kernel = {name: sum(e.count for e in kernels if any(re.search(rf"\b{k}[<(]", e.key) for k in keys)) / steps
                  for name, keys in STEP_KERNEL_NAMES.items()}
    want_mm = sum(per_step(bundle.lm.name).values())
    got = dict(arch=bundle.lm.name, step="captured" if capture else "eager", steps=steps, step_ms=1e3 * wall,
               window_device_events=seen,
               device_busy_ms=dev_us / 1e3 / steps, device_busy_share=(dev_us / 1e6 / steps) / wall,
               host_launch_calls_per_step=sum(e.count for e in ka if e.key in LAUNCH_KEYS) / steps,
               graph_launches_per_step=sum(e.count for e in ka if "GraphLaunch" in e.key) / steps,
               device_kernels_per_step=sum(e.count for e in kernels) / steps,
               device_copies_per_step=sum(e.count for e in dev if e.key.startswith(("Memcpy", "Memset"))) / steps,
               csrc_kernels_per_step=per_kernel,
               want_csrc_kernels_per_step={"ft_matmul.cu": want_mm, "probe_check_pair": 1},
               to_copy_per_step=sum(e.count for e in ka if e.key == "aten::_to_copy") / steps,
               top_kernels=[[e.key[:60], _self_device_us(e) / 1e3 / steps, e.count / steps]
                            for e in sorted(kernels, key=_self_device_us, reverse=True)[:8]],
               top_host_ops=[[e.key[:60], e.self_cpu_time_total / 1e3 / steps, e.count / steps]
                             for e in sorted(ka, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]],
               card=smi)
    if not capture:
        got["fused_call"] = fused_call_launches(bundle)
    phase("profile_decode_step", **got)
    if capture:
        check(per_kernel["ft_matmul.cu"] == want_mm and per_kernel["probe_check_pair"] == 1
              and per_kernel["probe_check"] == 0,
              f"{bundle.lm.name}: replayed steps ran {per_kernel} device kernels a step, want {want_mm} "
              f"ft_matmul.cu kernels and 1 probe_check_pair")
    return got


def replay_ms(bundle, replays: int = 20) -> float:
    """Device ms of one replay of the captured protected decode alone: CUDA
    events around ``replays`` back-to-back replays, no host work between
    them.  That is the graph's kernels and the gaps between its nodes."""
    from repro_torch.serving import FaultInjector, FaultTolerantServer

    cfg = dataclasses.replace(bundle.cfg, mode="protected")
    srv = FaultTolerantServer(cfg, bundle=bundle, injector=FaultInjector(cfg.rows, cfg.cols, seed=cfg.seed + 1))
    for t in trace(bundle.lm.vocab):
        srv.submit(t["prompt"], t["max_new_tokens"])
    for _ in range(2):  # the warm-up and capture, the first replay
        srv.step()
    launches0 = {name: k.launches for name, k in _kernels().items()}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        srv.decode()
    end.record()
    torch.cuda.synchronize()
    for name, k in _kernels().items():  # not main-path launches
        k.launches = launches0[name]
    return start.elapsed_time(end) / replays


def steady_phase(bundle, smi: str, busy_ms: dict, reps: int = 3) -> dict:
    """The protected 6-request trace ``reps`` times with the eager step and
    with the captured one, in turns (eager, captured, captured, eager, ...),
    in one call: each run's median step ms and tokens/s over its steps after
    the first two, and the capture's seconds and pool bytes.  The device
    busy share is ``busy_ms`` (each step's device time, from its profile)
    over the median of these unprofiled medians: under the profiler a
    replay's wall time grows with the tracing of each of its kernels.  A
    captured step splits into its graph replay (:func:`replay_ms`: busy
    time plus the gaps between the graph's nodes) and the host's work
    around it (the rest of the step)."""
    bist = [(0, 1, 30, 1), (2, 3, 31, 0), (3, 6, 20, 1)]
    rows = {"eager": [], "captured": []}
    for rep in range(reps):
        order = (False, None) if rep % 2 == 0 else (None, False)
        for capture in order:
            run = serve(bundle, "protected", bundle.lm.vocab, faults=bist, capture=capture)
            ms, tps = _steady(run)
            rows["eager" if capture is False else "captured"].append(dict(
                step_ms_median=ms, tokens_per_s=tps, capture_s=run["capture_s"], graph_pool_bytes=run["pool_bytes"]))
    out = {k: dict(step_ms_median=[r["step_ms_median"] for r in v], tokens_per_s=[r["tokens_per_s"] for r in v])
           for k, v in rows.items()}
    out["captured"].update(capture_s=[r["capture_s"] for r in rows["captured"]],
                           graph_pool_bytes=[r["graph_pool_bytes"] for r in rows["captured"]])
    for k, v in out.items():
        v.update(device_busy_ms=busy_ms[k], device_busy_share=busy_ms[k] / float(np.median(v["step_ms_median"])))
    graph = replay_ms(bundle)
    out["captured"].update(graph_replay_ms=graph, gaps_in_graph_ms=graph - busy_ms["captured"],
                           host_ms=float(np.median(out["captured"]["step_ms_median"])) - graph)
    phase("steady_decode_step", arch=bundle.lm.name, mode="protected", runs=reps, **out, card=smi)
    return out


# --------------------------------------------------------------------------- #
# the paper's two-pass pipeline (kernels/ops.py) at full width
# --------------------------------------------------------------------------- #
TP_ARRAY = 32                          # the paper's 32 x 32 PE array, grouped DPPU of 32
TP_TILE = dict(bm=128, bn=128, bk=128)
TP_M = 4096                            # a 4 x 1024-token prefill: all 32 PE rows own a tile row
TP_FIRST = [(31, 1), (31, 0), (30, 1), (30, 0), (0, 1), (1, 0), (2, 1), (3, 0)]
TP_OVER = [(30, 1), (31, 1), (4, 0), (9, 1), (14, 0), (19, 1), (22, 0), (31, 0)]


def _two_pass_kernels():
    from repro_torch.kernels.dppu_recompute import dppu_recompute
    from repro_torch.kernels.os_array_matmul import os_array_matmul

    return {"os_array_matmul": os_array_matmul, "dppu_recompute": dppu_recompute}


def two_pass_states():
    """(24-fault state, 40-fault state, HyCAConfig) on the 32 x 32 array with
    a DPPU of 32.  The 40 PEs are seeded draws from PE columns 0-7 (at
    N = 1024 the output has 8 tile columns, so every fault owns tiles at every
    shape); the 24-fault map is the 24 leftmost of them.  FPT entries 0-7
    carry bits 31 and 30 stuck-at-1 and -0 and low mantissa bits; entries
    32-39, which the DPPU cannot repair, carry stuck-ats that change about
    half of the outputs or more, so every tile they own shows."""
    from repro_torch.core.engine import FaultState, HyCAConfig
    from repro_torch.core.redundancy import DPPUConfig

    rng = np.random.default_rng(13)
    cells = rng.choice(TP_ARRAY * 8, size=40, replace=False)
    r, c = cells % TP_ARRAY, cells // TP_ARRAY
    order = np.lexsort((r, c))  # leftmost-first: column, then row
    fpt = np.stack([r[order], c[order]], axis=1).astype(np.int32)
    bits = rng.integers(0, 32, 40).astype(np.int32)
    vals = rng.integers(0, 2, 40).astype(np.int32)
    for i, (b, v) in list(enumerate(TP_FIRST)) + list(enumerate(TP_OVER, start=32)):
        bits[i], vals[i] = b, v
    hyca = HyCAConfig(rows=TP_ARRAY, cols=TP_ARRAY, dppu=DPPUConfig(size=32), mode="protected")
    check(hyca.capacity == 32, f"two-pass array: DPPU capacity {hyca.capacity}, not 32")

    def state(n):
        return FaultState(*(torch.from_numpy(a[:n].copy()) for a in (fpt, bits, vals)))

    return state(24), state(40), hyca


def two_pass_weights(bundle):
    """(name, w) of layer 0's q, up and down matrices and the tied head's
    ``table.T`` (a strided view) of the served qwen1.5-0.5b, bf16."""
    blk = bundle.work["blocks"][0]
    return (("q_1024x1024", blk["attn"]["wq"]), ("up_1024x2816", blk["ffn"]["up"]),
            ("down_2816x1024", blk["ffn"]["down"]), ("head_1024x152064", bundle.work["embed"].T))


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def two_pass_kernel_checks(dev, shapes, state, hyca) -> None:
    """Each two-pass kernel against its plain twin, bit for bit, on
    integer-valued bf16, f32 and int8 operands (every partial sum exact) at
    the four shapes, with the 24-fault grids and a hand-made tile table with
    -1 padding; at the q shape also at placement tiles (1, 1) and (128, 256).
    These launches are not main-path launches."""
    from repro_torch.kernels.dppu_recompute import dppu_recompute, dppu_recompute_plain
    from repro_torch.kernels.ops import fault_grids
    from repro_torch.kernels.os_array_matmul import os_array_matmul_plain

    g = torch.Generator(device=dev).manual_seed(4)
    bit, val, faulty, _ = fault_grids(state.to(dev), TP_ARRAY, TP_ARRAY, hyca.capacity)
    os_array_matmul = _two_pass_kernels()["os_array_matmul"]
    n_cmp = 0
    for name, w0 in shapes:
        k, n = w0.shape
        head = name.startswith("head")
        tiles = [(128, 128)] + ([(1, 1), (128, 256)] if name.startswith("q_") else [])
        for dtype in (torch.bfloat16, torch.float32, torch.int8):
            x = torch.randint(-4, 5, (TP_M, k), generator=g, device=dev).to(dtype)
            if head:
                w = torch.randint(-4, 5, (n, k), generator=g, device=dev).to(dtype).T
            else:
                w = torch.randint(-4, 5, (k, n), generator=g, device=dev).to(dtype)
            for bm, bn in tiles:
                got = os_array_matmul(x, w, bit, val, faulty, bm=bm, bn=bn, bk=128, rows=TP_ARRAY, cols=TP_ARRAY)
                want = os_array_matmul_plain(x, w, bit, val, faulty, bm=bm, bn=bn)
                check(_bits_equal(got, want), f"os_array_matmul {name} {dtype} ({bm}, {bn}): not bitwise equal to its twin")
                del got, want
                gm, gn = TP_M // bm, n // bn
                fpt = torch.tensor([[0, 0], [-1, -1], [gm - 1, gn - 1], [gm // 2, gn // 3], [-1, -1]],
                                   dtype=torch.int32)
                got = dppu_recompute(x, w, fpt, bm=bm, bn=bn, bk=128)
                want = dppu_recompute_plain(x, w, fpt, bm=bm, bn=bn)
                check(_bits_equal(got, want), f"dppu_recompute {name} {dtype} ({bm}, {bn}): not bitwise equal to its twin")
                check(_bits_equal(got[1], got[0]) and _bits_equal(got[4], got[0]),
                      f"dppu_recompute {name}: a padded entry is not tile (0, 0)")
                n_cmp += 2
                del got, want
            del x, w
    phase("two_pass_kernels", shapes=[s[0] for s in shapes], M=TP_M, dtypes=["bf16", "f32", "int8"],
          placements=["(128, 128) at every shape", "(1, 1) and (128, 256) at q"], comparisons=n_cmp,
          bitwise=True, faults=int((state.fpt[:, 0] >= 0).sum()))


def _tile_map(t: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    """(M // bm, N // bn) bool: which tiles of an (M, N) bool map hold a True."""
    m, n = t.shape
    return t.view(m // bm, bm, n // bn, bn).any(dim=3).any(dim=1)


def two_pass_main_path(dev, shapes, xs, s24, s40, hyca) -> dict[str, int]:
    """The main path of the kernel tier at the four shapes on the qwen
    weights: the fault-free array, the twopass with 24 faults (bitwise equal
    to it), pass 1 alone (corrupted, exactly the tile epilogue of the clean
    product), the twopass with 40 faults (exactly the tiles of the 8 PEs the
    DPPU cannot repair differ) and the fused single pass (bitwise equal to the
    twopass).  Every call's launches are held to 1 os_array_matmul plus 1
    dppu_recompute when there is a tile to recompute.  Returns the counts."""
    from repro_torch.core.engine import apply_mask_grids, empty_fault_state
    from repro_torch.kernels import ops
    from repro_torch.kernels.os_array_matmul import _tile_grids, stuck_at_mask_grids

    kern = _two_pass_kernels()
    empty = empty_fault_state(1)
    unrep = torch.zeros((TP_ARRAY, TP_ARRAY), dtype=torch.bool)
    for r, c in s40.fpt[hyca.capacity:].tolist():
        unrep[r, c] = True
    bit24, val24, faulty24, _ = ops.fault_grids(s24, TP_ARRAY, TP_ARRAY, hyca.capacity)
    and24, or24 = (t.to(dev) for t in stuck_at_mask_grids(bit24, val24, faulty24))
    for k in kern.values():
        k.launches = 0
    for name, w in shapes:
        x = xs[w.shape[0]]
        m, n = x.shape[0], w.shape[1]
        gm, gn = m // TP_TILE["bm"], n // TP_TILE["bn"]

        def run(fn, state, os_n, dppu_n):
            before = {k: v.launches for k, v in kern.items()}
            out = fn(x, w, state, hyca, **TP_TILE)
            torch.cuda.synchronize()
            got = {k: v.launches - before[k] for k, v in kern.items()}
            check(got == {"os_array_matmul": os_n, "dppu_recompute": dppu_n},
                  f"{name} {fn.__name__}: launches {got}, want {os_n} + {dppu_n}")
            check(tuple(out.shape) == (m, n) and out.dtype == torch.float32, f"{name} {fn.__name__}: output")
            return out

        clean = run(ops.hyca_protected_matmul_twopass, empty, 1, 0)
        check(bool(torch.isfinite(clean).all()), f"{name}: non-finite fault-free output")
        out = run(ops.hyca_protected_matmul_twopass, s24, 1, 1)
        check(_bits_equal(out, clean), f"{name}: twopass with 24 faults differs from the fault-free array")
        del out
        out = run(ops.faulty_array_matmul, s24, 1, 0)
        ri, ci = _tile_grids(m, n, TP_TILE["bm"], TP_TILE["bn"], TP_ARRAY, TP_ARRAY, dev)
        check(_bits_equal(out, apply_mask_grids(clean, and24, or24, row_residue=ri, col_residue=ci)),
              f"{name}: pass 1 is not the tile epilogue of the fault-free product")
        check(not _bits_equal(out, clean), f"{name}: the 24 faults do not show in pass 1")
        del out
        two = run(ops.hyca_protected_matmul_twopass, s40, 1, 1)
        want_tiles = unrep[torch.arange(gm) % TP_ARRAY][:, torch.arange(gn) % TP_ARRAY].to(dev)
        differs = _tile_map(two.view(torch.int32) != clean.view(torch.int32), TP_TILE["bm"], TP_TILE["bn"])
        check(bool(want_tiles.any()) and torch.equal(differs, want_tiles),
              f"{name}: with 40 faults the differing tiles are not those of the 8 unrepaired PEs")
        fused = run(ops.hyca_protected_matmul_fused, s40, 1, 0)
        check(_bits_equal(fused, two), f"{name}: fused differs from twopass (40 faults)")
        del clean, two, fused
    counts = {k: v.launches for k, v in kern.items()}
    phase("two_pass", shapes=[s[0] for s in shapes], M=TP_M, array=f"{TP_ARRAY}x{TP_ARRAY}", capacity=hyca.capacity,
          launches=counts, twopass_24_equals_fault_free=True, twopass_40_differs_in_unrepaired_tiles=True,
          fused_equals_twopass=True)
    return counts


def two_pass_integer_fused(dev, shapes, s24, s40, hyca) -> None:
    """``hyca_protected_matmul_fused`` bitwise equal to the twopass on
    integer-valued bf16 operands at the four shapes (24 and 40 faults)."""
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(5)
    for name, w0 in shapes:
        k, n = w0.shape
        x = torch.randint(-4, 5, (TP_M, k), generator=g, device=dev).to(torch.bfloat16)
        w = torch.randint(-4, 5, (k, n), generator=g, device=dev).to(torch.bfloat16)
        for st in (s24, s40):
            two = ops.hyca_protected_matmul_twopass(x, w, st, hyca, **TP_TILE)
            fused = ops.hyca_protected_matmul_fused(x, w, st, hyca, **TP_TILE)
            check(_bits_equal(two, fused), f"{name}: fused differs from twopass on integer-valued operands")
            del two, fused
    phase("two_pass_fused_integer", shapes=[s[0] for s in shapes], faults=[24, 40], bitwise=True)


def _tile_bytes_ops(x, w, fpt, bm, bn) -> tuple[int, int]:
    """Bytes (each distinct x row-panel and w column-panel read once, the
    tiles written once) and operations of a recompute of these tiles."""
    k = x.shape[1]
    f = fpt.shape[0]
    xp = len({ti for ti, _ in fpt.clamp_min(0).tolist()})
    wp = len({tj for _, tj in fpt.clamp_min(0).tolist()})
    return x.element_size() * k * (xp * bm + wp * bn) + 4 * f * bm * bn + 8 * f, 2 * f * bm * bn * k


def two_pass_timing(dev, smi, shapes, xs, s24, hyca) -> tuple[dict, dict, dict]:
    """On the qwen weights (bf16): each kernel within RAND_TOL * (|x| @ |w|)
    of its twin (TF32 off), a recomputed tile bitwise equal to the fault-free
    array there; then per shape the kernel's device time, its bound, its
    plain twin's and the library call's (``torch.matmul`` of the same bf16
    product; ``torch.bmm`` of the pre-gathered bf16 panels for the
    recompute).  The bound takes the bf16 tensor-core peak, since the
    operands are bf16.  Launches here are not main-path launches.  Returns
    (os_array_matmul row, dppu_recompute row, max errors)."""
    from repro_torch.kernels.dppu_recompute import dppu_recompute_plain, tile_panels
    from repro_torch.kernels.ops import fault_grids, tile_fault_table
    from repro_torch.kernels.os_array_matmul import os_array_matmul_plain

    kern = _two_pass_kernels()
    launches0 = {k: v.launches for k, v in kern.items()}
    os_k, dppu_k = kern["os_array_matmul"], kern["dppu_recompute"]
    bit, val, faulty, _ = (t.to(dev) for t in fault_grids(s24, TP_ARRAY, TP_ARRAY, hyca.capacity))
    healthy = torch.zeros_like(faulty)
    bm, bn = TP_TILE["bm"], TP_TILE["bn"]
    geo = dict(rows=TP_ARRAY, cols=TP_ARRAY, **TP_TILE)
    rows = {"os_array_matmul": {}, "dppu_recompute": {}}
    err = {"os_array_matmul": 0.0, "dppu_recompute": 0.0}
    rel = {"os_array_matmul": 0.0, "dppu_recompute": 0.0}
    for name, w in shapes:
        x = xs[w.shape[0]]
        m, k, n = x.shape[0], x.shape[1], w.shape[1]
        fpt = torch.tensor(tile_fault_table(s24, hyca, m // bm, n // bn), dtype=torch.int32)
        # tolerance against the twins
        clean = os_k(x, w, bit, val, healthy, **geo)
        diff = clean - os_array_matmul_plain(x, w, bit, val, healthy, bm=bm, bn=bn)
        diff.abs_()
        scale = torch.matmul(x.float().abs(), w.float().abs()).add_(1e-30)
        e, r = float(diff.max()), float((diff / scale).max())
        check(r <= RAND_TOL, f"os_array_matmul {name}: {r} of |x|@|w| from its twin, beyond {RAND_TOL}")
        err["os_array_matmul"], rel["os_array_matmul"] = max(err["os_array_matmul"], e), max(rel["os_array_matmul"], r)
        del diff, scale
        tiles = dppu_k(x, w, fpt, **TP_TILE)
        plain = dppu_recompute_plain(x, w, fpt, bm=bm, bn=bn)
        tscale = dppu_recompute_plain(x.abs(), w.abs(), fpt, bm=bm, bn=bn).add_(1e-30)
        tdiff = (tiles - plain).abs_()
        e, r = float(tdiff.max()), float((tdiff / tscale).max())
        check(r <= RAND_TOL, f"dppu_recompute {name}: {r} of |x|@|w| from its twin, beyond {RAND_TOL}")
        err["dppu_recompute"], rel["dppu_recompute"] = max(err["dppu_recompute"], e), max(rel["dppu_recompute"], r)
        ti, tj = fpt[:, 0].tolist(), fpt[:, 1].tolist()
        for f in range(0, len(ti), max(1, len(ti) // 16)):
            check(_bits_equal(tiles[f], clean[ti[f] * bm:(ti[f] + 1) * bm, tj[f] * bn:(tj[f] + 1) * bn]),
                  f"dppu_recompute {name}: tile {f} differs from the fault-free array")
        del clean, tiles, plain, tscale, tdiff
        # times
        iters = 10
        c_k, d_k = measure(lambda a, b: os_k(a, b, bit, val, faulty, **geo), [(x, w)], iters)
        c_p, d_p = measure(lambda a, b: os_array_matmul_plain(a, b, bit, val, faulty, bm=bm, bn=bn), [(x, w)], iters)
        c_l, d_l = measure(torch.matmul, [(x, w)], iters)
        use_dev = None not in (d_k, d_p, d_l)
        t = (d_k, d_p, d_l) if use_dev else (c_k, c_p, c_l)
        # the kernel alone, without the wrapper's kernels that build its mask grids
        alone = device_ms(lambda a, b: os_k(a, b, bit, val, faulty, **geo), [(x, w)], iters, only="os_array_matmul_wgmma")
        b, by = bound_ms(2 * (m * k + k * n) + 4 * m * n + 2 * 4 * TP_ARRAY * TP_ARRAY, 2 * m * n * k, torch.bfloat16)
        rows["os_array_matmul"][name] = dict(M=m, K=k, N=n, ms=t[0], plain_ms=t[1], library_ms=t[2], bound_ms=b,
                                             bound_by=by, call_ms=c_k, kernel_alone_ms=alone,
                                             ms_source="profiler" if use_dev else "events")
        phase("time_os_array_matmul", shape=name, **rows["os_array_matmul"][name], bound_share=b / t[0],
              tflops=tflops(2 * m * n * k, t[0]), kernel_alone_tflops=alone and tflops(2 * m * n * k, alone), card=smi)
        tr, tc = tile_panels(fpt, bm, bn, dev)
        xs_g, ws_g = x[tr], w[:, tc].permute(1, 0, 2)  # the pre-gathered bf16 panels
        c_k, d_k = measure(lambda a, b: dppu_k(a, b, fpt, **TP_TILE), [(x, w)], iters)
        c_p, d_p = measure(lambda a, b: dppu_recompute_plain(a, b, fpt, bm=bm, bn=bn), [(x, w)], iters)
        c_l, d_l = measure(torch.bmm, [(xs_g, ws_g)], iters)
        use_dev = None not in (d_k, d_p, d_l)
        t = (d_k, d_p, d_l) if use_dev else (c_k, c_p, c_l)
        nbytes, ops_ = _tile_bytes_ops(x, w, fpt, bm, bn)
        b, by = bound_ms(nbytes, ops_, torch.bfloat16)
        rows["dppu_recompute"][name] = dict(F=fpt.shape[0], K=k, ms=t[0], plain_ms=t[1], library_ms=t[2], bound_ms=b,
                                            bound_by=by, call_ms=c_k, ms_source="profiler" if use_dev else "events")
        phase("time_dppu_recompute", shape=name, **rows["dppu_recompute"][name], bound_share=b / t[0],
              tflops=tflops(ops_, t[0]), card=smi)
        del xs_g, ws_g
    for k, v in kern.items():
        v.launches = launches0[k]
    phase("two_pass_tolerance", random_tol=f"{RAND_TOL}*(|x|@|w|)", tf32=torch.backends.cuda.matmul.allow_tf32,
          max_abs_err=err, max_err_over_scale=rel, peak="bf16 989 TFLOP/s (bf16 operands)")
    return rows["os_array_matmul"], rows["dppu_recompute"], err


def two_pass_phase(dev, smi, bundle) -> dict:
    """The kernel tier's phase: checks, the main path with its launch counts,
    tolerance and times.  Returns {kernel: its row of the kernel table}."""
    shapes = two_pass_weights(bundle)
    s24, s40, hyca = two_pass_states()
    two_pass_kernel_checks(dev, shapes, s24, hyca)
    two_pass_integer_fused(dev, shapes, s24, s40, hyca)
    g = torch.Generator(device=dev).manual_seed(6)
    # activations of a 4 x 1024-token prefill, one per input width
    xs = {k: torch.randn((TP_M, k), generator=g, device=dev).to(torch.bfloat16) for k in sorted({w.shape[0] for _, w in shapes})}
    counts = two_pass_main_path(dev, shapes, xs, s24, s40, hyca)
    os_rows, dppu_rows, err = two_pass_timing(dev, smi, shapes, xs, s24, hyca)
    out = {}
    for name, per, replaces in (("os_array_matmul", os_rows, "src/repro/kernels/os_array_matmul.py:57"),
                                ("dppu_recompute", dppu_rows, "src/repro/kernels/dppu_recompute.py:49")):
        # one call at each of the four shapes: the pipeline over layer 0's q, up, down and the head
        out[name] = {"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{name}.cu",
                     "replaces": replaces, "launches": counts[name], "max_abs_err": err[name],
                     **{key: sum(p[key] for p in per.values()) for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
                     "bound_by": "operations" if all(p["bound_by"] == "operations" for p in per.values()) else "bytes",
                     "per_shape": per}
    return out


# --------------------------------------------------------------------------- #
# transients and the rest of detection (on the served qwen1.5-0.5b)
# --------------------------------------------------------------------------- #
# |lane on the card - lane on the CPU| <= ABFT_TOL * its magnitude: (|colsum x|
# @ |w|) for chk_row, (|x| @ rowsum |w|) for chk_col.  Two f32 reductions in
# different orders over K <= 2816 (and N = 152064 for wc) differ by a few ulps
# of that magnitude.
ABFT_TOL = 1e-5
# four faults on PE rows 0-3 (a 4-row matmul reaches them): the DPPU (4)
# repairs them all; the unprotected fault is a stuck-at-1 on the sign bit of
# PE(1, 3), which manifests on its positive outputs
ABFT_CAPACITY = ((0, 0, 30, 1), (1, 2, 31, 0), (2, 5, 22, 1), (3, 7, 29, 1))
ABFT_UNPROTECTED = ((1, 3, 31, 1),)
ABFT_SERVE_FAULT = (5, 3, 30, 1)   # appears at step 2 on a PE row a 4-slot step never reaches


def _fault_state(faults, dev):
    from repro_torch.core.engine import FaultState

    n = len(faults) + 2
    fpt = torch.full((n, 2), -1, dtype=torch.int32)
    bit = torch.zeros(n, dtype=torch.int32)
    val = torch.zeros_like(bit)
    for i, (r, c, b, v) in enumerate(sorted(faults, key=lambda f: (f[1], f[0]))):
        fpt[i, 0], fpt[i, 1], bit[i], val[i] = r, c, b, v
    return FaultState(fpt, bit, val).to(dev)


def _abft_ctx(faults, mode, dev):
    from repro_torch.core.engine import HyCAConfig
    from repro_torch.core.ftcontext import ProtectPolicy, build_ftcontext
    from repro_torch.core.redundancy import DPPUConfig

    hyca = HyCAConfig(rows=ROWS, cols=COLS, dppu=DPPUConfig(size=4, group_size=4), mode=mode)
    return build_ftcontext(_fault_state(faults, dev), hyca, policy=ProtectPolicy(abft=True), dispatch="fused")


def _lane_err(x, w, lanes, cpu_lanes) -> float:
    """max |card lane - CPU lane| over its magnitude (ABFT_TOL's scale)."""
    xa, wa = x.float().abs(), w.float().abs()
    scales = (xa.sum(0, keepdim=True) @ wa, xa @ wa.sum(-1, keepdim=True))
    return max(float(((a.cpu() - b).abs() / (s.cpu() + 1e-30)).max())
               for a, b, s in zip(lanes, cpu_lanes, scales))


def abft_lanes_phase(dev, smi, bundle) -> dict:
    """``FTContext.abft_matmul`` under ``fused`` on layer 0's q, up and down
    and the head's table.T at M = 4, f32 masters then the bf16 working
    copies: ``out`` bitwise ``FTContext.matmul``'s, one ft_matmul launch a
    call; the lanes within ABFT_TOL of the same call on the CPU.  At f32: no
    flag fault-free or with DPPU-capacity faults, chk_row flags the faulty
    column class under an unprotected stuck-at, chk_col flags every row after
    a weight flip (bit 30, after encoding).  At bf16 the flag counts are
    printed, not asserted (the kernel's bf16 store rounds each output)."""
    from repro_torch.core.engine import abft_encode
    from repro_torch.kernels.ft_matmul import ft_matmul
    from repro_torch.transient import abft_check, flip_bits

    t0 = time.perf_counter()
    blk = bundle.params["blocks"][0]
    f32 = (("q_1024x1024", blk["attn"]["wq"]), ("up_1024x2816", blk["ffn"]["up"]),
           ("down_2816x1024", blk["ffn"]["down"]), ("head_1024x152064", bundle.params["embed"].T))
    g = torch.Generator(device=dev).manual_seed(11)
    scenarios = {"fault_free": ((), "protected"), "capacity": (ABFT_CAPACITY, "protected"),
                 "unprotected": (ABFT_UNPROTECTED, "unprotected")}
    ctxs = {(name, d): _abft_ctx(f, mode, d) for name, (f, mode) in scenarios.items() for d in (dev, "cpu")}
    err, flags = 0.0, {}
    for dtype, shapes in ((torch.float32, f32), (torch.bfloat16, two_pass_weights(bundle))):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for name, w in shapes:
            x = torch.randn((4, w.shape[0]), generator=g, device=dev).to(dtype)
            wc = abft_encode(w)
            xc, wcpu, wcc = x.cpu(), w.cpu(), wc.cpu()
            for sc in scenarios:
                ctx = ctxs[(sc, dev)]
                n0 = ft_matmul.launches
                out, chk_row, chk_col = ctx.abft_matmul(x, w, site="ffn", wc=wc)
                check(ft_matmul.launches - n0 == 1, f"abft_lanes {tag} {name} {sc}: {ft_matmul.launches - n0} launches")
                check(_bits_equal(out, ctx.matmul(x, w, site="ffn")),
                      f"abft_lanes {tag} {name} {sc}: out differs from FTContext.matmul")
                _, *cpu_lanes = ctxs[(sc, "cpu")].abft_matmul(xc, wcpu, site="ffn", wc=wcc)
                e = _lane_err(x, w, (chk_row, chk_col), cpu_lanes)
                check(e <= ABFT_TOL, f"abft_lanes {tag} {name} {sc}: lanes {e} of their magnitude from the CPU's")
                err = max(err, e)
                res = abft_check(out, chk_row, chk_col)
                cols = torch.nonzero(res["col_flags"]).flatten().cpu()
                n_rows = int(res["row_flags"].sum())
                flags[f"{tag}/{name}/{sc}"] = [len(cols), n_rows]
                if tag == "f32" and sc != "unprotected":
                    check(not bool(res["detected"]), f"abft_lanes f32 {name} {sc}: flags {len(cols)} cols {n_rows} rows")
                if tag == "f32" and sc == "unprotected":
                    check(len(cols) > 0 and bool((cols % COLS == 3).all()),
                          f"abft_lanes f32 {name}: chk_row flagged columns {cols.tolist()[:8]}")
            # a weight bit flipped after encode: the exponent's top bit (30 of
            # an f32 word, 14 of a bf16 word), which every |w| < 2 has clear
            top = 30 if tag == "f32" else 14
            w_f = flip_bits(w, [w.shape[1] * 7 + 5], [top])
            out, chk_row, chk_col = ctxs[("fault_free", dev)].abft_matmul(x, w_f, site="ffn", wc=wc)
            res = abft_check(out, chk_row, chk_col)
            flags[f"{tag}/{name}/weight_flip"] = [int(res["col_flags"].sum()), int(res["row_flags"].sum())]
            if tag == "f32":
                check(bool(res["row_flags"].all()), f"abft_lanes f32 {name}: weight flip flags rows "
                      f"{res['row_flags'].tolist()}")
    out = dict(shapes=[s[0] for s in f32], M=4, array=f"{ROWS}x{COLS}", dppu=4, tol=f"{ABFT_TOL}*magnitude",
               max_lane_err_vs_cpu=err, flags_cols_rows=flags,
               bf16_fault_free_flags={k: v for k, v in flags.items() if k.startswith("bf16") and k.endswith("fault_free")},
               seconds=time.perf_counter() - t0, card=smi)
    phase("abft_lanes", **out)
    return out


def serve_abft_phase(dev, smi, bundle) -> dict:
    """The captured qwen server, protected and fused, with the ABFT canary:
    no BIST faults, ABFT_SERVE_FAULT appears at step 2.  Tokens and every
    step's logits bitwise the canary-off run's, one capture, the main path's
    launches a step (169 ft_matmul, 1 probe_check_pair), no alarm before
    step 2; the first alarm against the scan's suspect and confirm steps,
    and the median step ms with the canary on and off, in turns."""
    t0 = time.perf_counter()
    vocab, inject = bundle.lm.vocab, ((2, ABFT_SERVE_FAULT),)
    on = serve(bundle, "protected", vocab, inject=inject, record_logits=True, abft=True)
    off = serve(bundle, "protected", vocab, inject=inject, record_logits=True, abft=False)
    steps, counts = len(on["times"]), on["counts"]
    check(on["tokens"].keys() == off["tokens"].keys()
          and all(np.array_equal(on["tokens"][r], off["tokens"][r]) for r in off["tokens"]),
          "serve_abft: tokens differ from the canary-off run")
    check(_same_bits(on["logits"], off["logits"]), "serve_abft: logits differ from the canary-off run")
    check(on["captures"] == 1 and on["replays"] == steps - 1,
          f"serve_abft: {on['captures']} captures and {on['replays']} replays in {steps} steps")
    check(counts == off["counts"] and counts["ft_matmul"] == per_step(QWEN)["ft_matmul"] * steps
          and counts["probe_check_pair"] == steps, f"serve_abft: launched {counts} in {steps} steps")
    log, mgr = on["server"].log, on["server"].manager
    alarms = [e.step for e in log.of_kind("abft.alarm")]
    check(alarms and min(alarms) == 2, f"serve_abft: alarms at steps {alarms[:4]}")
    check(off["server"].manager.abft_alarms == 0, "serve_abft: the canary-off run alarmed")
    r, c = ABFT_SERVE_FAULT[:2]
    at = {k: [e.step for e in log.of_kind(f"fault.{k}") if (e.data["row"], e.data["col"]) == (r, c)]
          for k in ("suspect", "confirmed")}
    check(bool(at["confirmed"]), "serve_abft: the scan never confirmed the fault")
    timing = {"off": [], "on": []}
    for abft in (False, True, True, False):
        run = serve(bundle, "protected", vocab, inject=inject, abft=abft)
        timing["on" if abft else "off"].append(_steady(run)[0])
    # the canary alone, on the host clock, with the fault present (it alarms)
    alarms_seen = mgr.abft_alarms
    t = time.perf_counter()
    for _ in range(200):
        mgr.abft_check()
    canary_ms = 1e3 * (time.perf_counter() - t) / 200
    out = dict(steps=steps, launches=counts, captures=on["captures"], equals_canary_off=True,
               abft_alarms=alarms_seen, canary_host_ms=canary_ms, first_alarm_step=min(alarms), injected_step=2,
               scan_suspect_step=at["suspect"][0] if at["suspect"] else None, scan_confirmed_step=at["confirmed"][0],
               canary_latency_steps=min(alarms) - 2, scan_confirm_latency_steps=at["confirmed"][0] - 2,
               step_ms_median_off=timing["off"], step_ms_median_on=timing["on"],
               seconds=time.perf_counter() - t0, card=smi)
    phase("serve_abft", **out)
    return out


def coverage_phase(dev, smi) -> dict:
    """``run_coverage`` at the detector-coverage benchmark's spec on the card:
    its counts equal the CPU run's exactly (int32 datapath), the benchmark's
    five coverage claims hold, one build a class; then each class's seconds
    (build plus first draw, and a second draw through the built program)."""
    from repro_torch.transient.coverage import DETECTORS, FAULT_CLASSES, CoverageSpec, run_class, run_coverage

    t0 = time.perf_counter()
    spec = CoverageSpec(n_configs=256, seed=7)
    card = run_coverage(spec, device=dev)
    card_s = time.perf_counter() - t0
    cpu = run_coverage(spec, device="cpu")

    def counts(rep):
        return {fc: (c["n_corrupted"], [c["detectors"][d]["n_detected"] for d in DETECTORS])
                for fc, c in rep["classes"].items()}

    check(counts(card) == counts(cpu) and card["matrix"] == cpu["matrix"],
          f"coverage: the card's counts {counts(card)} differ from the CPU's {counts(cpu)}")
    cov = {(r["fault_class"], r["detector"]): r["coverage"] for r in card["matrix"]}
    claims = {
        "scan_permanent>=0.9": cov[("permanent", "scan")] >= 0.9,
        "scan_weight==0": cov[("transient_weight", "scan")] == 0.0,
        "verify_weight==0": cov[("transient_weight", "verify")] == 0.0,
        "abft_weight>=0.5_and_scan+0.3": cov[("transient_weight", "abft")] >= 0.5
        and cov[("transient_weight", "abft")] >= cov[("transient_weight", "scan")] + 0.3,
        "abft_mac>=scan+0.2": cov[("transient_mac", "abft")] >= cov[("transient_mac", "scan")] + 0.2,
    }
    check(all(claims.values()), f"coverage claims: {claims}")
    check(all(n == 1 for n in card["retraces"].values()), f"coverage builds: {card['retraces']}")
    per_class, programs = {}, {}
    for fc in FAULT_CLASSES:
        t = time.perf_counter()
        run_class(spec, fc, programs=programs, device=dev)
        first = time.perf_counter() - t
        t = time.perf_counter()
        run_class(spec, fc, seed=spec.seed + 1, programs=programs, device=dev)
        per_class[fc] = dict(build_and_first_s=first, second_draw_s=time.perf_counter() - t)
    out = dict(spec=dataclasses.asdict(spec), counts=counts(card), coverage={f"{a}/{b}": v for (a, b), v in cov.items()},
               claims=claims, builds=card["retraces"], equals_cpu=True, run_coverage_s=card_s, per_class=per_class,
               seconds=time.perf_counter() - t0, card=smi)
    phase("coverage", **out)
    return out


def verify_phase(dev, smi, bundle) -> dict:
    """``OnlineVerifier.check_block`` over one sweep of the occupied grid on
    an unprotected ``ft_matmul`` output at qwen's up shape (4 x 1024 ->
    2816, f32) with one stuck-at (the sign bit of PE(2, 5), stuck at the
    complement of what output (2, 5) holds): exactly [(2, 5)] in the block
    that holds it, nothing elsewhere and nothing fault-free; then
    ``scan_array`` on the paper's 32 x 32 array at visibility 1.0: no false
    positive or negative."""
    from repro_torch.core.detection import scan_array
    from repro_torch.core.engine import HyCAConfig, fault_mask_grids, fault_meta_grid
    from repro_torch.kernels.ft_matmul import ft_matmul
    from repro_torch.runtime import OnlineVerifier

    t0 = time.perf_counter()
    w = bundle.params["blocks"][0]["ffn"]["up"]
    x = torch.randn((4, w.shape[0]), generator=torch.Generator(device=dev).manual_seed(12), device=dev)
    hyca = HyCAConfig(rows=ROWS, cols=COLS, mode="unprotected")
    clean = ft_matmul(x, w, *fault_mask_grids(fault_meta_grid(_fault_state((), dev), hyca)))
    r, c = 2, 5
    sign = int(bool(clean[r, c] < 0))
    out = ft_matmul(x, w, *fault_mask_grids(fault_meta_grid(_fault_state(((r, c, 31, 1 - sign),), dev), hyca)))
    v, v0 = OnlineVerifier(rows=ROWS, cols=COLS), OnlineVerifier(rows=ROWS, cols=COLS)
    n_blocks = v.occupied(*out.shape)[0]
    faulty = [v.check_block(x, w, out) for _ in range(n_blocks)]
    clean_runs = [v0.check_block(x, w, clean) for _ in range(n_blocks)]
    check(faulty == [(False, [(r, c)]) if i == r else (True, []) for i in range(n_blocks)],
          f"verify: check_block over one sweep gave {faulty}")
    check(all(ok for ok, _ in clean_runs), f"verify: fault-free check_block flagged {clean_runs}")
    rng = np.random.default_rng(0)
    fmap = rng.random((32, 32)) < 0.05
    res = scan_array(rng, fmap, fault_visibility=1.0, device=dev)
    check(res.false_positives == 0 and res.false_negatives == 0 and bool((res.detected == fmap).all()),
          f"verify: scan_array fp {res.false_positives} fn {res.false_negatives}")
    out_d = dict(shape="up_1024x2816", M=4, fault=[r, c, 31, 1 - sign], blocks=n_blocks, flagged=faulty[r][1],
                 fault_free_flags=0, scan_array_faults=int(fmap.sum()), scan_array_fp=res.false_positives,
                 scan_array_fn=res.false_negatives, seconds=time.perf_counter() - t0, card=smi)
    phase("verify", **out_d)
    return out_d


def transients_phase(dev, smi, bundle) -> None:
    """The transients slice on the served qwen bundle: abft_lanes,
    serve_abft, coverage and verify."""
    abft_lanes_phase(dev, smi, bundle)
    serve_abft_phase(dev, smi, bundle)
    coverage_phase(dev, smi)
    verify_phase(dev, smi, bundle)


# --------------------------------------------------------------------------- #
# the training and prefill slice: the sequence forward, the loss, AdamW, the
# train step, checkpoints and the retrain repair
# --------------------------------------------------------------------------- #
# (B, S) of each model's fused prefill: 4 sequences of 512 tokens; llava one
# of 3072, a multiple of the query block that holds its 2880 patches; whisper
# 4 of 448 tokens through the decoder over 4 x 1500 frames through the encoder
PREFILL = {QWEN: (4, 512), GRANITE: (4, 512), MINICPM3: (4, 512), LLAVA: (1, 3072), WHISPER: (4, 448),
           RWKV6: (4, 512), ZAMBA2: (4, 512)}
# (name, M, K, N, launches per prefill) of each model's ft_matmul calls in the
# fused prefill: M = B·S, the head at M = B (last_only)
PREFILL_SHAPES = {
    QWEN: (
        ("qkv_2048x1024x1024", 2048, 1024, 1024, 24 * 3),
        ("out_2048x1024x1024", 2048, 1024, 1024, 24),
        ("up_gate_2048x1024x2816", 2048, 1024, 2816, 24 * 2),
        ("down_2048x2816x1024", 2048, 2816, 1024, 24),
        ("head_4x1024x152064", 4, 1024, 152064, 1),
    ),
    GRANITE: (
        ("q_out_2048x1536x1536", 2048, 1536, 1536, 32 * 2),
        ("kv_2048x1536x512", 2048, 1536, 512, 32 * 2),
        ("router_2048x1536x48", 2048, 1536, 48, 32),
        ("head_4x1536x49408", 4, 1536, 49408, 1),
    ),
    MINICPM3: (  # MLA's forward expands the latent through wkv_b on the array
        ("wq_a_2048x2560x768", 2048, 2560, 768, 62),
        ("wq_b_2048x768x3840", 2048, 768, 3840, 62),
        ("wkv_a_2048x2560x288", 2048, 2560, 288, 62),
        ("wkv_b_2048x256x5120", 2048, 256, 5120, 62),
        ("wo_2048x2560x2560", 2048, 2560, 2560, 62),
        ("gate_up_2048x2560x6400", 2048, 2560, 6400, 62 * 2),
        ("down_2048x6400x2560", 2048, 6400, 2560, 62),
        ("head_4x2560x73472", 4, 2560, 73472, 1),
    ),
    LLAVA: (  # the projector over the 2880 patches, then the backbone at M = 3072
        ("mm_fc1_2880x1024x4096", 2880, 1024, 4096, 1),
        ("mm_fc2_2880x4096x4096", 2880, 4096, 4096, 1),
        ("q_out_3072x4096x4096", 3072, 4096, 4096, 32 * 2),
        ("kv_3072x4096x1024", 3072, 4096, 1024, 32 * 2),
        ("gate_up_3072x4096x14336", 3072, 4096, 14336, 32 * 2),
        ("down_3072x14336x4096", 3072, 14336, 4096, 32),
        ("head_1x4096x32000", 1, 4096, 32000, 1),
    ),
    WHISPER: (  # the encoder's q/k/v/o and the decoder's cross k/v at M = 4 x 1500
        ("enc_qkvo_cross_kv_6000x384x384", 6000, 384, 384, 4 * 4 + 4 * 2),
        ("enc_up_6000x384x1536", 6000, 384, 1536, 4),
        ("enc_down_6000x1536x384", 6000, 1536, 384, 4),
        ("dec_qkvo_cross_qo_1792x384x384", 1792, 384, 384, 4 * 4 + 4 * 2),
        ("dec_up_1792x384x1536", 1792, 384, 1536, 4),
        ("dec_down_1792x1536x384", 1792, 1536, 384, 4),
        ("head_4x384x51968", 4, 384, 51968, 1),
    ),
    RWKV6: (
        ("rkvgo_ffr_2048x4096x4096", 2048, 4096, 4096, 32 * 6),
        ("w_a_2048x4096x64", 2048, 4096, 64, 32),
        ("w_b_2048x64x4096", 2048, 64, 4096, 32),
        ("ffk_2048x4096x14336", 2048, 4096, 14336, 32),
        ("ffv_2048x14336x4096", 2048, 14336, 4096, 32),
        ("head_4x4096x65536", 4, 4096, 65536, 1),
    ),
    ZAMBA2: (
        ("in_proj_2048x2048x8384", 2048, 2048, 8384, 38),
        ("out_proj_2048x4096x2048", 2048, 4096, 2048, 38),
        ("qkvo_2048x2048x2048", 2048, 2048, 2048, 7 * 4),
        ("gate_up_2048x2048x8192", 2048, 2048, 8192, 7 * 2),
        ("down_2048x8192x2048", 2048, 8192, 2048, 7),
        ("head_4x2048x32000", 4, 2048, 32000, 1),
    ),
}
# (name, E, M, K, N, launches per prefill) of ft_matmul_batched: M = B x the
# expert capacity, int(1.25 * top_k * S / n_experts) = 128 slots
PREFILL_EXPERT_SHAPES = {
    **{arch: () for arch in PREFILL},
    GRANITE: (
        ("gate_up_48x512x1536x512", 48, 512, 1536, 512, 32 * 2),
        ("down_48x512x512x1536", 48, 512, 512, 1536, 32),
    ),
}
# fused against twopass, last-position logits of a full-width bf16 prefill:
# the two accumulate each product in another order, both store bf16, and the
# one-ulp differences pass through every layer; a wrong kernel is off by the
# logits' own size
TWOPASS_PREFILL_TOL = 2.0**-3  # of max |logit|


def prefill_kernel_checks(dev) -> dict[str, float]:
    """``ft_matmul`` and ``ft_matmul_batched`` against their plain versions
    at every fused prefill's shapes (``PREFILL_SHAPES``; the heads at M = B
    are decode-sized), bf16 and f32, as :func:`_kernel_checks` holds them at
    the decode shapes.  Returns each kernel's max |kernel - plain| on random
    operands."""
    from repro_torch.kernels.ft_matmul import (
        ft_matmul, ft_matmul_batched, ft_matmul_batched_ref, ft_matmul_ref, plan_of,
    )

    g = torch.Generator(device=dev).manual_seed(9)
    and_g, or_g = fault_grids(dev)
    launches0 = {name: k.launches for name, k in _kernels().items()}
    errs, plans, max_abs = {}, {}, {"ft_matmul": 0.0, "ft_matmul_batched": 0.0}
    for name, m, k, n in [s[:4] for a in PREFILL_SHAPES for s in PREFILL_SHAPES[a] if not s[0].startswith("head")]:
        for dtype in (torch.bfloat16, torch.float32):
            def operands(kind: str):
                return (_draw(g, dev, dtype, kind, (m, k), 1.0, kind == "frac_x"),
                        _draw(g, dev, dtype, kind, (k, n), 0.02, kind == "frac_w"))
            err, errs[f"{name} {str(dtype)[6:]}"] = _kernel_checks(f"ft_matmul {name}", ft_matmul, ft_matmul_ref,
                                                                   operands, and_g, or_g, dtype)
            max_abs["ft_matmul"] = max(max_abs["ft_matmul"], err)
            plans[name] = _plan_str(plan_of(*operands("integer")))
    b = PREFILL[GRANITE][0]
    for name, e, m, k, n, _ in PREFILL_EXPERT_SHAPES[GRANITE]:
        for dtype in (torch.bfloat16, torch.float32):
            def operands(kind: str):
                # the (b, e, c, d) dispatch layout, copied to (e, b·c, d) as FTContext.einsum does
                x = _draw(g, dev, dtype, kind, (b, e, m // b, k), 1.0, kind == "frac_x")
                return (x.transpose(0, 1).reshape(e, m, k),
                        _draw(g, dev, dtype, kind, (e, k, n), 0.02, kind == "frac_w"))
            err, errs[f"{name} {str(dtype)[6:]}"] = _kernel_checks(
                f"ft_matmul_batched {name}", ft_matmul_batched, ft_matmul_batched_ref, operands, and_g, or_g, dtype)
            max_abs["ft_matmul_batched"] = max(max_abs["ft_matmul_batched"], err)
            plans[name] = _plan_str(plan_of(*operands("integer")))
    for name, k in _kernels().items():  # checks, not main-path launches
        k.launches = launches0[name]
    phase("prefill_kernels", shapes=sorted(plans), plans=plans, dtypes=["bf16", "f32"],
          bitwise=["integer", "f32 frac_x", "f32 frac_w", "bf16 store = f32 cast", "repeat call"],
          random_tol=f"{RAND_TOL}*(|x|@|w|)", max_abs_err=max_abs, max_err_over_scale=errs)
    return max_abs


def _prefill_ctx(mode: str, faults, dispatch: str, dev):
    from repro_torch.core.engine import HyCAConfig
    from repro_torch.core.ftcontext import build_ftcontext
    from repro_torch.core.redundancy import DPPUConfig

    hyca = HyCAConfig(rows=ROWS, cols=COLS, dppu=DPPUConfig(size=4, group_size=4), mode=mode)
    return build_ftcontext(_fault_state(faults, dev), hyca, dispatch=dispatch)


def prefill_batch(lm, dev, g=None) -> dict:
    """The fused prefill's inputs for ``lm`` at ``PREFILL[lm.name]``: tokens,
    and llava's patches or whisper's frames (0.02 N(0, 1))."""
    b, s = PREFILL[lm.name]
    batch = {"tokens": torch.randint(0, lm.vocab, (b, s), generator=g, device=dev)}
    if lm.family == "vlm":
        batch["patches"] = torch.randn((b, lm.n_patches, lm.d_vision), generator=g, device=dev) * 0.02
    if lm.family == "encdec":
        batch["frames"] = torch.randn((b, lm.enc_len, lm.d_model), generator=g, device=dev) * 0.02
    return batch


def prefill_modes(bundle, batch: dict, dev) -> dict:
    """``forward(bundle.work, batch, last_only=True)`` under ``fused``.  The
    prefill's calls, recorded on ``meta``, are first held to
    ``PREFILL_SHAPES``.  Then, after a warm-up: off (the fault-free array
    through the same kernels), protected with the 3 BIST faults (bitwise
    off) and unprotected with a stuck-at-1 on bit 30 of PE(0, 0) (differs
    from off), each launching the tables' count of each kernel (every other
    kernel 0), counted from 0 just before and read just after; and the
    twopass engine on the BIST faults, within TWOPASS_PREFILL_TOL of fused.
    Returns the contexts, the prefill, each mode's logits and ms, the
    protected prefill's launches and the twopass comparison."""
    from repro_torch.models.lm import forward

    lm, arch = bundle.lm, bundle.lm.name
    kernels = _kernels()
    ctxs = {"off": _prefill_ctx("protected", [], "fused", dev),
            "protected": _prefill_ctx("protected", BIST_FAULTS, "fused", dev),
            "unprotected": _prefill_ctx("unprotected", [(0, 0, 30, 1)], "fused", dev)}
    hold_shapes(f"{arch} prefill", prefill_shapes(lm, ctxs["protected"], bundle.work, batch),
                PREFILL_SHAPES[arch], PREFILL_EXPERT_SHAPES[arch])
    want = {"ft_matmul": sum(s[-1] for s in PREFILL_SHAPES[arch]),
            "ft_matmul_batched": sum(s[-1] for s in PREFILL_EXPERT_SHAPES[arch])}

    def prefill(ctx):
        with torch.no_grad():
            logits, _ = forward(bundle.work, lm, batch, ftc=ctx, last_only=True)
        torch.cuda.synchronize()
        return logits

    prefill(ctxs["off"])  # warm-up
    out, ms = {}, {}
    for mode, ctx in ctxs.items():
        for k in kernels.values():
            k.launches = 0
        t1 = time.perf_counter()
        out[mode] = prefill(ctx)
        ms[mode] = 1e3 * (time.perf_counter() - t1)
        counts = {name: k.launches for name, k in kernels.items()}
        if mode == "protected":
            launches = counts
        check(counts == {**dict.fromkeys(kernels, 0), **want}, f"{arch} prefill {mode}: launched {counts}, want {want}")
    off, prot, unprot = out["off"], out["protected"], out["unprotected"]
    b = batch["tokens"].shape[0]
    check(tuple(off.shape) == (b, 1, lm.padded_vocab) and off.dtype == lm.dtype,
          f"{arch} prefill: logits {tuple(off.shape)} {off.dtype}")
    check(bool(torch.isfinite(off[..., :lm.vocab].float()).all()), f"{arch} prefill off: non-finite logits")
    check(torch.equal(off.view(torch.int16), prot.view(torch.int16)), f"{arch} prefill: protected differs from off")
    check(not torch.equal(off.view(torch.int16), unprot.view(torch.int16)), f"{arch} prefill: unprotected equals off")
    t1 = time.perf_counter()
    twopass = prefill(_prefill_ctx("protected", BIST_FAULTS, "twopass", dev))
    twopass_ms = 1e3 * (time.perf_counter() - t1)
    a, b = prot[..., :lm.vocab].float(), twopass[..., :lm.vocab].float()
    rel = float((a - b).abs().max()) / float(a.abs().max())
    check(rel <= TWOPASS_PREFILL_TOL, f"{arch} prefill: fused vs twopass {rel} of max |logit| > {TWOPASS_PREFILL_TOL}")
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    return dict(ctxs=ctxs, prefill=prefill, logits=out, ms=ms, launches=launches, twopass_rel=rel,
                twopass_agree=agree, twopass_ms=twopass_ms)


def prefill_phase(dev, smi: str, bundle) -> dict[str, dict]:
    """The fused prefill at full width: ``forward(last_only=True)`` on
    ``prefill_batch`` through ``FTContext`` under ``fused``, the reference's
    production prefill, in the modes of :func:`prefill_modes`; then the
    kernels at the prefill's shapes, their times against the library call
    and the bound (:func:`time_kernel_shapes`).  Returns {kernel:
    per-prefill totals, with the launches the protected prefill made}."""
    lm, arch = bundle.lm, bundle.lm.name
    t0 = time.perf_counter()
    batch = prefill_batch(lm, dev, torch.Generator(device=dev).manual_seed(3))
    r = prefill_modes(bundle, batch, dev)
    times = []
    for _ in range(3):
        t1 = time.perf_counter()
        r["prefill"](r["ctxs"]["protected"])
        times.append(1e3 * (time.perf_counter() - t1))
    totals = time_kernel_shapes(dev, smi, arch, PREFILL_SHAPES[arch], PREFILL_EXPERT_SHAPES[arch], "prefill")
    for name, t in totals.items():
        t["launches"] = r["launches"][name]
    b, s = PREFILL[arch]
    phase("prefill_fused", arch=arch, batch=b, seq=s, last_only=True, inputs=sorted(batch),
          launches=r["launches"], protected_equals_off=True, unprotected_differs=True,
          fused_vs_twopass_over_max_logit=r["twopass_rel"], fused_vs_twopass_tol=TWOPASS_PREFILL_TOL,
          fused_twopass_argmax_agree=r["twopass_agree"],
          prefill_ms={**r["ms"], "protected_runs": times, "twopass": r["twopass_ms"]},
          kernel_ms_per_prefill={k: v["ms"] for k, v in totals.items()},
          library_ms_per_prefill={k: v["library_ms"] for k, v in totals.items()},
          bound_ms_per_prefill={k: v["bound_ms"] for k, v in totals.items()},
          phase_s=time.perf_counter() - t0, card=smi)
    return totals


# --------------------------------------------------------------------------- #
# the attention families: five more models at full width
# --------------------------------------------------------------------------- #
def family_server_phase(dev, smi: str, arch: str):
    """Serve ``arch`` at full width (random weights from seed 0, bf16
    working copies) through the captured step, as :func:`server_phase`
    serves qwen and granite: off, protected and unprotected, each again
    through the eager step (:func:`serve_modes`).  whisper's
    cross-attention projects K and V over all 4 x 1500 encoder rows, which
    reach every PE row: a fault that appears at step 2 corrupts its outputs
    until the scan confirms it (as in the reference), so its protected run
    has a BIST confirm that fault at step 2, and protected is held to off
    at every step."""
    bundle = full_bundle(dev, arch)
    serve(bundle, "off", bundle.lm.vocab)  # warm-up
    runs = serve_modes(bundle, smi, arch, SCENARIOS, bist_at=2 if arch == WHISPER else None)
    return bundle, runs


# qwen1.5-0.5b training at the reference CLI's defaults: batch 8, seq 128,
# 2 microbatches, lr 1e-3, the 32x32 array with 4 seeded faults, twopass
TRAIN = dict(batch=8, seq=128, n_micro=2, lr=1e-3, faults=4, steps=5, seed=0)


class deterministic:
    """``torch.use_deterministic_algorithms(True)`` for the block, with the
    cuBLAS workspace setting it requires, restored after it."""

    def __enter__(self):
        self.env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(False)
        if self.env is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = self.env


def _trees_equal(a, b) -> bool:
    from repro_torch.tree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def train_phase(dev, smi: str, bundle) -> dict:
    """qwen1.5-0.5b's train step at full width (``launch/train.py``, the
    bundle's f32 masters as the params) at the reference CLI's defaults,
    protected under ``twopass`` with 4 seeded faults on the 32x32 array, in
    deterministic mode with TF32 off: 5 steps (finite losses, gnorm > 0),
    the params after 2 steps bitwise those of a run with an empty fault
    table, different under ``unprotected``, every frozen leaf bit for bit
    under a grad mask of ``("ffn",)``; the step ms, the peak memory, the
    device busy share of one profiled step; a fused train step refused (C5).
    Returns the states after 2 and 4 steps, the step and the data."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.engine import HyCAConfig, empty_fault_state
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train as T
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.repair.retrain import RetrainConfig, grad_mask
    from repro_torch.tree import map_with_path, tree_leaves

    t0 = time.perf_counter()
    lm = bundle.lm
    tc = T.TrainConfig(n_micro=TRAIN["n_micro"], opt=AdamWConfig(lr=TRAIN["lr"]), total_steps=TRAIN["steps"],
                       warmup=max(1, TRAIN["steps"] // 10), hyca_mode="protected", hyca_dispatch="twopass")
    hyca = HyCAConfig(rows=32, cols=32, mode="protected")
    check(TRAIN["faults"] <= hyca.capacity, f"{TRAIN['faults']} faults past the DPPU's {hyca.capacity}")
    faults = T.cli_fault_state(TRAIN["faults"], TRAIN["seed"], device=dev)
    data = SyntheticLM(DataConfig(seed=TRAIN["seed"], batch=TRAIN["batch"], seq_len=TRAIN["seq"]), lm)
    batches = [T.batch_to(data.batch(i), dev) for i in range(TRAIN["steps"])]
    start = {"params": bundle.params, "opt": adamw_init(bundle.params)}

    def run(step_fn, fstate, n, keep=()):
        """``n`` steps from ``start``: (the states after the steps of
        ``keep`` and the last, their metrics, their ms, one step's peak
        bytes).  Only those states are kept: each holds 5.6 GB."""
        state, kept, metrics, times, peak = start, {}, [], [], None
        for i in range(n):
            if i == 1:
                torch.cuda.reset_peak_memory_stats(dev)
            t1 = time.perf_counter()
            state, m = step_fn(state, batches[i], fstate)
            metrics.append({k: float(v) for k, v in m.items()})  # the host reads them: the step has ended
            times.append(1e3 * (time.perf_counter() - t1))
            if i == 1:
                peak = torch.cuda.max_memory_allocated(dev)
            if i + 1 in keep:
                kept[i + 1] = state
        kept["last"] = state
        return kept, metrics, times, peak

    step = T.make_train_step(lm, tc, hyca=hyca)
    with deterministic():
        mem0 = torch.cuda.memory_allocated(dev)
        states, metrics, times, peak = run(step, faults, TRAIN["steps"], keep=(2, 4))
        losses = [m["loss"] for m in metrics]
        check(all(np.isfinite(losses)) and all(m["gnorm"] > 0 for m in metrics),
              f"train: losses {losses}, gnorm {[m['gnorm'] for m in metrics]}")
        empty = run(step, empty_fault_state(TRAIN["faults"], device=dev), 2)[0]["last"]
        check(_trees_equal(states[2]["params"], empty["params"]),
              "train: protected (4 faults <= capacity) params after 2 steps differ from the empty fault table's")
        del empty
        unprot = run(T.make_train_step(lm, dataclasses.replace(tc, hyca_mode="unprotected"), hyca=hyca),
                     faults, 2)[0]["last"]
        check(not _trees_equal(states[2]["params"], unprot["params"]),
              "train: unprotected params after 2 steps equal the protected ones")
        del unprot
        mask = grad_mask(bundle.params, RetrainConfig(trainable=("ffn",)))
        masked = run(T.make_train_step(lm, tc, hyca=hyca, grad_mask=mask), faults, 2)[0]["last"]
        frozen = map_with_path(lambda path, layer, t: "ffn" not in path, bundle.params)
        pairs = list(zip(tree_leaves(frozen), tree_leaves(bundle.params), tree_leaves(masked["params"])))
        check(all(torch.equal(a, b) for f, a, b in pairs if f) and all(not torch.equal(a, b) for f, a, b in pairs
                                                                    if not f),
              "train: a frozen leaf moved, or an ffn leaf did not, under grad_mask(('ffn',))")
        del masked, pairs
        # one step profiled: its device events' time over the unprofiled median step
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(states[2], batches[2], faults)
            torch.cuda.synchronize()
    busy_ms = sum(_self_device_us(e) for e in _device_events(prof.key_averages())) / 1e3
    step_ms = float(np.median(times[1:]))
    try:
        T.make_train_step(lm, dataclasses.replace(tc, hyca_dispatch="fused"), hyca=hyca)
        refused = False
    except ValueError as e:
        refused = "C5" in str(e)
    check(refused, "train: a fused protected train step was not refused (C5)")
    out = dict(arch=lm.name, layers=lm.n_layers, remat=lm.remat, dtype=str(lm.dtype)[6:], **TRAIN,
               dispatch="twopass", array="32x32", capacity=hyca.capacity, deterministic=True,
               tf32=torch.backends.cuda.matmul.allow_tf32, losses=losses,
               gnorm=[m["gnorm"] for m in metrics], lr_by_step=[m["lr"] for m in metrics], step_ms=times,
               step_ms_median=step_ms, tokens_per_s=TRAIN["batch"] * TRAIN["seq"] / (step_ms / 1e3),
               step_peak_gib=peak / 2**30, step_peak_above_start_gib=(peak - mem0) / 2**30,
               device_busy_ms=busy_ms,
               device_busy_share=busy_ms / step_ms, protected_equals_empty_table=True,
               unprotected_differs=True, grad_mask_freezes=True, fused_refused_c5=True,
               phase_s=time.perf_counter() - t0, card=smi)
    phase("train_step", **out)
    return dict(states=states, step=step, faults=faults, batches=batches)


def checkpoint_phase(dev, smi: str, train: dict) -> dict:
    """The full-width train state after 2 steps saved and restored bit for
    bit; 2 more steps from the restored state bitwise the straight run's 4
    (deterministic mode); a tampered checkpoint re-fetched from a pristine
    copy, then refused with no source; ``memory_fault_records`` of both.
    The checkpoints live under build/ in the checkout and are removed."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import store
    from repro_torch.obs.events import EventLog, memory_fault_records
    from repro_torch.transient import memory

    t0 = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt-", dir=root)
    try:
        state2, state4 = train["states"][2], train["states"][4]
        d, mirror = os.path.join(tmp, "ckpt"), os.path.join(tmp, "mirror")
        t1 = time.perf_counter()
        store.save(d, 2, state2, {"arch": QWEN})
        save_s = time.perf_counter() - t1
        nbytes = sum(os.path.getsize(os.path.join(d, "step_00000002", f)) for f in
                     os.listdir(os.path.join(d, "step_00000002")))
        t1 = time.perf_counter()
        restored = store.restore(d, 2, state2, device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
        check(_trees_equal(state2, restored), "checkpoint: the restored state differs from the saved one")
        with deterministic():
            state = restored
            for i in (2, 3):
                state, _ = train["step"](state, train["batches"][i], train["faults"])
        check(_trees_equal(state4, state), "checkpoint: 2 + 2 steps resumed differ from 4 straight steps")
        manifest = store._verify(os.path.join(d, "step_00000002"))
        shutil.copytree(d, mirror)
        log = EventLog()
        log.step = 2
        rng = np.random.default_rng(0)
        tampered = memory.tamper_checkpoint(d, 2, rng, n_leaves=2)
        check(sorted(store.corrupt_leaves(d, 2)) == sorted(tampered), "checkpoint: the digest scan missed a leaf")
        t1 = time.perf_counter()
        again = memory.guarded_restore(d, 2, state2, device=dev, log=log, fetch=memory.pristine_fetcher(mirror))
        guarded_s = time.perf_counter() - t1
        check(_trees_equal(state2, again), "checkpoint: the re-fetched state differs from the saved one")
        tampered2 = memory.tamper_checkpoint(d, 2, rng, n_leaves=1)
        try:
            memory.guarded_restore(d, 2, state2, device=dev, log=log)
            refused = False
        except ValueError:
            refused = True
        check(refused, "checkpoint: a tampered checkpoint with no pristine source was not refused")
        records = memory_fault_records(log)
        check({r["outcome"] for r in records} == {"refetched", "refused"}, f"checkpoint: records {records}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = dict(arch=QWEN, leaves=len(manifest["leaves"]), tree_hash=manifest["tree_hash"], bytes=nbytes,
               save_s=save_s, restore_s=restore_s, restored_bitwise=True, resumed_equals_straight=True,
               tampered=tampered, refetched=True, guarded_restore_s=guarded_s, tampered_no_source=tampered2,
               refused=True, memory_fault_records=records, phase_s=time.perf_counter() - t0, card=smi)
    phase("checkpoint", **out)
    return out


def serve_retrain_phase(dev, smi: str, bundle, prot: dict) -> dict:
    """``repair="retrain"`` at full width: the six faults of REMAP_FAULTS at
    step 2, where the hook plans the remap and fine-tunes this server's f32
    masters (4 steps, twopass, the faulty array and the plan in the
    forward), then swaps its own working copies into its step, which
    recaptures once.  Captured against eager bitwise; 4 slots and quality
    0.75; the main path's launches a step; the retrain seconds; then a
    sibling on the same bundle serves the protected scenario bitwise as it
    did before (``prot``, from ``server_phase``), with one capture."""
    arch = bundle.lm.name
    t0 = time.perf_counter()
    remap = dict(inject=tuple((REMAP_AT, f) for f in REMAP_FAULTS), bist_at=REMAP_AT, repair="retrain")
    run = serve(bundle, "protected", bundle.lm.vocab, record_logits=True, **remap)
    srv, steps, counts = run["server"], len(run["times"]), run["counts"]
    events = srv.repair_events
    check(len(events) == 1 and events[0]["retrained"] and events[0]["step"] == REMAP_AT,
          f"{arch} retrain: repair events {events}")
    eff = [r.effective_slots for r in srv.metrics.steps]
    check(all(e == 4 for e in eff) and srv.manager.quality_fraction == 0.75,
          f"{arch} retrain: effective slots {eff}, quality {srv.manager.quality_fraction}")
    check(run["captures"] == 2 and srv.params is not bundle.work and srv.decode.params is srv.params,
          f"{arch} retrain: {run['captures']} captures; the step must recapture once over its own params")
    for name, n in per_step(arch).items():
        check(counts[name] == n * steps, f"{arch} retrain: {name} launched {counts[name]} times in {steps} steps")
    report = srv.retrain_reports[0]
    check(all(np.isfinite(report["losses"])), f"{arch} retrain: losses {report['losses']}")
    eager = serve(bundle, "protected", bundle.lm.vocab, record_logits=True, capture=False, **remap)
    check(eager["tokens"].keys() == run["tokens"].keys()
          and all(np.array_equal(eager["tokens"][r], run["tokens"][r]) for r in run["tokens"]),
          f"{arch} retrain: the captured step's tokens differ from the eager step's")
    check(_same_bits(run["logits"], eager["logits"]), f"{arch} retrain: captured logits differ from eager")
    sib = serve(bundle, "protected", bundle.lm.vocab, faults=BIST_FAULTS, inject=((2, (5, 3, 30, 1)),),
                record_logits=True)
    check(sib["captures"] == 1 and sib["tokens"].keys() == prot["tokens"].keys()
          and all(np.array_equal(sib["tokens"][r], prot["tokens"][r]) for r in prot["tokens"])
          and _same_bits(sib["logits"], prot["logits"]),
          f"{arch} retrain: a sibling on the bundle no longer serves what it served before")
    (ms, tps) = _steady(run, skip=REMAP_AT + 2)
    out = dict(arch=arch, steps=steps, repair_event=events[0], effective_slots=sorted(set(eff)),
               quality_fraction=srv.manager.quality_fraction, retrain_steps=report["steps"],
               retrain_losses=report["losses"], retrain_s=report["seconds"],
               eager_retrain_s=eager["server"].retrain_reports[0]["seconds"], captures=run["captures"],
               sibling_captures=sib["captures"], sibling_equals_before=True, graph_equals_eager=True,
               launches=counts, step_ms_median_after=ms, tokens_per_s_after=tps,
               repair_step_s=run["times"][REMAP_AT], phase_s=time.perf_counter() - t0, card=smi)
    phase("serve_retrain", **out)
    return out


def main() -> None:
    smi = device_phase()
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    dev = torch.device("cuda")
    build_phase()
    err = {"ft_matmul": max(ft_matmul_phase(dev), mixed_dtype_checks(dev)),
           "ft_matmul_batched": ft_matmul_batched_phase(dev)}
    for name, e in prefill_kernel_checks(dev).items():
        err[name] = max(err[name], e)
    probe_check_phase(dev)
    timed = {"probe_check": time_probe_check(dev, smi)}
    launches = dict.fromkeys(_kernels(), 0)
    per_path, per_prefill = {}, {}
    for arch in (QWEN, GRANITE):
        bundle, runs = server_phase(dev, smi, arch)
        for name, n in runs["protected"]["counts"].items():
            launches[name] += n
        per_path[arch] = timing_phase(dev, smi, arch, runs)
        busy = {step: profile_phase(bundle, smi, capture=capture)["device_busy_ms"]
                for step, capture in (("eager", False), ("captured", True))}
        steady_phase(bundle, smi, busy)
        if arch == QWEN:  # the kernel tier, the transients and the training slice on the served model's weights
            two_pass = two_pass_phase(dev, smi, bundle)
            transients_phase(dev, smi, bundle)
            serve_retrain_phase(dev, smi, bundle, runs["protected"])
            train = train_phase(dev, smi, bundle)
            checkpoint_phase(dev, smi, train)
            del train
        per_prefill[arch] = prefill_phase(dev, smi, bundle)
        del bundle, runs
        gc.collect()
        torch.cuda.empty_cache()  # the next model's bundle gets the card's memory
    for arch in FAMILIES:  # the attention families, one bundle at a time
        bundle, runs = family_server_phase(dev, smi, arch)
        for name, n in runs["protected"]["counts"].items():
            launches[name] += n
        per_path[arch] = timing_phase(dev, smi, arch, runs)
        if arch in PREFILL:  # the families whose forward runs other matmuls than their decode
            per_prefill[arch] = prefill_phase(dev, smi, bundle)
        del bundle, runs
        gc.collect()
        torch.cuda.empty_cache()

    def matmul_row(name: str, replaces: str) -> dict:
        paths = {arch: t[name] for arch, t in per_path.items() if name in t}
        row = {"name": name, "route": "cuda", "source": "src/repro_torch/csrc/ft_matmul.cu",
               "replaces": replaces, "launches": launches[name], "max_abs_err": err[name]}
        # per decode step, summed over one step of each model whose path runs it
        for key in ("ms", "plain_ms", "bound_ms"):
            row[key] = sum(p[key] for p in paths.values())
        row["bound_by"] = "bytes"
        row["library_ms"] = sum(p["library_ms"] for p in paths.values())
        row["per_decode_step"] = paths
        # the fused prefill's path: its launches and its per-prefill totals
        prefill = {arch: t[name] for arch, t in per_prefill.items() if name in t}
        row["launches_prefill"] = sum(p["launches"] for p in prefill.values())
        row["per_prefill"] = prefill
        return row

    kernels = [
        matmul_row("ft_matmul", "src/repro/kernels/ft_matmul.py:122"),
        matmul_row("ft_matmul_batched", "src/repro/kernels/ft_matmul.py:194"),
        # the scan step runs the TPU kernel's check of both probe halves in one
        # launch: the row's numbers are that entry point's, probe_check_pair
        {"name": "probe_check", "route": "cuda", "source": "src/repro_torch/csrc/probe_check.cu",
         "replaces": "src/repro/kernels/dppu_recompute.py:135", "entry": "probe_check_pair",
         "launches": launches["probe_check_pair"], "max_abs_err": 0.0, **timed["probe_check"],
         "library_ms": None},
        two_pass["os_array_matmul"],
        two_pass["dppu_recompute"],
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
