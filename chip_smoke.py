"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:

  1. device   — require CUDA; print the card's name and power limit, the
     host's MemTotal and MemAvailable (every bundle's f32 masters live in
     host memory) and the free disk under build/;
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
     granite expert shapes (48 experts x 4 rows, 1536->512 and 512->1536),
     deepseek's (64 x 4 rows, 2048->1408 and 1408->2048) and ragged ones
     (5x3x1000->1000, M = 37, a 66-byte row pitch), with x
     read as the strided view of the (b, e, c, d) dispatch layout that the
     MoE path hands it;
  5. probe_check against probe_check_ref over every row-block, ± probes,
     with and without faults; probe_check_pair (the scan step's one launch
     for both halves of the pair) against probe_check_pair_ref on the same
     row-blocks and on random small and full-range int32 operands with
     stuck-at faults on bits 0, 15, 30 and 31, one launch a call;
  6. each served model at full width (random weights from a seed; each
     bundle prints its build seconds, its masters' host bytes and the card's
     peak while it was built, and holds every master to the host and every
     working copy to the card), through
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
     shapes (M = 2048; the experts 48 x 512 and 64 x 240 rows), as in 3
     and 4.  On
     qwen1.5-0.5b before it is freed: serve_retrain — repair="retrain" with
     the six faults of serve_remap at step 2, where the hook plans the remap
     and fine-tunes this server's f32 masters (4 steps, twopass), copied
     from the host to the card for it and kept on the host after it, and
     its step recaptures once over its own working copies: 4 slots, quality
     0.75, captured equal to eager bit for bit, the main path's launches a
     step, the retrain seconds, and a sibling on the same bundle serving
     the protected scenario bitwise as before with one capture;
     train_step — launch/train.py's step at the reference CLI's defaults
     (batch 8, seq 128, 2 microbatches, lr 1e-3, 4 seeded faults on the
     32 x 32 array, twopass, remat on) at full width, cut to TRAIN_LAYERS
     of its 24 layers, in deterministic mode with TF32 off: 5 steps with finite losses and gnorm > 0, the params after 2
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
     Then the fine-grained MoE, deepseek-moe-16b (arXiv:2401.06066): first
     serve_reference_full_width, its full widths cut to two layers (the
     dense layer, one MoE layer of 64 + 2 experts; f32 working copies and
     KV caches): decode_step over one batch on the card against the CPU
     from the same host masters, fault-free and unprotected with a fault:
     every step's logits within REFERENCE_TOL of the CPU's max |logit|,
     every greedy token equal, the card's launches the step's; then the
     whole model (28 layers, d 2048, vocab 102400: 32.75 GB of bf16 working
     copies on the card, its 65.5 GB of f32 masters on the host, the card's
     peak while it was built under DEEPSEEK_BUILD_PEAK) through the modes
     of 6 captured and eager (ft_matmul 224, ft_matmul_batched 81 a step),
     serve_remap at full width (the planner's salience streamed layer by
     layer from the host masters), the kernel times a decode step and the
     fused prefill of 4 x 512 tokens (the experts at 64 x 240 rows).
  13. the paper's own evaluation, after every model is freed; it launches
     none of the five kernels (their counts, set to 0 before, must stay 0).
     campaign — the campaign and fig10 twins at their quick sizes on the
     card, whose tables must equal experiments/bench/campaign.json's and
     fig10_ffp.json's float for float; then fig10's full size (3000 configs
     on 32 x 32, both fault models, every PER) and fig14's (1500 configs on
     16 x 16 to 128 x 128, both models, its four PERs): at every point each
     scheme's (ff, surviving columns), HyCA's under repair="remap" too, on
     the card equals the port's batched evaluator on the CPU and the numpy
     per-config loop, config by config (the numpy sampling and loop run in
     CAMPAIGN_WORKERS processes beside the card); sampler="device" on the
     card: the random rate within its binomial CI, every clustered map
     carrying exactly its count and in bounds at sigma 0.5, 1.5 and 500,
     the DPPU capacity mean within the numpy sampler's CI; seconds per point
     on the card beside the numpy loop's, DR's evaluator ms at 32 x 32 /
     3000 and 128 x 128 / 1500.  accuracy_campaign — the fig02 twin at full
     size (50 configs x 7 PERs x 1024 test rows, the MLP trained on the
     card): its six claims (every config within capacity predicts exactly
     the clean predictions); on 4 configs per PER, each layer's
     hyca_matmul_batched on the card equal to the per-config hyca_matmul and
     to the same batched call on the CPU, bit for bit, protected and
     unprotected; seconds per PER point and the twin's peak device memory
     above what was allocated before it.  repair_recovery — the twin in
     full mode (7 PERs, 48 configs, 60 retrain steps of finetune_vmapped):
     its seven claims, seconds per PER point, peak device memory.
  14. the fleet, after the paper's evaluation.  fleet — run_fleet of 4
     replicas of qwen1.5-0.5b at full width (4 slots, the 8x8 array, DPPU
     4, fused, every replica's step captured), 2 pooled spares, 120 steps
     of trace-driven traffic and a chaos burst on replica 0 at step 24 that
     retires it: a spare captures its own step, and the retired server is
     gone by the spare's first step; ft_matmul 169 and probe_check_pair 1
     a replica step (the counts set to 0 just before the run, read just
     after); the report equals run_fleet's at smoke size on the CPU on
     every key and run_vfleet's on the card on the 13 parity keys; the
     fleet step ms, tokens/s, each capture's seconds and the allocated
     bytes before the chaos, at the spare's first step, after the
     replacement and after the fleet is freed.  vfleet — the fleet_goodput
     twin on the card: the quick sweep (its baseline row equal to
     experiments/bench/fleet_goodput.json's on every count), its claims, one
     build per geometry; the two pinned parity fleets on the card equal to
     run_fleet on the CPU; the headline of 1000 replicas x 10 000 steps (x
     2000, printed as reduced, if its first chunk's time says it would not
     fit HEADLINE_AIM_S); ms a tick at 64 and 1000 replicas.  obs_overhead —
     the twin's vfleet row: series off and on, bit-exact, overhead_x.
  15. the launch tier and the serving twins.  launch_steps — on each of
     qwen1.5-0.5b and granite-moe-3b-a800m at full width before its bundle
     is freed: launch/serve.py's make_decode (4 slots, fused) bit for bit
     the bundle's captured step (logits and cache, off and unprotected),
     one capture and per replayed step exactly the path's launches (169;
     161 + 96), protected equal to off and unprotected different, a second
     builder leaving no allocated byte behind; on qwen also make_prefill at
     4 x 512 bit for bit the prefill_fused phase's logits in its three
     modes, and the decode step's ms and device busy share.  serve_cli —
     launch.serve.main on smoke qwen (6 requests) off / protected /
     unprotected under twopass and fused, remap past capacity, chaos, 64
     faults (admission refused), and one run with counters, --metrics-out,
     --series-out, --spans-out and --metrics-port 0 (files under build/,
     removed after): every summary key but the wall clock's equal to the
     same argv on the CPU, protected's tokens equal to off's, the launches
     the ledger's, the /metrics scrape equal to the .prom file.
     serving_twins — the serving_goodput, scan_latency, detector_coverage
     and ft_overhead twins (quick; ft_overhead also in full mode on
     FT_FULL_FAMILIES), written to experiments/bench_torch/: the results
     that depend on no float order equal to experiments/bench/*.json, the
     correctness claims held, the timing claims printed.

  16. the analysis tier and the plan autotuner.  autotune — the measured
     plan search of kernels/autotune.py on the card at qwen1.5-0.5b's four
     decode shapes and three prefill shapes (bf16), its cache in a
     temporary directory: each split's time (CUDA events) beside ft_plan's
     pick; every candidate plan against ft_matmul_ref as in 3, bf16 and
     f32; a fused_block="auto" context on that cache launches the tuned
     plan and a default context ft_plan, each bitwise a direct call.
     dryrun — launch/dryrun.py on the host mesh (meta tensors, full width),
     qwen1.5-0.5b at every applicable cell and every other family at
     decode_32k, in ANALYSIS_WORKERS processes: every
     record ok, each cell's trace seconds, FLOPs, bytes and argument and
     output bytes.  dryrun_sharded — the same tool on the 16 x 16 and
     2 x 16 x 16 meshes (DTensors of a fake process group, meta, full
     width), in the same pool: every config at decode_32k, qwen at every
     applicable cell; each record's status, trace
     seconds, per-device FLOPs and bytes, collective counts and wire bytes
     and its roofline collective term; qwen's decode_32k on 16 x 16 holds
     its dot FLOPs x 256 to the host trace's and its collectives to the
     Megatron count (2 L + 1 all-reduces of the activation over model, 2 L
     gathers of the norm scales); the cells left to the CLI named with the
     reason.  specs — every config's every cell on both meshes: every spec
     divides its dimension, argument bytes per device, which a traced
     record's arguments equal.  probes — qwen at train_4k and decode_32k reconstructed from
     reduced-depth probes, equal to the dry run's direct count within
     PROBE_TOL.  roofline — the dry-run records' table on the card's
     constants, and the served qwen step's (4 slots, 96-row cache, bf16
     working copies, 169 protected calls) bound beside its captured step
     from 7.  The autotuner's timed launches count under ft_matmul.

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
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
from repro_torch.launch import hw  # noqa: E402  (the card's constants: one source for every bound)

HBM_BYTES_PER_S = hw.HBM_BW
PEAK_OPS_PER_S = {torch.bfloat16: hw.PEAK_FLOPS_BF16, torch.float32: hw.PEAK_FLOPS_F32, torch.int32: hw.PEAK_OPS_INT32}
L2_BYTES = hw.L2_BYTES

ROWS = COLS = 8
QWEN, GRANITE = "qwen1.5-0.5b", "granite-moe-3b-a800m"
# the attention families, served after the two models above
GRANITE8B, STARCODER2, MINICPM3 = "granite-8b", "starcoder2-3b", "minicpm3-4b"
LLAVA, WHISPER = "llava-next-mistral-7b", "whisper-tiny"
# the recurrent families, served after the attention families
RWKV6, ZAMBA2 = "rwkv6-7b", "zamba2-1.2b"
# the fine-grained MoE, served last: its f32 masters (65.5 GB) live on the host
DEEPSEEK = "deepseek-moe-16b"
FAMILIES = (GRANITE8B, STARCODER2, MINICPM3, LLAVA, WHISPER, RWKV6, ZAMBA2, DEEPSEEK)
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
    # MHA; one dense layer (d_ff 10944); 27 MoE layers: the 2 shared experts as one FFN, the router; untied head
    DEEPSEEK: (
        ("qkvo_2048x2048", 4, 2048, 2048, 28 * 4),
        ("dense_gate_up_2048x10944", 4, 2048, 10944, 2),
        ("dense_down_10944x2048", 4, 10944, 2048, 1),
        ("shared_gate_up_2048x2816", 4, 2048, 2816, 27 * 2),
        ("shared_down_2816x2048", 4, 2816, 2048, 27),
        ("router_2048x64", 4, 2048, 64, 27),
        ("head_2048x102400", 4, 2048, 102400, 1),
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
    DEEPSEEK: (  # 64 routed experts, top-6
        ("gate_up_64x2048x1408", 64, 4, 2048, 1408, 27 * 2),
        ("down_64x1408x2048", 64, 4, 1408, 2048, 27),
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


START = time.perf_counter()


def phase(name: str, /, **fields) -> None:
    """One JSON line a phase; ``elapsed_s`` is the script's time so far."""
    print(json.dumps({"phase": name, **fields, "elapsed_s": round(time.perf_counter() - START, 2)}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


# --------------------------------------------------------------------------- #
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")


def host_memory() -> dict[str, int]:
    """/proc/meminfo's MemTotal and MemAvailable, in bytes: the f32 masters
    of every bundle live in host memory (deepseek-moe-16b's: 65.5 GB)."""
    with open("/proc/meminfo") as f:
        kb = {k: int(v.split()[0]) for k, v in (line.split(":", 1) for line in f)}
    return {k: 1024 * kb[k] for k in ("MemTotal", "MemAvailable")}


def free_host_memory() -> None:
    """Collect freed bundles and hand the heap's free pages back to the
    system, so that the next model's masters find the host's memory."""
    import ctypes

    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)


def device_phase() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    host = host_memory()
    os.makedirs(BUILD_DIR, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    props = torch.cuda.get_device_properties(0)
    phase("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
          nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
          sm_count=props.multi_processor_count, total_memory=props.total_memory,
          l2_bytes=getattr(props, "L2_cache_size", None),
          smem_per_sm=getattr(props, "shared_memory_per_multiprocessor", None),
          smem_per_block_optin=getattr(props, "shared_memory_per_block_optin", None),
          hw=dict(SM_COUNT=hw.SM_COUNT, HBM_BYTES=hw.HBM_BYTES, L2_BYTES=hw.L2_BYTES, SMEM_PER_SM=hw.SMEM_PER_SM,
                  SMEM_PER_BLOCK=hw.SMEM_PER_BLOCK),
          host_mem_total=host["MemTotal"], host_mem_available=host["MemAvailable"], cpu_count=os.cpu_count(),
          build_disk_free=shutil.disk_usage(BUILD_DIR).free)
    # launch/hw.py's SM count is the card's; its HBM size holds the memory
    # the card reports (a little of the 80 GiB stays reserved)
    check(props.multi_processor_count == hw.SM_COUNT,
          f"the card has {props.multi_processor_count} SMs, launch/hw.py says {hw.SM_COUNT}")
    check(0.95 * hw.HBM_BYTES <= props.total_memory <= hw.HBM_BYTES,
          f"the card has {props.total_memory} bytes of memory, launch/hw.py says {hw.HBM_BYTES}")
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
    shapes = [s[:5] for arch_shapes in EXPERT_SHAPES.values() for s in arch_shapes] + list(EXTRA_EXPERT_SHAPES)
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


# the card's peak while deepseek-moe-16b's bundle is built: its working
# copies (32.75 GB) and one f32 piece (an MoE layer, 2.35 GB), not the 98.3 GB
# that f32 masters beside them would take
DEEPSEEK_BUILD_PEAK = 40e9


def full_bundle(dev, arch: str, lm=None):
    """``arch``'s ModelBundle at full width (or ``lm``): random f32 masters
    from seed 0 on the host, bf16 working copies on the card, 4 slots, the
    8x8 array with a DPPU of 4, fused.  Prints the build seconds, the
    masters' host bytes, the card's bytes after the build and its peak
    during it, and the host's available memory after it; holds every master
    to the host and every working copy to the card."""
    from repro_torch.configs import get_config
    from repro_torch.serving import ModelBundle, ServerConfig
    from repro_torch.tree import tree_leaves

    lm = lm or get_config(arch)
    cfg = ServerConfig(arch=arch, device=str(dev), dispatch="fused", n_slots=4, rows=ROWS, cols=COLS,
                       dppu_size=4, smax=96, seed=0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bundle = ModelBundle(cfg, lm=lm)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    work_bytes = sum(a.numel() * a.element_size() for a in tree_leaves(bundle.work))
    check(all(a.device.type == "cpu" and a.dtype == torch.float32 for a in tree_leaves(bundle.params))
          and all(a.device.type == "cuda" for a in tree_leaves(bundle.work)),
          f"{lm.name}: the masters are not all on the host, or the working copies not all on the card")
    if lm.name == DEEPSEEK:
        check(peak - base < DEEPSEEK_BUILD_PEAK, f"{lm.name}: the build's peak on the card is {peak - base} bytes")
    phase("bundle", arch=lm.name, layers=lm.n_layers, d_model=lm.d_model, vocab=lm.padded_vocab,
          family=lm.family, attn=lm.attn_kind, norm=lm.norm, experts=lm.moe.n_padded if lm.moe else 0,
          seconds=seconds, device_gib=round(torch.cuda.memory_allocated() / 2**30, 3),
          work_bytes=work_bytes, master_host_bytes=bundle.master_bytes, build_peak_device_bytes=peak - base,
          host_mem_available=host_memory()["MemAvailable"])
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


# a full-width model cut to two layers on the card against the CPU, f32: each
# step's logits, relative to the CPU's max |logit| (the two sum in other
# orders).  Its KV caches are f32: a bf16 cache rounds the two sides' values,
# a few ulps apart, to neighbouring bf16 values now and then, and such a flip
# moves the logits by a bf16 ulp of a K or V entry and can turn an expert's
# top-6.  Its fault sits on mantissa bit 10: a carry of those few
# ulps into a stuck bit b moves a value by 2^(b - 23) of its binade (ROADMAP
# C, known limits), 1.2e-4 at bit 10, 0.125 at bit 20.
REFERENCE_TOL = 1e-4
REFERENCE_FAULT = (1, 2, 10, 1)

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
    # the f32 masters live on the host: the four matrices go to the card
    blk = bundle.params["blocks"][0]
    f32 = (("q_1024x1024", blk["attn"]["wq"].to(dev)), ("up_1024x2816", blk["ffn"]["up"].to(dev)),
           ("down_2816x1024", blk["ffn"]["down"].to(dev)), ("head_1024x152064", bundle.params["embed"].to(dev).T))
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
    w = bundle.params["blocks"][0]["ffn"]["up"].to(dev)  # the f32 master, from the host
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
           RWKV6: (4, 512), ZAMBA2: (4, 512), DEEPSEEK: (4, 512)}
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
    DEEPSEEK: (
        ("qkvo_2048x2048x2048", 2048, 2048, 2048, 28 * 4),
        ("dense_gate_up_2048x2048x10944", 2048, 2048, 10944, 2),
        ("dense_down_2048x10944x2048", 2048, 10944, 2048, 1),
        ("shared_gate_up_2048x2048x2816", 2048, 2048, 2816, 27 * 2),
        ("shared_down_2048x2816x2048", 2048, 2816, 2048, 27),
        ("router_2048x2048x64", 2048, 2048, 64, 27),
        ("head_4x2048x102400", 4, 2048, 102400, 1),
    ),
}
# (name, E, M, K, N, launches per prefill) of ft_matmul_batched: M = B x the
# expert capacity, int(1.25 * top_k * S / n_experts) slots: granite's 128
# (top-8 of 40 experts), deepseek's 60 (top-6 of 64)
PREFILL_EXPERT_SHAPES = {
    **{arch: () for arch in PREFILL},
    GRANITE: (
        ("gate_up_48x512x1536x512", 48, 512, 1536, 512, 32 * 2),
        ("down_48x512x512x1536", 48, 512, 512, 1536, 32),
    ),
    DEEPSEEK: (
        ("gate_up_64x240x2048x1408", 64, 240, 2048, 1408, 27 * 2),
        ("down_64x240x1408x2048", 64, 240, 1408, 2048, 27),
    ),
}
# (name, E, M, K, N, launches per batch) of the benchmark's prefill cells
# (hyca_bench/traffic/prefill.json: batches of B x S = 8192 tokens, S of 512,
# 1024 or 2048): E = 1 an ft_matmul call at M = 8192, else ft_matmul_batched
# with M per expert B x capacity, the same at every S: granite's 48 x 2048,
# deepseek's 64 x 960.  The heads (M = B, K-fast) are left out.
BENCH_PREFILL_SHAPES = {
    GRANITE: (
        ("q_out_8192x1536x1536", 1, 8192, 1536, 1536, 32 * 2),
        ("kv_8192x1536x512", 1, 8192, 1536, 512, 32 * 2),
        ("router_8192x1536x48", 1, 8192, 1536, 48, 32),
        ("gate_up_48x2048x1536x512", 48, 2048, 1536, 512, 32 * 2),
        ("down_48x2048x512x1536", 48, 2048, 512, 1536, 32),
    ),
    DEEPSEEK: (
        ("qkvo_8192x2048x2048", 1, 8192, 2048, 2048, 28 * 4),
        ("dense_gate_up_8192x2048x10944", 1, 8192, 2048, 10944, 2),
        ("dense_down_8192x10944x2048", 1, 8192, 10944, 2048, 1),
        ("shared_gate_up_8192x2048x2816", 1, 8192, 2048, 2816, 27 * 2),
        ("shared_down_8192x2816x2048", 1, 8192, 2816, 2048, 27),
        ("router_8192x2048x64", 1, 8192, 2048, 64, 27),
        ("gate_up_64x960x2048x1408", 64, 960, 2048, 1408, 27 * 2),
        ("down_64x960x1408x2048", 64, 960, 1408, 2048, 27),
    ),
}
# fused against twopass, last-position logits of a full-width bf16 prefill:
# the two accumulate each product in another order, both store bf16, and the
# one-ulp differences pass through every layer; a wrong kernel is off by the
# logits' own size
TWOPASS_PREFILL_TOL = 2.0**-3  # of max |logit|
# ...except where a one-ulp difference changes which experts a token is
# routed to.  The kernels accumulate on the tensor cores, as cuBLAS does; the
# twopass engine accumulates in IEEE f32 on the CUDA cores, so some bf16
# outputs land one ulp apart.  deepseek-moe-16b's router picks 6 of 64
# experts from bf16 logits, which tie often; each flipped pick moves a
# token's output by its own size and, through the experts' capacity, other
# tokens'.  Its twopass is held in f32 (serve_reference_full_width), its
# bf16 fused prefill against the plain dispatch's (cuBLAS); the bf16 twopass
# gap is printed with the flipped picks of each MoE layer, twopass's and
# plain's against fused's.
TWOPASS_BF16_UNHELD = (DEEPSEEK,)


def prefill_kernel_checks(dev) -> dict[str, float]:
    """``ft_matmul`` and ``ft_matmul_batched`` against their plain versions
    at every fused prefill's shapes (``PREFILL_SHAPES``; the heads at M = B
    are decode-sized) and the benchmark's (``BENCH_PREFILL_SHAPES``), bf16
    and f32, as :func:`_kernel_checks` holds them at the decode shapes: bf16
    from ``M_TILE`` rows on through the tile kernel.  Returns each kernel's
    max |kernel - plain| on random operands."""
    from repro_torch.kernels.ft_matmul import (
        ft_matmul, ft_matmul_batched, ft_matmul_batched_ref, ft_matmul_ref, plan_of,
    )

    g = torch.Generator(device=dev).manual_seed(9)
    and_g, or_g = fault_grids(dev)
    launches0 = {name: k.launches for name, k in _kernels().items()}
    errs, plans, max_abs = {}, {}, {"ft_matmul": 0.0, "ft_matmul_batched": 0.0}
    # zamba2 and deepseek share qkvo_2048x2048x2048: each shape is checked once
    dense = [s[:4] for a in PREFILL_SHAPES for s in PREFILL_SHAPES[a] if not s[0].startswith("head")]
    dense += [(s[0], s[2], s[3], s[4]) for a in BENCH_PREFILL_SHAPES for s in BENCH_PREFILL_SHAPES[a] if s[1] == 1]
    for name, m, k, n in dict.fromkeys(dense):
        for dtype in (torch.bfloat16, torch.float32):
            def operands(kind: str):
                return (_draw(g, dev, dtype, kind, (m, k), 1.0, kind == "frac_x"),
                        _draw(g, dev, dtype, kind, (k, n), 0.02, kind == "frac_w"))
            err, errs[f"{name} {str(dtype)[6:]}"] = _kernel_checks(f"ft_matmul {name}", ft_matmul, ft_matmul_ref,
                                                                   operands, and_g, or_g, dtype)
            max_abs["ft_matmul"] = max(max_abs["ft_matmul"], err)
            plans[name] = _plan_str(plan_of(*operands("integer")))
    experts = [(PREFILL[a][0], s) for a in PREFILL for s in PREFILL_EXPERT_SHAPES[a]]
    # the benchmark's experts drawn as at S = 512: 16 sequences of m / 16 slots
    experts += [(8192 // 512, s) for a in BENCH_PREFILL_SHAPES for s in BENCH_PREFILL_SHAPES[a] if s[1] > 1]
    for b, (name, e, m, k, n, _) in experts:
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
    twopass engine on the BIST faults, within TWOPASS_PREFILL_TOL of fused
    (for TWOPASS_BF16_UNHELD printed with each MoE layer's flipped router
    picks, and fused held to the plain dispatch within it instead).
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
            if hasattr(k, "tile_launches"):
                k.tile_launches = 0
        t1 = time.perf_counter()
        out[mode] = prefill(ctx)
        ms[mode] = 1e3 * (time.perf_counter() - t1)
        counts = {name: k.launches for name, k in kernels.items()}
        if mode == "protected":
            launches = counts
            tile_launches = {name: k.tile_launches for name, k in kernels.items() if hasattr(k, "tile_launches")}
        check(counts == {**dict.fromkeys(kernels, 0), **want}, f"{arch} prefill {mode}: launched {counts}, want {want}")
    off, prot, unprot = out["off"], out["protected"], out["unprotected"]
    b = batch["tokens"].shape[0]
    check(tuple(off.shape) == (b, 1, lm.padded_vocab) and off.dtype == lm.dtype,
          f"{arch} prefill: logits {tuple(off.shape)} {off.dtype}")
    check(bool(torch.isfinite(off[..., :lm.vocab].float()).all()), f"{arch} prefill off: non-finite logits")
    check(torch.equal(off.view(torch.int16), prot.view(torch.int16)), f"{arch} prefill: protected differs from off")
    check(not torch.equal(off.view(torch.int16), unprot.view(torch.int16)), f"{arch} prefill: unprotected equals off")
    held = arch not in TWOPASS_BF16_UNHELD
    routes = {"fused": [], "twopass": [], "plain": []}
    t1 = time.perf_counter()
    twopass = prefill(_prefill_ctx("protected", BIST_FAULTS, "twopass", dev) if held else
                      _recording_routes(_prefill_ctx("protected", BIST_FAULTS, "twopass", dev), lm, routes["twopass"]))
    twopass_ms = 1e3 * (time.perf_counter() - t1)

    def rel_to(other):
        a, b = prot[..., :lm.vocab].float(), other[..., :lm.vocab].float()
        return float((a - b).abs().max()) / float(a.abs().max()), float((a.argmax(-1) == b.argmax(-1)).float().mean())

    rel, agree = rel_to(twopass)
    extra = {}
    if held:
        check(rel <= TWOPASS_PREFILL_TOL, f"{arch} prefill: fused vs twopass {rel} of max |logit| > {TWOPASS_PREFILL_TOL}")
    else:
        again = prefill(_recording_routes(_prefill_ctx("protected", BIST_FAULTS, "fused", dev), lm, routes["fused"]))
        check(torch.equal(again.view(torch.int16), prot.view(torch.int16)), f"{arch} prefill: fused twice differs")
        plain_rel, plain_agree = rel_to(prefill(_recording_routes(_prefill_ctx("protected", [], "plain", dev), lm,
                                                                  routes["plain"])))
        check(plain_rel <= TWOPASS_PREFILL_TOL,
              f"{arch} prefill: fused vs plain {plain_rel} of max |logit| > {TWOPASS_PREFILL_TOL}")
        flips = {k: [int((f != t).any(-1).sum()) for f, t in zip(routes["fused"], routes[k])] for k in ("twopass", "plain")}
        extra = dict(twopass_routing_flips=flips["twopass"], plain_routing_flips=flips["plain"],
                     routed_tokens=int(routes["fused"][0].shape[0]), plain_rel=plain_rel, plain_agree=plain_agree)
    return dict(ctxs=ctxs, prefill=prefill, logits=out, ms=ms, launches=launches, tile_launches=tile_launches,
                twopass_rel=rel, twopass_agree=agree, twopass_ms=twopass_ms, twopass_held=held, **extra)


def _recording_routes(ctx, lm, log: list):
    """``ctx`` with the expert set the router's logits pick for each token
    appended to ``log`` at every MoE layer, (tokens, top_k) ascending, picked
    as ``models/moe.py`` picks them (a stable descending sort)."""
    matmul, k, e = ctx.matmul, lm.moe.top_k, lm.moe.n_experts

    def recording(x, w, *, site):
        out = matmul(x, w, site=site)
        if site == "moe.router":
            order = torch.sort(out.float()[..., :e].reshape(-1, e), dim=-1, descending=True, stable=True).indices
            log.append(order[:, :k].sort(dim=-1).values)
        return out

    ctx.matmul = recording
    return ctx


def prefill_phase(dev, smi: str, bundle) -> dict[str, dict]:
    """The fused prefill at full width: ``forward(last_only=True)`` on
    ``prefill_batch`` through ``FTContext`` under ``fused``, the reference's
    production prefill, in the modes of :func:`prefill_modes`; then the
    kernels at the prefill's shapes, their times against the library call
    and the bound (:func:`time_kernel_shapes`).  Returns {kernel:
    per-prefill totals, with the launches the protected prefill made}, and
    the prefill's batch, contexts and each mode's logits."""
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
          launches=r["launches"], tile_launches=r["tile_launches"], protected_equals_off=True, unprotected_differs=True,
          fused_vs_twopass_over_max_logit=r["twopass_rel"], fused_vs_twopass_tol=TWOPASS_PREFILL_TOL,
          fused_twopass_argmax_agree=r["twopass_agree"], fused_vs_twopass_held=r["twopass_held"],
          **{k: r[k] for k in ("twopass_routing_flips", "plain_routing_flips", "routed_tokens", "plain_rel",
                               "plain_agree") if k in r},
          prefill_ms={**r["ms"], "protected_runs": times, "twopass": r["twopass_ms"]},
          kernel_ms_per_prefill={k: v["ms"] for k, v in totals.items()},
          library_ms_per_prefill={k: v["library_ms"] for k, v in totals.items()},
          bound_ms_per_prefill={k: v["bound_ms"] for k, v in totals.items()},
          phase_s=time.perf_counter() - t0, card=smi)
    return totals, dict(batch=batch, ctxs=r["ctxs"], logits=r["logits"])


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
    if arch == DEEPSEEK:  # the remap at full width: the planner's salience streamed from the host masters
        serve_remap_phase(bundle, smi, arch)
    return bundle, runs


def full_width_reference_phase(dev, smi: str, arch: str) -> dict:
    """``arch`` at full width cut to two layers (deepseek-moe-16b: its dense
    layer and one MoE layer of 64 + 2 experts, 1.1 B params), f32 working
    copies: ``decode_step`` on one batch of 4 slots (8 prompt tokens, then
    4 greedy ones) on the card (the kernels) and on the CPU (the plain
    versions), from the same host masters, with f32 KV caches, fault-free
    and unprotected with REFERENCE_FAULT.  Both are fed the CPU's tokens;
    every step's logits are held within REFERENCE_TOL of the CPU's max
    |logit|, every argmax to the CPU's, and the card's launches to the
    step's calls as recorded on ``meta``: the path's real widths (top-6 of
    64 experts at a decode capacity of 1, the dense FFN at K = 10944)
    through the kernels in context.  Then the fused prefill of PREFILL's
    batch against the twopass engine on the card, in f32, within
    REFERENCE_TOL (TWOPASS_BF16_UNHELD)."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import decode_step, forward, init_cache

    t0 = time.perf_counter()
    lm = dataclasses.replace(get_config(arch), n_layers=2, first_k_dense=1, dtype=torch.float32)
    bundle = full_bundle(dev, arch, lm=lm)
    params = {dev.type: bundle.work, "cpu": bundle.params}
    n, prompt, gen = 4, 8, 4
    tokens = torch.randint(0, lm.vocab, (n, prompt), generator=torch.Generator().manual_seed(4), dtype=torch.int32)
    kernels = _kernels()
    out, last = {}, {}
    for mode, faults in (("off", ()), ("unprotected", (REFERENCE_FAULT,))):
        ctxs = {d: _prefill_ctx("protected" if mode == "off" else mode, faults, "fused", d) for d in (dev.type, "cpu")}
        caches = {d: init_cache(lm, n, prompt + gen, torch.float32, device=d) for d in ctxs}
        want = decode_shapes(lm, ctxs["cpu"], bundle.work, n)
        for k in kernels.values():
            k.launches = 0
        rel, argmax_equal, tok = [], True, tokens[:, :1]
        for t in range(prompt + gen):
            logits = {}
            for d in ctxs:
                with torch.no_grad():
                    lg, _ = decode_step(params[d], lm, caches[d], {"token": tok.to(d)}, ftc=ctxs[d])
                logits[d] = lg[:, 0, :lm.vocab].float().cpu()
            g, c = logits[dev.type], logits["cpu"]
            last[mode] = g
            rel.append(float((g - c).abs().max() / c.abs().max()))
            argmax_equal &= torch.equal(g.argmax(-1), c.argmax(-1))
            tok = tokens[:, t + 1:t + 2] if t + 1 < prompt else c.argmax(-1, keepdim=True).to(torch.int32)
        counts = {name: k.launches for name, k in kernels.items()}
        steps = prompt + gen
        per = {name: sum(v for (kn, *_), v in want.items() if kn == name)
               for name in ("ft_matmul", "ft_matmul_batched")}
        check(all(counts[name] == steps * per[name] for name in per),
              f"{arch} 2 layers {mode}: launched {counts} in {steps} steps, the step calls {per}")
        check(max(rel) <= REFERENCE_TOL, f"{arch} 2 layers {mode}, card vs CPU: logits differ by {max(rel)} "
              f"of max |logit| (every step: {rel})")
        check(argmax_equal, f"{arch} 2 layers {mode}, card vs CPU: a greedy token differs")
        out[mode] = dict(max_rel_err_logits=max(rel), rel_err_by_step=rel, launches_per_step=per)
    check(not torch.equal(last["off"], last["unprotected"]), f"{arch} 2 layers: the fault moved no logit")
    # the fused prefill against the twopass engine on the card, in f32, where
    # no one-ulp difference turns a router's pick (TWOPASS_BF16_UNHELD)
    batch = prefill_batch(lm, dev, torch.Generator(device=dev).manual_seed(3))
    pre = {}
    for dispatch in ("fused", "twopass"):
        with torch.no_grad():
            lg, _ = forward(bundle.work, lm, batch, ftc=_prefill_ctx("protected", BIST_FAULTS, dispatch, dev),
                            last_only=True)
        pre[dispatch] = lg[..., :lm.vocab].float()
    twopass_rel = float((pre["fused"] - pre["twopass"]).abs().max() / pre["twopass"].abs().max())
    check(twopass_rel <= REFERENCE_TOL and torch.equal(pre["fused"].argmax(-1), pre["twopass"].argmax(-1)),
          f"{arch} 2 layers, f32 prefill: fused vs twopass {twopass_rel} of max |logit|")
    phase("serve_reference_full_width", arch=arch, layers=lm.n_layers, first_k_dense=lm.first_k_dense, dtype="f32",
          cache="f32", slots=n, prompt=prompt, gen=gen, params=lm.n_params(), tol=REFERENCE_TOL,
          fault=REFERENCE_FAULT, tokens_equal=True, **out, prefill=PREFILL[arch],
          prefill_fused_vs_twopass_over_max_logit=twopass_rel, phase_s=time.perf_counter() - t0, card=smi)
    del bundle, params, caches
    free_host_memory()
    torch.cuda.empty_cache()
    return out


# qwen1.5-0.5b training at the reference CLI's defaults: batch 8, seq 128,
# 2 microbatches, lr 1e-3, the 32x32 array with 4 seeded faults, twopass
TRAIN = dict(batch=8, seq=128, n_micro=2, lr=1e-3, faults=4, steps=5, seed=0)
# its depth: the first 4 of the served bundle's 24 layers, at full width
# (at 24 layers the phase and the checkpoint's took 266 s of the script on an H100)
TRAIN_LAYERS = 4


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
    """qwen1.5-0.5b's train step at full width and ``TRAIN_LAYERS`` deep
    (``launch/train.py``, the bundle's f32 masters of those layers as the
    params) at the reference CLI's defaults,
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
    from repro_torch.tree import map_with_path, tree_leaves, tree_map

    t0 = time.perf_counter()
    lm = dataclasses.replace(bundle.lm, n_layers=TRAIN_LAYERS)
    masters = {**bundle.params, "blocks": bundle.params["blocks"][:TRAIN_LAYERS]}
    params = tree_map(lambda a: a.to(dev), masters)  # the f32 masters, from the host
    tc = T.TrainConfig(n_micro=TRAIN["n_micro"], opt=AdamWConfig(lr=TRAIN["lr"]), total_steps=TRAIN["steps"],
                       warmup=max(1, TRAIN["steps"] // 10), hyca_mode="protected", hyca_dispatch="twopass")
    hyca = HyCAConfig(rows=32, cols=32, mode="protected")
    check(TRAIN["faults"] <= hyca.capacity, f"{TRAIN['faults']} faults past the DPPU's {hyca.capacity}")
    faults = T.cli_fault_state(TRAIN["faults"], TRAIN["seed"], device=dev)
    data = SyntheticLM(DataConfig(seed=TRAIN["seed"], batch=TRAIN["batch"], seq_len=TRAIN["seq"]), lm)
    batches = [T.batch_to(data.batch(i), dev) for i in range(TRAIN["steps"])]
    start = {"params": params, "opt": adamw_init(params)}

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
        mask = grad_mask(params, RetrainConfig(trainable=("ffn",)))
        masked = run(T.make_train_step(lm, tc, hyca=hyca, grad_mask=mask), faults, 2)[0]["last"]
        frozen = map_with_path(lambda path, layer, t: "ffn" not in path, params)
        pairs = list(zip(tree_leaves(frozen), tree_leaves(params), tree_leaves(masked["params"])))
        check(all(torch.equal(a, b) for f, a, b in pairs if f) and all(not torch.equal(a, b) for f, a, b in pairs
                                                                    if not f),
              "train: a frozen leaf moved, or an ffn leaf did not, under grad_mask(('ffn',))")
        del masked, pairs
        # one step profiled (device activity only): its device events' time over the unprofiled median step
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    out = dict(arch=lm.name, layers=lm.n_layers, of_layers=bundle.lm.n_layers, remat=lm.remat, dtype=str(lm.dtype)[6:], **TRAIN,
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
    """The full-width train state (``TRAIN_LAYERS`` deep) after 2 steps saved and restored bit for
    bit; 2 more steps from the restored state bitwise the straight run's 4
    (deterministic mode); a tampered checkpoint re-fetched from a pristine
    copy, then refused with no source; ``memory_fault_records`` of both.
    The checkpoints live under build/ in the checkout and are removed."""
    import tempfile

    from repro_torch.checkpoint import store
    from repro_torch.obs.events import EventLog, memory_fault_records
    from repro_torch.transient import memory

    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt-", dir=BUILD_DIR)
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
    from repro_torch.tree import tree_leaves

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
    # the fine-tune ran on the card, from the host masters; the repaired masters went back to the host
    check(report["device"].startswith("cuda")
          and all(a.device.type == "cpu" and a.dtype == torch.float32 for a in tree_leaves(srv.master_params))
          and all(a.device.type == "cuda" and a.dtype == bundle.lm.dtype for a in tree_leaves(srv.params)),
          f"{arch} retrain: fine-tuned on {report['device']}; the repaired masters on the host and the "
          f"working copies on the card is not what the server holds")
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
               retrain_losses=report["losses"], retrain_s=report["seconds"], retrain_device=report["device"],
               eager_retrain_s=eager["server"].retrain_reports[0]["seconds"], captures=run["captures"],
               sibling_captures=sib["captures"], sibling_equals_before=True, graph_equals_eager=True,
               launches=counts, step_ms_median_after=ms, tokens_per_s_after=tps,
               repair_step_s=run["times"][REMAP_AT], phase_s=time.perf_counter() - t0, card=smi)
    phase("serve_retrain", **out)
    return out


# --------------------------------------------------------------------------- #
# the paper's own evaluation: the campaign engine and the Fig. 2 accuracy campaign
# --------------------------------------------------------------------------- #
CAMPAIGN_WORKERS = 7  # numpy sampling + per-config reference loops, beside the card
FIG10_PERS = (0.005, 0.01, 0.02, 0.025, 0.03, 0.0313, 0.035, 0.04, 0.06)  # benchmarks/fig10_ffp.py
FIG14_SIZES = (16, 32, 64, 128)  # benchmarks/fig14_scalability.py, square arrays
FIG14_PERS = (0.005, 0.01, 0.02, 0.03)


def _reference_point(task):
    """Worker: one operating point sampled with the numpy sampler and
    evaluated with the per-config numpy loop (every scheme, and HyCA under
    repair="remap"); its seconds of each."""
    from repro_torch.core import campaign as cp

    spec, per, seed = task
    t0 = time.perf_counter()
    point = cp.sample_point(spec, per, seed=seed)
    t1 = time.perf_counter()
    ref = {s: cp.evaluate_reference(point, s) for s in spec.schemes}
    ref["HyCA/remap"] = cp.evaluate_reference(point, "HyCA", "remap")
    return task, point, ref, t1 - t0, time.perf_counter() - t1


def _evaluate_all(cp, point, dev):
    """Every scheme's (ff, surv) on ``dev`` (HyCA also under remap), each
    with its seconds (synchronised)."""
    maps = torch.as_tensor(point.maps).to(dev)
    out, secs = {}, {}
    for key in ("RR", "CR", "DR", "HyCA", "HyCA/remap"):
        scheme, _, repair = key.partition("/")
        aux = point.hyca_caps if scheme == "HyCA" else point.spare_faulty[scheme]
        t0 = time.perf_counter()
        ff, surv = cp.evaluate_batched(maps, torch.as_tensor(aux).to(dev), scheme=scheme, repair=repair or "none")
        out[key] = (ff.cpu().numpy(), surv.cpu().numpy())
        secs[key] = time.perf_counter() - t0
    return out, secs


def _table_equals(name: str, table: dict) -> bool:
    """``table`` equals the reference's result file's, float for float."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "experiments", "bench", f"{name}.json")
    with open(path) as f:
        ref = json.load(f)["table"]
    return json.loads(json.dumps(table, default=float)) == ref


def campaign_phase(dev, smi) -> dict:
    import multiprocessing

    from repro_torch.bench import campaign as tw_campaign
    from repro_torch.bench import fig10_ffp as tw_fig10
    from repro_torch.core import campaign as cp
    from repro_torch.core import redundancy as red

    t_phase = time.perf_counter()
    out: dict = {"card": smi}
    # 1. the twins at quick size: the reference's tables, float for float
    for name, twin in (("campaign", tw_campaign), ("fig10_ffp", tw_fig10)):
        t0 = time.perf_counter()
        res = twin.run(True, device=dev)
        out[f"{name}_quick_s"] = time.perf_counter() - t0
        check(res["all_ok"], f"{name} twin claims: {[c for c in res['claims'] if not c['ok']]}")
        check(_table_equals(name, res["table"]), f"{name} twin's quick table differs from experiments/bench/{name}.json")
    # 2. full sizes: card == CPU == numpy loop, config by config
    tasks = []
    for model in ("random", "clustered"):
        spec = cp.CampaignSpec(rows=32, cols=32, fault_model=model, n_configs=3000, dppu=red.DPPUConfig(size=32))
        tasks += [(spec, p, cp.point_seed(0, i)) for i, p in enumerate(FIG10_PERS)]
        for size in FIG14_SIZES:
            spec = cp.CampaignSpec(rows=size, cols=size, fault_model=model, n_configs=1500,
                                   dppu=red.DPPUConfig(size=size))
            tasks += [(spec, p, cp.point_seed(0, i)) for i, p in enumerate(FIG14_PERS)]
    # the longest numpy work first, so the workers finish together
    tasks.sort(key=lambda t: -t[0].rows * t[0].cols * t[0].n_configs * t[1] * (3 if t[0].fault_model == "clustered" else 1))
    per_cell: dict = {}
    dr_ms: dict = {}
    configs = 0
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(CAMPAIGN_WORKERS) as pool:
        for (spec, per, _), point, ref, sample_s, numpy_s in pool.imap_unordered(_reference_point, tasks):
            card, card_s = _evaluate_all(cp, point, dev)
            cpu, _ = _evaluate_all(cp, point, "cpu")
            for key, (ff, surv) in ref.items():
                for name, got in (("card", card[key]), ("cpu", cpu[key])):
                    check(np.array_equal(got[0], ff) and np.array_equal(got[1], surv),
                          f"campaign {spec.fault_model} {spec.rows}x{spec.cols} per={per} {key}: {name} != numpy loop "
                          f"({int((got[0] != ff).sum())} ff, {int((got[1] != surv).sum())} surv differ)")
            configs += spec.n_configs
            cell = per_cell.setdefault(f"{spec.rows}x{spec.cols}/{spec.n_configs}", dict(points=0, card_s=0.0, numpy_s=0.0, sample_s=0.0))
            cell["points"] += 1
            cell["card_s"] += sum(card_s.values())
            cell["numpy_s"] += numpy_s
            cell["sample_s"] += sample_s
            dr_ms.setdefault(f"{spec.rows}x{spec.cols}/{spec.n_configs}", []).append(card_s["DR"] * 1e3)
    per_point = {k: dict(points=v["points"], card_s_per_point=v["card_s"] / v["points"],
                         numpy_loop_s_per_point=v["numpy_s"] / v["points"],
                         numpy_sample_s_per_point=v["sample_s"] / v["points"]) for k, v in per_cell.items()}
    out.update(points=len(tasks), configs_checked=configs, equal_card_cpu_numpy=True, per_point=per_point,
               dr_ms={k: dict(median=float(np.median(v)), max=float(np.max(v))) for k, v in dr_ms.items()
                      if k in ("32x32/3000", "128x128/1500")})
    # 3. the device samplers on the card, held statistically
    per, n, rows, cols = 0.02, 3000, 32, 32
    maps = cp.device_random_maps(11, n, rows, cols, per, device=dev)
    rate = maps.float().mean().item()
    hw = cp.binomial_halfwidth(per, n * rows * cols, z=4.0)
    check(abs(rate - per) < hw, f"device_random_maps rate {rate} not within {per} +- {hw}")
    sigmas = {}
    for sigma in (0.5, 1.5, 500.0):
        m = cp.device_clustered_maps(12, 1500, rows, cols, 0.03, cluster_sigma=sigma, device=dev)
        g = torch.Generator(device=dev).manual_seed(12)
        target = (torch.rand((1500, rows * cols), generator=g, device=dev) < 0.03).sum(dim=1)
        check(m.shape == (1500, rows, cols) and m.dtype == torch.bool, f"clustered maps {m.shape} {m.dtype}")
        check(torch.equal(m.reshape(1500, -1).sum(dim=1), target), f"clustered maps at sigma {sigma} miss their counts")
        r = m.float().mean().item()
        check(abs(r - 0.03) < cp.binomial_halfwidth(0.03, m.numel(), z=4.0), f"clustered rate {r} at sigma {sigma}")
        sigmas[str(sigma)] = r
    dcfg = red.DPPUConfig(size=32)
    dcap = cp.device_dppu_capacity(13, dcfg, 0.02, n, device=dev).cpu().numpy()
    ncap = red.dppu_capacity(np.random.default_rng(13), dcfg, 0.02, n)
    tol = cp.mean_halfwidth(dcap, z=4.0) + cp.mean_halfwidth(ncap, z=4.0)
    check(abs(dcap.mean() - ncap.mean()) < tol, f"device DPPU capacity mean {dcap.mean()} vs numpy {ncap.mean()} (+-{tol})")
    spec = cp.CampaignSpec(rows=32, cols=32, n_configs=3000, sampler="device", dppu=dcfg)
    t0 = time.perf_counter()
    drun = cp.run_campaign(spec, FIG10_PERS, device=dev)
    torch.cuda.synchronize()
    device_sampler_s = (time.perf_counter() - t0) / len(FIG10_PERS)
    check(drun.table()["HyCA"][0.01] > 0.9 and drun.table()["HyCA"][0.06] >= drun.table()["RR"][0.06],
          f"device-sampled campaign: {drun.table()}")
    out.update(device_random_rate=rate, device_clustered_rates=sigmas, device_capacity_mean=float(dcap.mean()),
               numpy_capacity_mean=float(ncap.mean()), device_sampler_campaign_s_per_point=device_sampler_s,
               seconds=time.perf_counter() - t_phase)
    phase("campaign", **out)
    return out


def accuracy_campaign_phase(dev, smi) -> dict:
    from repro_torch.bench import fig02_accuracy_vs_per as fig02
    from repro_torch.core.campaign import take_config
    from repro_torch.core.engine import HyCAConfig, hyca_matmul, hyca_matmul_batched

    peaks, held, base = [], [], [0]
    cfgs = (HyCAConfig(mode="protected"), HyCAConfig(mode="unprotected"))

    def hold_point(per, mlp, xte, states) -> int:
        """Each layer's batched call on the card against the same call on the
        CPU and against hyca_matmul per config, on 4 configs; returns 4."""
        n = states.fpt.shape[0]
        picks = sorted({0, n // 3, (2 * n) // 3, n - 1})
        cpu_states = states.to("cpu")
        ws = mlp.weights(dev)
        for cfg in cfgs:
            h = torch.from_numpy(xte).to(dev)
            for i, w in enumerate(ws):
                hq = mlp.layer_input(h, i)
                x_axis = None if i == 0 else 0
                card = hyca_matmul_batched(hq, w, states, cfg=cfg, x_axis=x_axis)
                cpu = hyca_matmul_batched(hq.cpu(), w.cpu(), cpu_states, cfg=cfg, x_axis=x_axis)
                check(torch.equal(card.cpu(), cpu), f"fig02 per={per} {cfg.mode} layer {i}: card != CPU")
                for j in picks:
                    one = hyca_matmul(hq if i == 0 else hq[j], w, take_config(states, j), cfg=cfg)
                    check(torch.equal(card[j], one), f"fig02 per={per} {cfg.mode} layer {i} config {j}: batched != hyca_matmul")
                h = mlp.layer_output(card, i)
        return len(picks)

    def reset_peak() -> None:
        # the twin's own peak is read above what stays allocated from before
        torch.cuda.synchronize()
        base[0] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    def check_point(per, mlp, xte, states):
        peaks.append(torch.cuda.max_memory_allocated() - base[0])  # the twin's, before these checks
        held.append(hold_point(per, mlp, xte, states))
        reset_peak()

    reset_peak()
    allocated_before = base[0]
    t0 = time.perf_counter()
    res = fig02.run(False, device=dev, check_point=check_point)
    seconds = time.perf_counter() - t0
    check(res["all_ok"], f"fig02 twin claims: {[c for c in res['claims'] if not c['ok']]}")
    check(len(held) == len(fig02.PERS) and min(held) == 4, f"fig02 checks ran at {held}")
    out = dict(n_configs=res["n_configs"], n_test=res["n_test"], pers=fig02.PERS, clean_acc=res["clean_acc"],
               unprotected_mean={str(p): a["mean"] for p, a in res["accuracy"]["unprotected"].items()},
               protected_mean={str(p): a["mean"] for p, a in res["accuracy"]["protected"].items()},
               recovered_exact=res["recovered_exact"], claims=[c["claim"] for c in res["claims"]],
               configs_checked_bitwise=sum(held) * len(cfgs), seconds_per_point=res["seconds_per_point"],
               seconds=seconds, peak_bytes_above_allocated=max(peaks), allocated_before_bytes=allocated_before,
               card=smi)
    phase("accuracy_campaign", **out)
    return out


def paper_phases(dev, smi) -> None:
    """The paper's own evaluation, counted from 0: it must launch none of
    the csrc kernels."""
    kernels = {**_kernels(), **_two_pass_kernels()}
    before = {name: k.launches for name, k in kernels.items()}
    for k in kernels.values():
        k.launches = 0
    campaign_phase(dev, smi)
    accuracy_campaign_phase(dev, smi)
    repair_recovery_phase(dev, smi)
    launched = {name: k.launches for name, k in kernels.items()}
    check(not any(launched.values()), f"the campaign phases launched csrc kernels: {launched}")
    for name, k in kernels.items():
        k.launches = before[name]


# --------------------------------------------------------------------------- #
# the fleet: full-width replicas, the vectorized engine, the campaign retrain
# --------------------------------------------------------------------------- #
FLEET_PARITY_KEYS = (
    "goodput_tokens", "requests_completed", "requests_expired",
    "requests_lost", "requests_unrouted", "retirements", "replacements",
    "spares_remaining", "chaos_injected", "alive_final",
    "slo_requests", "slo_met", "slo_misses",
)
FLEET_BASELINE = dict(goodput_tokens=98047, requests_completed=11556, latency_e2e_p50=14.0, latency_e2e_p99=24.0)
HEADLINE_AIM_S = 60.0
# ft_overhead's full mode (48 steps x 8 repeats x 16 slots) on the card, cut
# to the dense family, whose fused overhead the ROADMAP target reads: the
# other two run in quick mode only (on an H100, deepseek-moe's eager twopass
# experts take ~100 s of full mode, 106 ms a step; rwkv6-7b took 35 s of it)
FT_FULL_FAMILIES = ("qwen1.5-0.5b",)


def fleet_cfg(device: str, dispatch: str = "fused"):
    """4 replicas of qwen's server (4 slots, the 8x8 array, DPPU 4), 2 pooled
    spares, 120 steps; a chaos burst on replica 0 at step 24 (seed 6: the
    one of seeds 1-7 at per 0.15 whose burst retires the replica)."""
    from repro_torch.serving import ChaosSpec, FleetConfig, ServerConfig, TrafficSpec

    return FleetConfig(
        n_replicas=4, n_spares=2, steps=120, seed=0,
        chaos=ChaosSpec(per=0.15, at_step=24, seed=6, replicas=(0,)),
        traffic=TrafficSpec(request_rate=0.3, sla_steps=64, seed=2, n_classes=2, tail=0.4),
        server=ServerConfig(n_slots=4, smax=64, mode="protected", dispatch=dispatch, scan_block=2,
                            rows=ROWS, cols=COLS, dppu_size=4, device=device),
    )


def fleet_phase(dev, smi) -> dict[str, int]:
    """run_fleet at qwen1.5-0.5b's full width on the card, every replica's
    step captured and fused, a spare capturing after the chaos retirement;
    held to run_vfleet on the card and to run_fleet at smoke size on the
    CPU.  Returns the launches of the run (the counts set to 0 just before
    it, read just after)."""
    import weakref

    from repro_torch.configs import get_config
    from repro_torch.serving import fleet as fl
    from repro_torch.serving import run_fleet, run_vfleet
    from repro_torch.serving.server import FaultTolerantServer

    cfg = fleet_cfg(str(dev))
    made, log = [], []   # weak refs to every server; (fleet step, seconds) of every replica step
    first = {}           # the first step of each server: capture s, captures, allocated bytes after it
    fresh = fl._fresh_server

    def spy(bundle, fcfg, seed):
        srv = fresh(bundle, fcfg, seed)
        ref = weakref.ref(srv)
        made.append(ref)

        def step():
            s = ref()
            if not s.decode.captures and len(made) > fcfg.n_replicas:
                # a spare's first step: the server it replaces must be gone
                gc.collect()
                first["alive_before_spare"] = sum(r() is not None for r in made)
                first["allocated_before_spare"] = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            out = FaultTolerantServer.step(s)  # ends in the step's host sync
            log.append((s.step_idx - 1, time.perf_counter() - t0))
            if s.decode.captures == 1 and id(s) not in first:
                first[id(s)] = dict(capture_s=s.decode.capture_s, pool_bytes=s.decode.pool_bytes,
                                    allocated=torch.cuda.memory_allocated(dev), at_step=s.step_idx - 1)
            if s.step_idx - 1 == fcfg.chaos.at_step - 1 and "allocated_before_chaos" not in first:
                first["allocated_before_chaos"] = torch.cuda.memory_allocated(dev)
            return out

        srv.step = step
        return srv

    kernels = _kernels()
    gc.collect()
    torch.cuda.empty_cache()
    allocated_start = torch.cuda.memory_allocated(dev)
    fl._fresh_server = spy
    try:
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        card = run_fleet(cfg, lm=get_config(QWEN))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: k.launches for name, k in kernels.items()}
    finally:
        fl._fresh_server = fresh
    gc.collect()
    torch.cuda.empty_cache()
    allocated_freed = torch.cuda.memory_allocated(dev)
    servers = [v for k, v in first.items() if isinstance(k, int)]
    replica_steps = len(log)
    check(len(made) == cfg.n_replicas + card["replacements"] and card["replacements"] >= 1,
          f"fleet: {len(made)} servers for {card['replacements']} replacements")
    check(len(servers) == len(made) and all(v["capture_s"] is not None for v in servers),
          f"fleet: {len(servers)} of {len(made)} servers captured their step")
    check(first.get("alive_before_spare") == cfg.n_replicas,
          f"fleet: {first.get('alive_before_spare')} servers alive at the spare's first step, want {cfg.n_replicas} "
          f"(the retired server, its graph and cache must be released)")
    check(all(r() is None for r in made), "fleet: a server outlived run_fleet")
    check(counts["ft_matmul"] == per_step(QWEN)["ft_matmul"] * replica_steps
          and counts["probe_check_pair"] == replica_steps and not counts["ft_matmul_batched"],
          f"fleet: launches {counts} over {replica_steps} replica steps")
    vec = run_vfleet(cfg)
    cpu = run_fleet(fleet_cfg("cpu"))
    for name, other in (("run_vfleet on the card", vec), ("run_fleet at smoke size on the CPU", cpu)):
        diffs = {k: (card[k], other[k]) for k in FLEET_PARITY_KEYS if card[k] != other[k]}
        check(not diffs, f"fleet at full width vs {name}: {diffs}")
    diffs = {k: (card[k], cpu[k]) for k in card if card[k] != cpu[k]}
    check(not diffs, f"fleet at full width vs smoke size on the CPU: {diffs}")
    # the chaos-hit replica retires, and its server's detections leave with
    # it (the report reads the current servers' logs, as the reference's)
    check(card["retirements"] >= 1 and card["chaos_injected"] > 0,
          f"fleet: {card['chaos_injected']} chaos faults, {card['retirements']} retirements")
    by_step: dict[int, float] = {}
    for st, sec in log:
        by_step[st] = by_step.get(st, 0.0) + sec
    steps_s = [by_step[k] for k in sorted(by_step)]
    spare = servers[cfg.n_replicas:]
    out = dict(arch=QWEN, replicas=cfg.n_replicas, spares=cfg.n_spares, steps=cfg.steps, dispatch="fused",
               replica_steps=replica_steps, launches=counts, launches_per_replica_step=per_step(QWEN)["ft_matmul"],
               fleet_step_ms_median=1e3 * float(np.median(steps_s[2:])),
               fleet_tokens_per_s=card["goodput_tokens"] / sum(steps_s), wall_s=wall,
               captures=len(servers), capture_s=[v["capture_s"] for v in servers],
               spare_capture_s=[v["capture_s"] for v in spare], spare_first_step=[v["at_step"] for v in spare],
               pool_bytes=[v["pool_bytes"] for v in servers],
               allocated_start=allocated_start, allocated_before_chaos=first.get("allocated_before_chaos"),
               allocated_before_spare=first.get("allocated_before_spare"),
               allocated_after_replacement=spare[0]["allocated"] if spare else None,
               allocated_after_fleet_freed=allocated_freed,
               **{k: card[k] for k in FLEET_PARITY_KEYS},
               detect_latency_p50_steps=card["detect_latency_p50_steps"],
               suspect_latency_p50_steps=card["suspect_latency_p50_steps"], detections=card["detections"],
               equal_to=["run_vfleet on the card (13 keys)", "run_fleet at smoke size on the CPU (every key)"],
               card=smi)
    phase("fleet", **out)
    return counts


def vfleet_phase(dev, smi) -> dict:
    """The fleet_goodput twin on the card: the quick sweep (its baseline row
    equal to the reference's result file on every count), the pinned
    parity configs against run_fleet on the CPU, and the headline at 1000
    replicas, at 10 000 steps if its first chunk shows it fits the aim."""
    import dataclasses as dc

    from repro_torch.bench import fleet_goodput as fg
    from repro_torch.serving import ChaosSpec, FleetConfig, ServerConfig, TrafficSpec, run_fleet, run_vfleet
    from repro_torch.serving import vfleet as vf

    builds0 = len(vf._TRACES)
    # the headline's first chunk alone, to size the headline
    probe = dc.replace(fg._sweep_cfg(1000, 10_000, "pool", chaos=True, device=str(dev)), steps=250)
    run_vfleet(probe)                       # its build and capture
    first_chunk_s = run_vfleet(probe)["sim_wall_s"]
    estimate = first_chunk_s * 10_000 / 250
    headline_steps = 10_000 if estimate <= HEADLINE_AIM_S else 2000
    res = fg.run(False, device=str(dev), headline_steps=headline_steps)
    check(res["all_ok"], f"fleet_goodput twin claims: {[c for c in res['claims'] if not c['ok']]}")
    base = next(r for r in res["results"] if r["fleet"] == "baseline")
    diffs = {k: (base[k], v) for k, v in FLEET_BASELINE.items() if base[k] != v}
    check(not diffs, f"fleet_goodput baseline row vs experiments/bench/fleet_goodput.json: {diffs}")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "experiments", "bench", "fleet_goodput.json")) as f:
        ref_base = next(r for r in json.load(f)["results"] if r["fleet"] == "baseline")
    counts = [k for k in ref_base if k not in ("sim_wall_s",)]
    diffs = {k: (base[k], ref_base[k]) for k in counts if base[k] != ref_base[k]}
    check(not diffs, f"fleet_goodput baseline row vs the reference's: {diffs}")
    # the pinned parity configs: the card's vectorized engine, the CPU's servers
    srv = ServerConfig(n_slots=2, smax=32, mode="protected", scan_block=2, rows=4, cols=4, dppu_size=2)
    pins = {
        "pool": FleetConfig(n_replicas=3, n_spares=2, spare_policy="pool", n_regions=1, steps=48, seed=0,
                            chaos=ChaosSpec(per=0.3, at_step=10, seed=3),
                            traffic=TrafficSpec(request_rate=0.8, sla_steps=12, seed=5), server=srv),
        "region": FleetConfig(n_replicas=4, n_spares=2, spare_policy="region", n_regions=2, steps=40, seed=7,
                              chaos=ChaosSpec(per=0.5, at_step=6, seed=11),
                              traffic=TrafficSpec(request_rate=1.2, sla_steps=14, seed=9, n_classes=2, tail=0.6),
                              server=srv),
    }
    for name, pin in pins.items():
        on_card = run_vfleet(dc.replace(pin, server=dc.replace(srv, device=str(dev))))
        on_cpu = run_fleet(dc.replace(pin, server=dc.replace(srv, device="cpu")))
        diffs = {k: (on_card[k], on_cpu[k]) for k in FLEET_PARITY_KEYS if on_card[k] != on_cpu[k]}
        check(not diffs, f"vfleet {name} on the card vs run_fleet on the CPU: {diffs}")
    # ms a tick of a built geometry: chaos-pool reuses the baseline's build,
    # and the headline's first chunk was timed on its second run
    chaos_pool = next(r for r in res["results"] if r["fleet"] == "chaos-pool")
    tick_ms = {"64": 1e3 * chaos_pool["sim_wall_s"] / chaos_pool["steps"], "1000": 1e3 * first_chunk_s / 250}
    out = dict(rows={r["fleet"]: {k: r[k] for k in ("n_replicas", "steps", "goodput_tokens", "requests_completed",
                                                   "requests_expired", "retirements", "replacements",
                                                   "slo_attainment", "latency_e2e_p50", "latency_e2e_p99",
                                                   "sim_wall_s")} for r in res["results"]},
               headline_steps=headline_steps, headline_reduced=headline_steps != 10_000,
               headline_first_chunk_s=first_chunk_s, headline_estimate_s=estimate,
               baseline_equals_reference=True, parity_pins=sorted(pins), ms_per_tick=tick_ms,
               builds=len(vf._TRACES) - builds0, claims=[c["claim"] for c in res["claims"]], card=smi)
    phase("vfleet", **out)
    return out


def repair_recovery_phase(dev, smi) -> dict:
    """The repair_recovery twin in full mode on the card: 7 PERs, 48
    configs, 60 retrain steps, the seven claims."""
    from repro_torch.bench import repair_recovery as rr

    t0 = time.perf_counter()
    res = rr.run(False, device=str(dev))
    seconds = time.perf_counter() - t0
    check(res["all_ok"] and len(res["claims"]) == 7,
          f"repair_recovery twin claims: {[c for c in res['claims'] if not c['ok']]}")
    check(len(res["pers"]) == 7 and res["n_configs"] == 48 and res["retrain_steps"] == 60,
          f"repair_recovery at {len(res['pers'])} PERs, {res['n_configs']} configs, {res['retrain_steps']} steps")
    out = dict(pers=res["pers"], n_configs=res["n_configs"], retrain_steps=res["retrain_steps"],
               clean_acc=res["clean_acc"],
               mean={k: {str(p): v["mean"] for p, v in c.items()} for k, c in res["curves"].items()},
               seconds_per_point=res["seconds_per_point"], peak_bytes=res["peak_bytes"], seconds=seconds,
               claims=[c["claim"] for c in res["claims"]], card=smi)
    phase("repair_recovery", **out)
    return out


def obs_overhead_phase(dev, smi) -> dict:
    """The obs_overhead twin's vfleet row on the card: series off and on,
    the traced report bit-exact with the bare one."""
    from repro_torch.bench import obs_overhead as ob

    res = ob.run(True, device=str(dev), paths=("vfleet",))
    check(res["all_ok"], f"obs_overhead twin claims: {[c for c in res['claims'] if not c['ok']]}")
    out = dict(**res["results"][0], repeats=res["repeats"], claims=[c["claim"] for c in res["claims"]], card=smi)
    phase("obs_overhead", **out)
    return out


# --------------------------------------------------------------------------- #
# the serving CLI, the launch step builders and the serving benchmarks' twins
# --------------------------------------------------------------------------- #
CLI_BASE = ["--requests", "6", "--gen", "6", "--prompt-len", "4"]
# launch.serve.main's runs on the card, each again with --device cpu
CLI_RUNS = {
    **{f"{mode}/{d}": ["--mode", mode, *(["--faults", "3"] if mode != "off" else []), "--dispatch", d]
       for d in ("twopass", "fused") for mode in ("off", "protected", "unprotected")},
    "remap": ["--mode", "protected", "--faults", "8", "--repair", "remap", "--dispatch", "fused"],
    "chaos": ["--chaos-per", "0.2", "--chaos-at", "4", "--dispatch", "fused"],
    "faults64": ["--mode", "protected", "--faults", "64", "--dispatch", "fused"],
}
CLI_WALL = ("wall_s", "tokens_per_s", "host_phase_ms")  # the summary's wall-clock keys


def _untimed(summary: dict) -> dict:
    return {k: v for k, v in summary.items() if k not in CLI_WALL}


def _prom_lines(text: str) -> list[str]:
    """Prometheus text without the wall-clock gauges."""
    return [ln for ln in text.splitlines() if not any(w in ln for w in CLI_WALL)]


def cli_run(argv: list[str]) -> dict:
    """One ``launch.serve.main(argv)``: its summary, the server it built, its
    printed lines, its launches (the counts set to 0 just before it, read
    just after) and, with ``--metrics-port``, one ``/metrics`` scrape taken
    when the run has ended and before the endpoint stops.  The server and
    the endpoint are seen through wrappers around ``FaultTolerantServer.run``
    and ``MetricsServer.__init__``, removed afterwards."""
    import contextlib
    import io
    import urllib.request

    from repro_torch.launch import serve as ls
    from repro_torch.obs import httpd
    from repro_torch.serving.server import FaultTolerantServer

    seen: dict = {}
    real_run, real_init = FaultTolerantServer.run, httpd.MetricsServer.__init__

    def run(self, *a, **kw):
        out = real_run(self, *a, **kw)
        seen["server"] = self
        if "httpd" in seen:
            with urllib.request.urlopen(f"http://127.0.0.1:{seen['httpd'].port}/metrics", timeout=10) as r:
                seen["scrape"] = r.read().decode()
        return out

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        seen["httpd"] = self

    kernels = _kernels()
    FaultTolerantServer.run, httpd.MetricsServer.__init__ = run, init
    printed = io.StringIO()
    try:
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            summary = ls.main(argv)
        seconds = time.perf_counter() - t0
        counts = {name: k.launches for name, k in kernels.items()}
    finally:
        FaultTolerantServer.run, httpd.MetricsServer.__init__ = real_run, real_init
    return dict(summary=summary, server=seen["server"], lines=printed.getvalue().splitlines(), counts=counts,
                seconds=seconds, scrape=seen.get("scrape"), httpd=seen.get("httpd"))


def serve_cli_phase(dev, smi) -> dict[str, int]:
    """``launch.serve.main`` on smoke qwen on the card, each argv of
    ``CLI_RUNS`` and one with counters, the three files and the endpoint,
    each again with ``--device cpu``.  Every summary key but the two
    wall-clock ones (steps, tokens, requests, scan steps and sweeps,
    confirmed, surviving columns, effective slots, remapped, detections and
    their latencies, the counters) depends on no float order, so the card's
    equals the CPU's; protected (3 faults <= the DPPU's 4) serves off's
    tokens bit for bit in each dispatch; --faults 64 refuses admission; the
    fused runs launch ft_matmul the ledger's count a step, the protected
    runs probe_check_pair once a scan step; the scrape equals the .prom file
    but for the wall-clock gauges.  Returns the launches of the card's runs."""
    total = dict.fromkeys(_kernels(), 0)
    runs, out = {}, {}
    root = os.path.join(BUILD_DIR, "serve_cli")
    files = {"card": os.path.join(root, "card"), "cpu": os.path.join(root, "cpu")}
    argvs = dict(CLI_RUNS, obs=["--mode", "protected", "--faults", "3", "--dispatch", "fused", "--counters",
                                "--metrics-port", "0"])
    try:
        for name, argv in argvs.items():
            got = {}
            for where, device in (("card", str(dev)), ("cpu", "cpu")):
                extra = ["--device", device]
                if name == "obs":
                    d = files[where]
                    extra += ["--metrics-out", os.path.join(d, "ev.jsonl"), "--series-out", os.path.join(d, "series"),
                              "--spans-out", os.path.join(d, "spans.jsonl")]
                got[where] = cli_run(CLI_BASE + argv + extra)
            card, cpu = got["card"], got["cpu"]
            s = card["summary"]
            diffs = {k: (v, cpu["summary"].get(k)) for k, v in _untimed(s).items() if cpu["summary"].get(k) != v}
            check(not diffs and _untimed(s).keys() == _untimed(cpu["summary"]).keys(),
                  f"serve_cli {name}: the card's summary vs the CPU's: {diffs}")
            check(any(ln.startswith("[serve] arch=") for ln in card["lines"])
                  and any("effective_slots_final" in ln for ln in card["lines"]), f"serve_cli {name}: printed lines")
            srv, counts = card["server"], card["counts"]
            fused = srv.cfg.dispatch == "fused"
            calls = sum(c.count for c in srv.bundle.ledger if c.protected) if fused else 0
            check(counts["ft_matmul"] == calls * s["steps"] and counts["ft_matmul_batched"] == 0,
                  f"serve_cli {name}: ft_matmul launched {counts['ft_matmul']} times in {s['steps']} steps, "
                  f"want {calls} a step")
            check(counts["probe_check_pair"] == s["scan_steps"] and counts["probe_check"] == 0,
                  f"serve_cli {name}: probe_check_pair launched {counts['probe_check_pair']} times in "
                  f"{s['scan_steps']} scan steps")
            for k, n in counts.items():
                total[k] += n
            runs[name] = card
            out[name] = dict(steps=s["steps"], tokens=s["tokens"], scan_steps=s["scan_steps"],
                             confirmed=s["confirmed_faults_final"], surviving_cols=s["surviving_cols_final"],
                             effective_slots_final=s["effective_slots_final"], remapped=s["remapped_final"],
                             detections=s["detections"], detect_latency_p50_steps=s["detect_latency_p50_steps"],
                             launches=counts, seconds=card["seconds"], cpu_seconds=cpu["seconds"],
                             ms_per_step=1e3 * s["wall_s"] / max(s["steps"], 1))
        for d in ("twopass", "fused"):
            off, prot = runs[f"off/{d}"]["server"], runs[f"protected/{d}"]["server"]
            a, b = off.completions_by_rid(), prot.completions_by_rid()
            check(len(a) == 6 and a.keys() == b.keys() and all(np.array_equal(a[r], b[r]) for r in a),
                  f"serve_cli {d}: protected (3 faults <= capacity) tokens differ from off")
            check(prot.manager.n_confirmed == 3, f"serve_cli {d}: {prot.manager.n_confirmed} faults confirmed")
        check(runs["faults64"]["summary"]["effective_slots_final"] == 0,
              f"serve_cli faults64: effective_slots_final {runs['faults64']['summary']['effective_slots_final']}")
        check(runs["remap"]["summary"]["remapped_final"] > 0, "serve_cli remap: nothing remapped")
        obs = runs["obs"]
        with open(os.path.join(files["card"], "ev.jsonl.prom")) as f:
            prom = f.read()
        check(obs["scrape"] is not None and _prom_lines(obs["scrape"]) == _prom_lines(prom),
              "serve_cli obs: the /metrics scrape differs from the .prom file")
        check(obs["httpd"]._host == "127.0.0.1" and obs["httpd"]._httpd is None,
              "serve_cli obs: the endpoint is bound elsewhere than 127.0.0.1 or still up")
        check(obs["summary"]["counters"]["protected_calls"] == obs["counts"]["ft_matmul"],
              f"serve_cli obs: protected_calls {obs['summary']['counters']['protected_calls']} vs "
              f"{obs['counts']['ft_matmul']} ft_matmul launches")

        def events(where):
            with open(os.path.join(files[where], "ev.jsonl")) as f:
                return [{k: v for k, v in json.loads(ln).items() if k != "ts"} for ln in f]

        def text(where, name):
            with open(os.path.join(files[where], name)) as f:
                return f.read()

        check(events("card") == events("cpu"), "serve_cli obs: the card's events differ from the CPU's")
        check(text("card", "spans.jsonl") == text("cpu", "spans.jsonl"), "serve_cli obs: spans differ")
        check(os.path.getsize(os.path.join(files["card"], "series.npz")) > 0, "serve_cli obs: no series file")
        written = sorted(os.listdir(files["card"]))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(not os.path.exists(root), f"serve_cli: {root} not removed")
    phase("serve_cli", arch="qwen1.5-0.5b (smoke)", argv=CLI_BASE, runs=out, launches=total,
          equal_to_cpu="every summary key but wall_s, tokens_per_s and host_phase_ms",
          protected_equals_off=["twopass", "fused"],
          scrape_equals_prom=True, files=written, files_removed=True, card=smi)
    return total


LAUNCH_PREFILL = (4, 512)


def _decode_tokens(lm, dev, steps: int, n: int = 4) -> list[torch.Tensor]:
    g = torch.Generator(device=dev).manual_seed(11)
    return [torch.randint(0, lm.vocab, (n, 1), generator=g, device=dev, dtype=torch.int32) for _ in range(steps)]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.element_size() == 2 else t.view(torch.int32)


def _caches_equal(a, b) -> bool:
    from repro_torch.tree import tree_leaves

    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def launch_decode(bundle, smi: str, *, steps: int = 8) -> dict:
    """``make_decode`` at full width on ``bundle``'s model, 4 slots, fused:
    the step a CUDA graph (one capture), each replayed step launching the
    path's kernels exactly ``per_step`` times (the counts set to 0 just
    before the replays, read just after); its logits and cache bit for bit
    the bundle's captured step's over the same cache and tokens, in the off
    and unprotected states; protected (3 faults <= capacity) equal to off
    and unprotected different, through ``_prefill_ctx``'s three contexts.
    Returns the phase's numbers and the replays' launches."""
    from repro_torch.launch.serve import make_decode

    lm, dev, arch = bundle.lm, bundle.device, bundle.lm.name
    toks = _decode_tokens(lm, dev, steps)
    want = per_step(arch)
    kernels = _kernels()

    def run(fn, cache):
        logits, times = [], []
        for i, tok in enumerate(toks):
            if i == 1:
                for k in kernels.values():
                    k.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, out = fn(bundle.work, cache, {"token": tok})
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            check(out is cache, f"{arch} make_decode: the cache is not advanced in place")
            logits.append(lg)
        counts = {name: k.launches for name, k in kernels.items()}
        return logits, times, counts

    # the served step: the bundle's own context and captured step
    served = {}
    for name, state in (("off", bundle.empty_state), ("unprotected", _fault_state([(0, 0, 30, 1)], dev))):
        cache = bundle.fresh_cache()
        step = bundle.captured_step(cache)  # held: the bundle keeps a weak reference
        logits = []
        for tok in toks:
            lg, _ = bundle.step_fn(bundle.work, cache, tok, state, bundle.identity_plan)
            logits.append(lg.clone())
        check(step.captures == 1, f"{arch}: the bundle's step captured {step.captures} times")
        served[name] = (logits, cache, state)
        del step
    fn, specs = make_decode(lm, str(dev), ftc=bundle.ftc)
    check(specs is None, "make_decode: specs")
    for name, (logits, cache, state) in served.items():
        bundle.ftc.swap(state=state, plan=bundle.identity_plan)
        mine = bundle.fresh_cache()
        got, _, _ = run(fn, mine)
        check(all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, logits)) and _caches_equal(mine, cache),
              f"{arch} make_decode {name}: logits or cache differ from the bundle's captured step")
    del fn, served
    # the three modes through make_decode
    out, launches = {}, {}
    ctxs = {}
    for mode, faults in (("off", []), ("protected", BIST_FAULTS), ("unprotected", [(0, 0, 30, 1)])):
        ctxs[mode] = _prefill_ctx("unprotected" if mode == "unprotected" else "protected", faults, "fused", dev)
        fn, _ = make_decode(lm, str(dev), ftc=ctxs[mode])
        logits, times, counts = run(fn, bundle.fresh_cache())
        replays = steps - 1
        check(fn.captured.captures == 1 and fn.captured.replays == replays,
              f"{arch} make_decode {mode}: {fn.captured.captures} captures, {fn.captured.replays} replays")
        for name, n in want.items():
            check(counts[name] == n * replays, f"{arch} make_decode {mode}: {name} launched {counts[name]} times in "
                                               f"{replays} replayed steps, want {n} a step")
        check(counts["probe_check_pair"] == counts["probe_check"] == 0, f"{arch} make_decode {mode}: probes {counts}")
        out[mode] = (logits, 1e3 * float(np.median(times[2:])))
        launches[mode] = counts
        del fn
    # a second builder on the same params and context: allocated bytes with
    # each alive and after each is freed; the first one's graph pool, cache
    # and buffers must not outlive it
    allocated = {}
    for i in (1, 2):
        gc.collect()
        torch.cuda.empty_cache()
        allocated[f"before_{i}"] = torch.cuda.memory_allocated(dev)
        fn, _ = make_decode(lm, str(dev), ftc=ctxs["protected"])
        cache = bundle.fresh_cache()
        for tok in toks[:3]:
            fn(bundle.work, cache, {"token": tok})
        torch.cuda.synchronize()
        allocated[f"with_{i}"] = torch.cuda.memory_allocated(dev)
        allocated[f"pool_{i}"] = fn.captured.pool_bytes
        del fn, cache
        gc.collect()
        torch.cuda.empty_cache()
        allocated[f"after_{i}"] = torch.cuda.memory_allocated(dev)
    check(allocated["after_2"] <= allocated["after_1"] and allocated["after_2"] <= allocated["before_2"],
          f"{arch} make_decode: a freed builder left allocated bytes behind: {allocated}")
    off, prot, unprot = (out[m][0] for m in ("off", "protected", "unprotected"))
    check(all(torch.equal(_bits(a), _bits(b)) for a, b in zip(off, prot)), f"{arch} make_decode: protected differs from off")
    check(not torch.equal(_bits(off[0]), _bits(unprot[0])), f"{arch} make_decode: unprotected equals off")
    check(tuple(off[0].shape) == (4, 1, lm.padded_vocab) and bool(torch.isfinite(off[0][..., :lm.vocab].float()).all()),
          f"{arch} make_decode: logits {tuple(off[0].shape)}")
    return dict(decode_ms_median={m: v[1] for m, v in out.items()}, launches_per_replayed_step=want,
                replayed_steps=steps - 1, launches=launches, allocated_bytes=allocated,
                equal_to_served_step=["off", "unprotected"], protected_equals_off=True, unprotected_differs=True)


def launch_steps_phase(dev, smi: str, bundle, prefilled: dict | None) -> dict[str, int]:
    """The launch step builders at full width on the served model's bundle:
    ``launch_decode`` and, with ``prefilled`` (the prefill_fused phase's
    batch and logits), ``make_prefill`` at ``LAUNCH_PREFILL`` in the three
    modes, bit for bit the prefill_fused phase's logits, protected equal to
    off and unprotected different, and the decode step's device busy share
    from a profiled window of replays.  Returns the replayed steps'
    launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import make_decode, make_prefill

    lm, arch = bundle.lm, bundle.lm.name
    t0 = time.perf_counter()
    dec = launch_decode(bundle, smi)
    got = dict(arch=arch, slots=4, decode=dec)
    if prefilled is not None:
        batch = prefilled["batch"]
        check(tuple(batch["tokens"].shape) == LAUNCH_PREFILL, f"{arch} make_prefill: batch {tuple(batch['tokens'].shape)}")
        logits, ms = {}, {}
        for mode, ctx in prefilled["ctxs"].items():
            fn, specs = make_prefill(lm, str(dev), ftc=ctx)
            check(specs is None, "make_prefill: specs")
            fn(bundle.work, batch)  # warm-up
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits[mode] = fn(bundle.work, batch)
            torch.cuda.synchronize()
            ms[mode] = 1e3 * (time.perf_counter() - t1)
            check(torch.equal(_bits(logits[mode]), _bits(prefilled["logits"][mode])),
                  f"{arch} make_prefill {mode}: logits differ from the prefill_fused phase's")
        check(torch.equal(_bits(logits["off"]), _bits(logits["protected"])), f"{arch} make_prefill: protected differs from off")
        check(not torch.equal(_bits(logits["off"]), _bits(logits["unprotected"])), f"{arch} make_prefill: unprotected equals off")
        got["prefill"] = dict(batch=LAUNCH_PREFILL[0], seq=LAUNCH_PREFILL[1], ms=ms, equal_to_prefill_fused=True,
                              protected_equals_off=True, unprotected_differs=True)
        # the decode step's device busy share: a profiled window of replays
        ctx = prefilled["ctxs"]["protected"]
        fn, _ = make_decode(lm, str(dev), ftc=ctx)
        cache = bundle.fresh_cache()
        toks = _decode_tokens(lm, bundle.device, 6)
        for tok in toks[:2]:
            fn(bundle.work, cache, {"token": tok})
        launches0 = {name: k.launches for name, k in _kernels().items()}

        def window():
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                for tok in toks[2:]:
                    fn(bundle.work, cache, {"token": tok})
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t1) / len(toks[2:])
            return prof.key_averages(), wall
        ka, wall, seen = agreed_window(window)
        for name, k in _kernels().items():  # not main-path launches
            k.launches = launches0[name]
        busy = sum(_self_device_us(e) for e in _device_events(ka)) / 1e3 / len(toks[2:])
        # the busy share over the unprofiled median: under the profiler a
        # replay's wall time grows with the tracing of each of its kernels
        got["decode"].update(profiled_step_ms=1e3 * wall, device_busy_ms=busy,
                             device_busy_share=busy / dec["decode_ms_median"]["protected"], window_device_events=seen)
        del fn, cache
    got.update(phase_s=time.perf_counter() - t0, card=smi)
    phase("launch_steps", **got)
    total = dict.fromkeys(_kernels(), 0)
    for counts in dec["launches"].values():
        for k, n in counts.items():
            total[k] += n
    return total


def serving_twins_phase(dev, smi) -> dict[str, int]:
    """The serving benchmarks' twins on the card, each written to
    experiments/bench_torch/: serving_goodput quick (all claims; the
    protected curve, capacity, surviving columns and effective slots equal
    to experiments/bench/serving_goodput.json, the unprotected curve printed
    beside the file's), scan_latency quick (every correctness claim; the
    speed claim's outcome printed with the boot and step ms),
    detector_coverage quick (the matrix equal to the file's), ft_overhead
    quick (its correctness claims) and then in full mode on
    ``FT_FULL_FAMILIES`` (its correctness claims asserted, its two timing
    claims printed).  Returns the twins' launches (the counts set to 0 just
    before each, read just after)."""
    from repro_torch.bench import detector_coverage, ft_overhead, scan_latency, serving_goodput
    from repro_torch.bench.common import save_result

    kernels = _kernels()
    total = dict.fromkeys(kernels, 0)
    here = os.path.dirname(os.path.abspath(__file__))

    def committed(name):
        with open(os.path.join(here, "experiments", "bench", f"{name}.json")) as f:
            return json.load(f)

    def twin(name, fn, **kw):
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        res = fn(device=str(dev), **kw)
        res["elapsed_s"] = time.perf_counter() - t0
        counts = {n: k.launches for n, k in kernels.items()}
        for n, c in counts.items():
            total[n] += c
        save_result(name, res)
        return res, counts

    out = {}
    res, counts = twin("serving_goodput", lambda device: serving_goodput.run(True, device=device))
    ref = committed("serving_goodput")
    check(res["all_ok"], f"serving_goodput claims: {[c for c in res['claims'] if not c['ok']]}")
    exact = {k: (res["curve"][k], ref["curve"][k]) for k in ("per", "n_faults", "protected", "surviving_cols",
                                                              "effective_slots")}
    exact.update(capacity=(res["capacity"], ref["capacity"]),
                 reference_goodput=(res["reference_goodput"], ref["reference_goodput"]))
    check(all(a == b for a, b in exact.values()), f"serving_goodput vs the committed file: {exact}")
    out["serving_goodput"] = dict(protected=res["curve"]["protected"], surviving_cols=res["curve"]["surviving_cols"],
                                  effective_slots=res["curve"]["effective_slots"], equal_to_file=sorted(exact),
                                  unprotected=res["curve"]["unprotected"], unprotected_file=ref["curve"]["unprotected"],
                                  unprotected_reference_cpu=[48, 48, 42, 36, 30, 12], launches=counts,
                                  seconds=res["elapsed_s"])

    res, counts = twin("scan_latency", lambda device: scan_latency.run(True, device=device))
    speed = res["claims"][-1]
    check("not collapsed" in speed["claim"] and all(c["ok"] for c in res["claims"][:-1]),
          f"scan_latency correctness claims: {[c for c in res['claims'][:-1] if not c['ok']]}")
    out["scan_latency"] = dict(speed_claim=speed["claim"], speed_claim_ok=speed["ok"], speed_detail=speed["detail"],
                               rows=[{k: r[k] for k in ("rows", "cols", "scan_block", "boot_batched_ms",
                                                        "boot_legacy_ms", "boot_speedup_x", "step_ms")}
                                     for r in res["results"]],
                               correctness_claims=len(res["claims"]) - 1, launches=counts, seconds=res["elapsed_s"])

    res, counts = twin("detector_coverage", lambda device: detector_coverage.run(True, device=device))
    ref = committed("detector_coverage")
    check(res["all_ok"] and res["matrix"] == ref["matrix"] and res["retraces"] == ref["retraces"],
          f"detector_coverage vs the committed file: {res['matrix']} {res['retraces']}")
    out["detector_coverage"] = dict(matrix_equals_file=True, retraces=res["retraces"], launches=counts,
                                    seconds=res["elapsed_s"])

    res, counts = twin("ft_overhead_quick", lambda device: ft_overhead.run(True, device=device))
    check(res["all_ok"], f"ft_overhead quick claims: {[c for c in res['claims'] if not c['ok']]}")
    quick = dict(claims=len(res["claims"]), launches=counts, seconds=res["elapsed_s"])
    res, counts = twin("ft_overhead", lambda device: ft_overhead.run(False, device=device,
                                                                          families=FT_FULL_FAMILIES))
    timing = ("no slower than twopass", "ROADMAP target")
    correct = [c for c in res["claims"] if not any(t in c["claim"] for t in timing)]
    check(all(c["ok"] for c in correct), f"ft_overhead full correctness claims: {[c for c in correct if not c['ok']]}")
    out["ft_overhead"] = dict(
        quick=quick, full_families=list(FT_FULL_FAMILIES), steps=res["steps"], repeats=res["repeats"],
        n_slots=res["n_slots"],
        results={r["arch"]: {k: v for k, v in r.items() if k != "arch"} for r in res["results"]},
        sites={f"{r['arch']}/{r['site']}": {k: r[k] for k in ("twopass_overhead_x", "fused_overhead_x",
                                                              "fused_speedup_x")} for r in res["site_results"]},
        timing_claims=[[c["claim"], c["ok"], c["detail"]] for c in res["claims"] if c not in correct],
        launches=counts, seconds=res["elapsed_s"])
    phase("serving_twins", **out, card=smi)
    return total


# --------------------------------------------------------------------------- #
# the analysis tier and the plan autotuner
# --------------------------------------------------------------------------- #
ANALYSIS_WORKERS = 6  # the meta dry runs, on the host's cores after the card's timing is done
# the full-width dry run: qwen1.5-0.5b at every applicable cell, every other
# family at decode_32k (beside the H100, granite-moe-3b-a800m's train_4k traced
# in 93 s on a mesh, its prefill_32k in 20: they are left to the CLI with the others')
DRYRUN_ALL_CELLS = (QWEN,)
SERVED_DECODE = ("served_decode", "decode", 96, 4)  # the served step: 4 slots over a 96-row cache
PROBE_TOL = 1e-9  # the reconstruction against the direct count, relative


def _dryrun_worker_init() -> None:
    os.environ["CUDA_VISIBLE_DEVICES"] = ""  # a meta trace touches no card


def _dryrun_cell(task):
    from repro_torch.launch import dryrun

    arch, shape, mesh = task
    try:
        return dryrun.run_cell(arch, shape, mesh, verbose=False)
    except Exception as e:  # recorded as the CLI records it, and failed by the phase
        return {"arch": arch, "shape": shape, "mesh": mesh, "status": "FAILED", "error": f"{type(e).__name__}: {e}"}


def sharded_checks(records: list[dict], host: list[dict]) -> dict:
    """qwen1.5-0.5b's decode_32k on 16 x 16 at full depth: every sharded dim
    divides, so one device's dot FLOPs x 256 equal the host trace's; its
    collectives are Megatron's, 2 L + 1 all-reduces over model (wo, down,
    the vocab-parallel embedding) of the (8, 1, 1024) bf16 activation, and
    2 L all-gathers of the stacked norm scales the specs shard over model,
    nothing else."""
    from repro_torch.configs import get_config

    cfg = get_config(QWEN)
    rec = next(r for r in records if (r["arch"], r["shape"], r["mesh"]) == (QWEN, "decode_32k", "single"))
    hrec = next(r for r in host if (r["arch"], r["shape"]) == (QWEN, "decode_32k"))
    check(rec["dot_flops"] * rec["n_devices"] == hrec["dot_flops"],
          f"qwen decode_32k: dot FLOPs {rec['dot_flops']} x {rec['n_devices']} != the host's {hrec['dot_flops']}")
    n, act = cfg.n_layers, 128 // 16 * cfg.d_model * 2
    c = rec["collectives"]
    want = {"all-reduce": (2 * n + 1, (2 * n + 1) * act), "all-gather": (2 * n, 2 * n * cfg.d_model * 2)}
    for kind in c["counts"]:
        got = (c["counts"][kind], c["result_bytes"][kind])
        check(got == want.get(kind, (0, 0)), f"qwen decode_32k {kind}: {got}, Megatron's {want.get(kind, (0, 0))}")
    return dict(dot_flops_per_device=rec["dot_flops"], host_dot_flops=hrec["dot_flops"], n_devices=rec["n_devices"],
                all_reduce=want["all-reduce"], all_gather=want["all-gather"])


def tuned_shapes() -> list[tuple[str, int, int, int, str]]:
    """(name, M, K, N, layout) of qwen1.5-0.5b's distinct ft_matmul shapes,
    decode then prefill; the head reads the tied table's transposed view."""
    out, seen = [], set()
    for table in (DECODE_SHAPES[QWEN], PREFILL_SHAPES[QWEN]):
        for name, m, k, n, _ in table:
            if (m, k, n) not in seen:
                seen.add((m, k, n))
                out.append((name, m, k, n, "k_fast" if name.startswith("head") else "n_fast"))
    return out


def autotune_checks(dev, shapes, cache: dict) -> float:
    """Every candidate plan of every tuned shape against ``ft_matmul_ref``
    as phase 3 holds the default plan (bitwise on integer-valued and f32
    ±(1 + 2^-8) operands, the bf16 store bitwise its own f32 output cast,
    random operands within RAND_TOL), bf16 and f32.  Returns the max |Δ|."""
    from repro_torch.kernels.autotune import key
    from repro_torch.kernels.ft_matmul import ft_matmul, ft_matmul_ref, plan_candidates

    g = torch.Generator(device=dev).manual_seed(25)
    and_g, or_g = fault_grids(dev)
    max_err = 0.0
    for name, m, k, n, layout in shapes:
        check(key(m, n, k, torch.bfloat16, layout) in cache, f"{name}: no cache entry")
        for dtype in (torch.bfloat16, torch.float32):
            for plan in plan_candidates(layout, dtype):  # the tile plan for bf16 only
                def kernel(x, w, a, o, out_dtype=torch.float32, plan=plan):
                    return ft_matmul(x, w, a, o, out_dtype=out_dtype, plan=plan)

                def operands(kind: str):
                    x = _draw(g, dev, dtype, kind, (m, k), 1.0, kind == "frac_x")
                    fw = kind == "frac_w"
                    if layout == "k_fast":
                        return x, _draw(g, dev, dtype, kind, (n, k), 0.02, fw).T
                    return x, _draw(g, dev, dtype, kind, (k, n), 0.02, fw)

                e, _ = _kernel_checks(f"ft_matmul {name} {plan}", kernel, ft_matmul_ref, operands, and_g, or_g,
                                      dtype)
                max_err = max(max_err, e)
    return max_err


def auto_context_checks(dev, shapes, cache: dict) -> dict:
    """An ``fused_block="auto"`` context on the tuned cache launches each
    shape's tuned plan, a default context ``ft_plan``; each output bitwise a
    direct ``ft_matmul`` call with that plan (the default one: the bits the
    served path has always had)."""
    from repro_torch.core import ftcontext as ftc_mod
    from repro_torch.core.engine import HyCAConfig
    from repro_torch.kernels.autotune import key
    from repro_torch.kernels.ft_matmul import FTPlan, ft_matmul, plan_of

    state = _fault_state(BIST_FAULTS, dev)
    hyca = HyCAConfig(rows=ROWS, cols=COLS, mode="protected")
    ctxs = {fb: ftc_mod.build_ftcontext(state, hyca, dispatch="fused", fused_block=fb) for fb in (None, "auto")}
    seen = []

    def spy(x, w, a, o, out_dtype=torch.float32, plan=None):
        seen.append(plan_of(x, w) if plan is None else plan)
        return ft_matmul(x, w, a, o, out_dtype=out_dtype, plan=plan)

    g = torch.Generator(device=dev).manual_seed(26)
    out = {}
    ftc_mod.ft_matmul = spy
    try:
        for name, m, k, n, layout in shapes:
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            w = (torch.randn((n, k) if layout == "k_fast" else (k, n), generator=g, device=dev) * 0.02).to(
                torch.bfloat16)
            w = w.T if layout == "k_fast" else w
            tuned = FTPlan(**cache[key(m, n, k, torch.bfloat16, layout)]["plan"])
            got = {}
            for fb, ctx in ctxs.items():
                seen.clear()
                got[fb] = ctx.matmul(x, w, site="ffn")
                check(len(seen) == 1, f"{name}: {len(seen)} ft_matmul calls")
                want_plan = tuned if fb == "auto" else plan_of(x, w)
                check(seen[0] == want_plan, f"{name} fused_block={fb}: launched {seen[0]}, not {want_plan}")
                and_g, or_g = ctx.mask_grids(None)
                direct = ft_matmul(x, w, and_g, or_g, out_dtype=torch.bfloat16,
                                   plan=None if fb is None else tuned)
                check(torch.equal(got[fb].view(torch.int16), direct.view(torch.int16)),
                      f"{name} fused_block={fb}: not bitwise the direct call")
            out[name] = dict(tuned=_plan_str(tuned), ft_plan=_plan_str(plan_of(x, w)),
                             auto_equals_default=bool(torch.equal(got["auto"].view(torch.int16),
                                                                  got[None].view(torch.int16))))
    finally:
        ftc_mod.ft_matmul = ft_matmul
    return out


def analysis_phase(dev, smi: str, served_qwen: dict) -> dict[str, int]:
    """The analysis tier (``launch/{dryrun,probes,roofline}.py``, on
    ``meta`` tensors on the host) and the plan autotuner
    (``kernels/autotune.py``, on the card).  autotune — the measured search
    at qwen1.5-0.5b's four decode shapes and three prefill shapes, its cache
    in a temporary directory (never a cache a later run reads), each
    candidate plan's time beside ft_plan's pick; every candidate plan
    checked against ft_matmul_ref; an "auto" context launching the tuned
    plan and a default one ft_plan, each bitwise its direct call.
    dryrun — qwen1.5-0.5b at every applicable cell and each other family
    at decode_32k, traced in ANALYSIS_WORKERS
    processes on the host mesh and, sharded on DTensors of a fake process
    group, on 16 x 16 and 2 x 16 x 16 (dryrun_sharded, :func:`sharded_checks`):
    status ok, each cell's trace seconds, per-device costs and collectives;
    specs — all ten configs' every cell on both meshes, every spec dividing
    its dimension, each cell's argument bytes per device, which every traced
    record's arguments equal.  probes — qwen at
    train_4k and decode_32k, the reconstruction equal to the dry run's
    direct count within PROBE_TOL.  roofline — the dry-run records' table,
    and the served qwen decode step's bound beside its measured captured
    step.  Returns the autotuner's launches."""
    import multiprocessing as mp
    import tempfile

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.configs.shapes import SHAPES, ShapeCell, applicable_cells
    from repro_torch.kernels import autotune
    from repro_torch.kernels.ft_matmul import ft_matmul, ft_plan, plan_label
    from repro_torch.launch import dryrun, probes, roofline
    from repro_torch.launch.mesh import make_production_mesh

    shapes = tuned_shapes()
    tune_dir = tempfile.mkdtemp(prefix="chip_smoke_autotune-")
    prior = os.environ.get("REPRO_AUTOTUNE_DIR")
    os.environ["REPRO_AUTOTUNE_DIR"] = tune_dir
    autotune.reset_cache()
    try:
        ft_matmul.launches = 0
        t0 = time.perf_counter()
        table = {}
        for name, m, k, n, layout in shapes:
            plan, ms, times = autotune.autotune_plan(m, n, k, dtype=torch.bfloat16, layout=layout, device=str(dev))
            rule = ft_plan(1, m, n, k, torch.bfloat16, layout)
            table[name] = dict(m=m, k=k, n=n, layout=layout, ms_by_plan=times, tuned=_plan_str(plan), tuned_ms=ms,
                               ft_plan=_plan_str(rule), ft_plan_ms=times[plan_label(rule)],
                               ft_plan_is_fastest=plan == rule)
        launches = {"ft_matmul": ft_matmul.launches}
        tune_s = time.perf_counter() - t0
        cache = autotune.load_cache(reload=True)
        check(os.path.dirname(autotune.cache_path()) == tune_dir, "the autotune cache left its temporary directory")
        phase("autotune", shapes=table, dtype="bf16", seconds=tune_s, launches=launches["ft_matmul"],
              timer="20 calls captured as one CUDA graph, CUDA events around a replay, min of 5; weights cycled past the L2",
              card=smi)

        cells = [(a, c.name) for a in ARCH_IDS for c in applicable_cells(get_config(a))
                 if a in DRYRUN_ALL_CELLS or c.name == "decode_32k"]
        tasks = [(a, s, mk) for a, s in cells for mk in ("host", "single", "multi")]
        # the longest traces first (qwen's sharded train_4k), one a worker at a time
        tasks.sort(key=lambda t: (t[1] != "train_4k", t[1] != "prefill_32k", t[2] == "host"))
        t0 = time.perf_counter()
        with mp.get_context("spawn").Pool(ANALYSIS_WORKERS, initializer=_dryrun_worker_init) as pool:
            pending = pool.map_async(_dryrun_cell, tasks, chunksize=1)
            # beside the dry runs: the candidate plans' checks, the contexts, the specs and the probes
            max_err = autotune_checks(dev, shapes, cache)
            contexts = auto_context_checks(dev, shapes, cache)
            phase("autotune_checks", plans=sum(len(autotune.plan_candidates(s[4], d)) for s in shapes
                                               for d in (torch.bfloat16, torch.float32)),
                  dtypes=["bf16", "f32"], bitwise=["integer", "f32 frac_x", "f32 frac_w", "bf16 store = f32 cast"],
                  random_tol=f"{RAND_TOL}*(|x|@|w|)", max_abs_err=max_err, contexts=contexts)
            specs = {}
            for a in ARCH_IDS:
                for mk in ("single", "multi"):
                    mesh = make_production_mesh(multi_pod=mk == "multi")
                    for cell in applicable_cells(get_config(a)):  # raises if a spec does not divide its dim
                        rec = dryrun.spec_record({}, get_config(a), cell, mesh)
                        specs.setdefault(a, {}).setdefault(mk, {})[cell.name] = rec["argument_bytes_per_device"]
            probed = {s: probes.probe_cell(get_config(QWEN), SHAPES[s]) for s in ("train_4k", "decode_32k")}
            served = probes.probe_cell(get_config(QWEN), ShapeCell(*SERVED_DECODE), serve_bf16=True, hyca=True,
                                       direct=True)
            all_records = pending.get()
        dry_s = time.perf_counter() - t0
    finally:
        autotune.reset_cache()
        if prior is None:
            os.environ.pop("REPRO_AUTOTUNE_DIR", None)
        else:
            os.environ["REPRO_AUTOTUNE_DIR"] = prior
        shutil.rmtree(tune_dir, ignore_errors=True)
    bad = [(r["arch"], r["shape"], r["mesh"], r.get("error")) for r in all_records if r["status"] != "ok"]
    check(not bad, f"dry run: {bad}")
    records = [r for r in all_records if r["mesh"] == "host"]
    sharded = [r for r in all_records if r["mesh"] != "host"]
    for r in sharded:  # a traced record's arguments are what its specs give a device
        want = specs[r["arch"]][r["mesh"]][r["shape"]]
        check(r["argument_bytes_per_device"] == want and r["memory_analysis"]["argument_size_in_bytes"] == sum(
            want.values()), f"{r['arch']} {r['shape']} {r['mesh']}: argument bytes {r['memory_analysis']} vs {want}")
    phase("specs", meshes={"single": [16, 16], "multi": [2, 16, 16]}, profile="tp", opt="zero1",
          traced=len(sharded), argument_bytes_per_device=specs)
    megatron = sharded_checks(sharded, records)
    sharded_rows = {f"{r['arch']}/{r['shape']}/{r['mesh']}": roofline.analyse_record(r) for r in sharded}
    phase("dryrun_sharded", cells=len(sharded), workers=ANALYSIS_WORKERS, seconds_with_host_cells=dry_s,
          trace_s={k: r["trace_s"] for k, r in zip(sharded_rows, sharded)},
          flops={k: r["cost_analysis"]["flops"] for k, r in zip(sharded_rows, sharded)},
          bytes_accessed={k: r["cost_analysis"]["bytes accessed"] for k, r in zip(sharded_rows, sharded)},
          collectives={k: {c: n for c, n in r["collectives"]["counts"].items() if n} for k, r in
                       zip(sharded_rows, sharded)},
          wire_bytes={k: r["collectives"]["total_wire_bytes"] for k, r in zip(sharded_rows, sharded)},
          collective_ms={k: row["collective_s"] * 1e3 for k, row in sharded_rows.items()},
          memory_analysis={k: r["memory_analysis"] for k, r in zip(sharded_rows, sharded)},
          qwen_decode_single=megatron, card=smi)
    left = [f"{a}/{c.name}" for a in ARCH_IDS for c in applicable_cells(get_config(a))
            if (a, c.name) not in cells]
    print(f"dryrun_sharded: left to `python -m repro_torch.launch.dryrun --mesh both`, on both meshes: "
          f"{', '.join(left)} (reason: trace seconds; a config's train_4k and prefill_32k trace in 5-3195 s "
          "on the host, PERF.md section 5, and sharded ~1.5-2x that)", flush=True)
    phase("dryrun", mesh="host", cells=len(records), workers=ANALYSIS_WORKERS, seconds=dry_s,
          trace_s={f"{r['arch']}/{r['shape']}": r["trace_s"] for r in records},
          flops={f"{r['arch']}/{r['shape']}": r["cost_analysis"]["flops"] for r in records},
          bytes_accessed={f"{r['arch']}/{r['shape']}": r["cost_analysis"]["bytes accessed"] for r in records},
          memory_analysis={f"{r['arch']}/{r['shape']}": r["memory_analysis"] for r in records})
    direct = {r["shape"]: r for r in records if r["arch"] == QWEN}
    rel = {}
    for s, rec in probed.items():
        want = direct[s]["cost_analysis"]
        rel[s] = {k: abs(rec["total"][k] - want[w]) / want[w] for k, w in (("flops", "flops"),
                                                                         ("bytes", "bytes accessed"))}
        check(max(rel[s].values()) <= PROBE_TOL, f"probe {s}: reconstruction vs the direct count {rel[s]}")
    phase("probes", arch=QWEN, rel_err_vs_direct=rel, tol=PROBE_TOL,
          totals={s: r["total"] for s, r in probed.items()}, per_layer={s: r["per_layer"] for s, r in probed.items()})
    rows = [roofline.analyse_record({"arch": r["arch"], "shape": r["shape"], "status": "ok", "n_devices": 1,
                                     "total": {"flops": r["cost_analysis"]["flops"],
                                               "bytes": r["cost_analysis"]["bytes accessed"],
                                               "wire_bytes": r["collectives"]["total_wire_bytes"]}})
            for r in records]
    print(roofline.to_markdown(rows), flush=True)
    print(roofline.to_markdown([{**row, "arch": f"{row['arch']} ({r['mesh']})"} for r, row in
                                zip(sharded, sharded_rows.values())]), flush=True)
    srow = roofline.analyse_record({**served, "arch": QWEN, "shape": SERVED_DECODE[0], "status": "ok"},
                                   cell=ShapeCell(*SERVED_DECODE))
    step_ms = float(np.median(served_qwen["captured"]["step_ms_median"]))
    check(served["protected_calls"] == per_step(QWEN)["ft_matmul"],
          f"the served step's trace records {served['protected_calls']} protected calls, the path launches "
          f"{per_step(QWEN)['ft_matmul']}")
    phase("roofline", rows=[{k: r[k] for k in ("arch", "shape", "compute_s", "memory_s", "collective_s", "dominant",
                                               "model_over_hlo", "roofline_fraction")} for r in rows],
          served_decode=dict(cell=list(SERVED_DECODE), flops=served["direct"]["flops"],
                             bytes=served["direct"]["bytes"], compute_ms=srow["compute_s"] * 1e3,
                             memory_ms=srow["memory_s"] * 1e3, bound_ms=srow["bound_s"] * 1e3,
                             dominant=srow["dominant"], protected_calls=served["protected_calls"],
                             captured_step_ms=step_ms, graph_replay_ms=served_qwen["captured"]["graph_replay_ms"],
                             roofline_share=srow["bound_s"] * 1e3 / step_ms),
          constants=dict(PEAK_FLOPS_BF16=roofline.PEAK_FLOPS_BF16, HBM_BW=roofline.HBM_BW,
                         NVLINK_BW=roofline.NVLINK_BW), card=smi)
    return launches


def main() -> None:
    smi = device_phase()
    dev = torch.device("cuda")
    build_phase()
    err = {"ft_matmul": max(ft_matmul_phase(dev), mixed_dtype_checks(dev)),
           "ft_matmul_batched": ft_matmul_batched_phase(dev)}
    for name, e in prefill_kernel_checks(dev).items():
        err[name] = max(err[name], e)
    probe_check_phase(dev)
    timed = {"probe_check": time_probe_check(dev, smi)}
    launches = dict.fromkeys(_kernels(), 0)
    per_path, per_prefill, steady = {}, {}, {}
    for arch in (QWEN, GRANITE):
        bundle, runs = server_phase(dev, smi, arch)
        for name, n in runs["protected"]["counts"].items():
            launches[name] += n
        per_path[arch] = timing_phase(dev, smi, arch, runs)
        busy = {step: profile_phase(bundle, smi, capture=capture)["device_busy_ms"]
                for step, capture in (("eager", False), ("captured", True))}
        steady[arch] = steady_phase(bundle, smi, busy)
        if arch == QWEN:  # the kernel tier, the transients and the training slice on the served model's weights
            two_pass = two_pass_phase(dev, smi, bundle)
            transients_phase(dev, smi, bundle)
            serve_retrain_phase(dev, smi, bundle, runs["protected"])
            train = train_phase(dev, smi, bundle)
            checkpoint_phase(dev, smi, train)
            del train
        per_prefill[arch], prefilled = prefill_phase(dev, smi, bundle)
        # the launch step builders on the served model's bundle, before it is freed
        for name, n in launch_steps_phase(dev, smi, bundle, prefilled if arch == QWEN else None).items():
            launches[name] += n
        del bundle, runs, prefilled
        free_host_memory()
        torch.cuda.empty_cache()  # the next model's bundle gets the card's memory
    for arch in FAMILIES:  # the attention, recurrent and fine-grained MoE families, one bundle at a time
        if arch == DEEPSEEK:  # its full widths in context, card against CPU, before its masters fill the host
            full_width_reference_phase(dev, smi, arch)
        bundle, runs = family_server_phase(dev, smi, arch)
        for name, n in runs["protected"]["counts"].items():
            launches[name] += n
        per_path[arch] = timing_phase(dev, smi, arch, runs)
        if arch in PREFILL:  # the families whose forward runs other matmuls than their decode
            per_prefill[arch], _ = prefill_phase(dev, smi, bundle)
        del bundle, runs
        free_host_memory()
        torch.cuda.empty_cache()
    paper_phases(dev, smi)
    for name, n in fleet_phase(dev, smi).items():  # the fleet's replicas: every replayed step's launches
        launches[name] += n
    vfleet_phase(dev, smi)
    obs_overhead_phase(dev, smi)
    for name, n in serve_cli_phase(dev, smi).items():  # the serving CLI at smoke size, card and CPU
        launches[name] += n
    for name, n in serving_twins_phase(dev, smi).items():
        launches[name] += n
    for name, n in analysis_phase(dev, smi, steady[QWEN]).items():  # the autotuner's timed ft_matmul launches
        launches[name] += n

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
