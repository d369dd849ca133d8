"""Time the port's ft_matmul kernels at the serving path's decode shapes, over
every cluster split, beside three ablations and the library call; the tile
kernel against the strip kernel at the benchmark's prefill shapes and over M,
the sweep that fixes ``M_TILE``; on one card.

    python3 tools/ft_matmul_sweep.py [--parts decode,prefill,m_sweep] [--out FILE]

For each main-path shape of chip_smoke.py (DECODE_SHAPES and EXPERT_SHAPES,
bf16 operands, bf16 store) and each split S in 1, 2, 4, 8 (1 only for the
K-fast heads) it prints the device time of one call, from torch.profiler
with the weights cycled past the L2 cache, of:

  * ``kernel``: csrc/ft_matmul.cu as the port builds it;
  * ``no_loads``: the same source with every weight copy of the strip
    kernels zero-filled, so nothing of w is read: the time of everything
    but the weight bytes;
  * ``no_reduction``: the same source with the cross-rank sum left out, so
    every rank stores its own partial (a wrong result, timed only): what the
    cluster barrier and the distributed-shared-memory sum cost;
  * ``cuda_cores``: the same source with bf16 x bf16 sent to the CUDA-core
    strip kernel (4 f32 FMAs and a widening per weight) instead of the
    tensor cores;

and ``library``: torch.matmul (torch.bmm for the experts) of the same bf16
product, timed before and after.  The plan's split (``ft_plan``) is marked.

``prefill`` times, at each shape of chip_smoke.py's BENCH_PREFILL_SHAPES
(bf16, bf16 store), the tile plan, the strip plan the same call takes below
``M_TILE`` rows, the library call and the plain version (its f32 product
with PyTorch's default, TF32 off), with the bound, each shape's launches a
batch and the totals a batch.  ``m_sweep`` times the tile and strip plans
at M rows per expert from 32 to 1024 on four (E, K, N) and prints, per M,
whether the tile plan was the faster at every one: ``M_TILE`` is the
smallest M from which it is, at that M and every larger one.

The ablations are built into build/ft_matmul_sweep/ by substituting text in
the source; they are probes, never loaded by the port.  Needs one CUDA card;
exits non-zero without one.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

ABLATIONS = {
    # no weight bytes: every copy of the strip kernels zero-fills its cell
    "no_loads": [("const bool ok = n_ok && k < sl.kend;", "const bool ok = false;"),
                 ("const bool ok = k < sl.kend && n < N;", "const bool ok = false;")],
    # no reduction across the cluster: every rank stores its own partial
    # (a wrong result, timed only): what the cluster barrier and the
    # distributed-shared-memory sum cost
    "no_reduction": [("  if (split > 1) {\n    if (rank > 0) {", "  if (false) {\n    if (rank > 0) {")],
    # bf16 x bf16 on the CUDA cores
    "cuda_cores": [("if constexpr (std::is_same_v<XT, __nv_bfloat16> && std::is_same_v<WT, __nv_bfloat16>)",
                    "if constexpr (false)")],
}
SPLITS = (1, 2, 4, 8)
PARTS = ("decode", "prefill", "m_sweep")
M_SWEEP = (32, 48, 64, 96, 128, 192, 256, 384, 512, 1024)
# (name, E, K, N) of the M sweep: a dense projection and a narrow one, and
# both models' expert stacks
M_SWEEP_SHAPES = (("qkvo_2048x2048", 1, 2048, 2048), ("kv_1536x512", 1, 1536, 512),
                  ("gate_up_48x1536x512", 48, 1536, 512), ("gate_up_64x2048x1408", 64, 2048, 1408))


def build_ablations(out_dir: Path) -> dict[str, ctypes.CDLL]:
    """Each ablation of csrc/ft_matmul.cu as its own library, one nvcc each,
    started together."""
    from repro_torch.kernels import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "ft_matmul.cu").read_text()
    jobs = {}
    for name, subs in ABLATIONS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"ablation {name}: {old!r} is not in csrc/ft_matmul.cu")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        so = out_dir / f"{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for ablation {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.ft_matmul_launch.argtypes = [p, p, p, p, p, i, i, i, i64, i64, i64, i64, i, i, i, i, i, i, i, i, p]
    lib.ft_matmul_batched_launch.argtypes = [p, p, p, p, p, i, i, i, i, i64, i64, i64, i64, i64, i64,
                                             i, i, i, i, i, i, i, i, p]
    return lib


def caller(lib: ctypes.CDLL, split: int, and_g, or_g, plan=None):
    """``(x, w) -> bf16 out`` through ``lib`` at the plan's layout and strip
    width but the given split, or at ``plan`` as it is."""
    from repro_torch.kernels import ft_matmul as FM

    rows, cols = and_g.shape
    fixed = plan

    def run(x, w):
        plan = fixed or dataclasses.replace(FM.plan_of(x, w), split=split)
        stream = torch.cuda.current_stream().cuda_stream
        tail = (1, 1, rows, cols, FM.LAYOUTS.index(plan.layout), plan.split, plan.bn, 1, stream)
        if x.dim() == 3:
            e, m, k = x.shape
            out = torch.empty((e, m, w.shape[2]), dtype=torch.bfloat16, device=x.device)
            rc = lib.ft_matmul_batched_launch(x.data_ptr(), w.data_ptr(), and_g.data_ptr(), or_g.data_ptr(),
                                              out.data_ptr(), e, m, w.shape[2], k, *x.stride(), *w.stride(), *tail)
        else:
            m, k = x.shape
            out = torch.empty((m, w.shape[1]), dtype=torch.bfloat16, device=x.device)
            rc = lib.ft_matmul_launch(x.data_ptr(), w.data_ptr(), and_g.data_ptr(), or_g.data_ptr(),
                                      out.data_ptr(), m, w.shape[1], k, *x.stride(), *w.stride(), *tail)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc} at {plan}")
        return out
    return run


def _tile_operands(g, dev, e: int, m: int, k: int, n: int, l2_bytes: int):
    """bf16 ``x`` and enough weight copies that each call reads its weight
    from device memory: (E, M, K) and (E, K, N), or 2-D for E = 1."""
    x = torch.randn((e, m, k), generator=g, device=dev).to(torch.bfloat16)
    w_bytes = 2 * e * k * n
    ws = [(torch.randn((e, k, n), generator=g, device=dev) * 0.02).to(torch.bfloat16)
          for _ in range(max(1, min(16, -(-2 * l2_bytes // w_bytes))))]
    if e == 1:
        x, ws = x[0], [w[0] for w in ws]
    return x, ws


def tile_rows(cs, FM, lib, and_g, or_g, dev, part: str, smi: str) -> list[dict]:
    """The ``prefill`` or ``m_sweep`` rows: device us of one call of the
    tile plan and of the strip plan (``strip_plan``), and the library's."""
    g = torch.Generator(device=dev).manual_seed(2)
    if part == "prefill":
        shapes = [(arch, s[0], s[1], s[2], s[3], s[4], s[5])
                  for arch in cs.BENCH_PREFILL_SHAPES for s in cs.BENCH_PREFILL_SHAPES[arch]]
    else:
        shapes = [("m_sweep", f"{name}_M{m}", e, m, k, n, 1) for m in M_SWEEP for name, e, k, n in M_SWEEP_SHAPES]
    rows = []
    for arch, name, e, m, k, n, per in shapes:
        x, ws = _tile_operands(g, dev, e, m, k, n, cs.L2_BYTES)
        calls = [(x, w) for w in ws]
        iters = max(20, 2 * len(ws))
        strip = FM.strip_plan(e, m, n, k, torch.bfloat16, "n_fast")
        bound, by = cs.bound_ms(2 * e * (m * k + k * n + m * n), 2 * e * m * n * k, torch.bfloat16)

        def device_us(fn):
            ms = cs.device_ms(fn, calls, iters)
            return None if ms is None else 1e3 * ms

        us = {"tile": device_us(caller(lib, 1, and_g, or_g, FM.TILE_PLAN)),
              "strip": device_us(caller(lib, strip.split, and_g, or_g, strip)),
              "library": device_us(torch.matmul if e == 1 else torch.bmm)}
        if part == "prefill":
            plain = FM.ft_matmul_ref if e == 1 else FM.ft_matmul_batched_ref
            us["plain"] = device_us(lambda x, w: plain(x, w, and_g, or_g, out_dtype=torch.bfloat16))
        row = dict(part=part, arch=arch, shape=name, E=e, M=m, K=k, N=n, launches_per_batch=per,
                   plan=cs._plan_str(FM.plan_of(x, ws[0])), strip_plan=cs._plan_str(strip), bound_us=1e3 * bound,
                   bound_by=by, us=us, tile_share_of_bound=(1e3 * bound / us["tile"]) if us["tile"] else None,
                   card=smi)
        rows.append(row)
        print(json.dumps(row), flush=True)
        del ws, calls
    if part == "prefill":
        for arch in cs.BENCH_PREFILL_SHAPES:
            mine = [r for r in rows if r["arch"] == arch]
            tot = {k: sum(r["us"][k] * r["launches_per_batch"] for r in mine if r["us"][k]) / 1e3
                   for k in ("tile", "strip", "library", "plain")}
            print(json.dumps(dict(part="prefill_total", arch=arch, ms_per_batch=tot,
                                  bound_ms=sum(r["bound_us"] * r["launches_per_batch"] for r in mine) / 1e3,
                                  card=smi)), flush=True)
    else:
        faster = {m: all(r["us"]["tile"] < r["us"]["strip"] for r in rows if r["M"] == m) for m in M_SWEEP}
        m_tile = next((m for i, m in enumerate(M_SWEEP) if all(faster[mm] for mm in M_SWEEP[i:])), None)
        print(json.dumps(dict(part="m_sweep_result", tile_faster_at=faster, m_tile=m_tile,
                              module_m_tile=FM.M_TILE, card=smi)), flush=True)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default=",".join(PARTS), help=f"comma-separated, of {PARTS}")
    ap.add_argument("--out", help="also write every row as JSON to this file")
    args = ap.parse_args()
    parts = args.parts.split(",")
    if not set(parts) <= set(PARTS):
        ap.error(f"--parts takes {PARTS}")
    if not torch.cuda.is_available():
        print("ft_matmul_sweep: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import ft_matmul as FM

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    libs = {"kernel": bind(_build.load("ft_matmul"))}
    and_g, or_g = cs.fault_grids(dev)
    rows_out = []
    for part in ("prefill", "m_sweep"):
        if part in parts:
            rows_out += tile_rows(cs, FM, libs["kernel"], and_g, or_g, dev, part, smi)
    if "decode" in parts:
        libs.update({k: bind(v) for k, v in build_ablations(ROOT / "build" / "ft_matmul_sweep").items()})
    g = torch.Generator(device=dev).manual_seed(1)
    for arch in ((cs.QWEN, cs.GRANITE) if "decode" in parts else ()):
        for shape in cs.DECODE_SHAPES[arch] + cs.EXPERT_SHAPES[arch]:
            name, per = shape[0], shape[-1]
            if len(shape) == 5:
                _, m, k, n, _ = shape
                e = 1
                x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
                head = name.startswith("head")

                def weight():
                    if head:
                        return (torch.randn((n, k), generator=g, device=dev) * 0.02).to(torch.bfloat16).T
                    return (torch.randn((k, n), generator=g, device=dev) * 0.02).to(torch.bfloat16)
                library = torch.matmul
            else:
                _, e, m, k, n, _ = shape
                x = cs.dispatch_view(torch.randn((m, e, 1, k), generator=g, device=dev).to(torch.bfloat16))

                def weight():
                    return (torch.randn((e, k, n), generator=g, device=dev) * 0.02).to(torch.bfloat16)
                library = torch.bmm
            w_bytes = 2 * e * k * n
            ws = [weight() for _ in range(max(1, min(64, -(-2 * cs.L2_BYTES // w_bytes))))]
            calls = [(x, w) for w in ws]
            iters = max(20, 4 * len(ws))
            plan = FM.plan_of(x, ws[0])
            bound, _ = cs.bound_ms(2 * e * m * k + w_bytes + 2 * e * m * n, 2 * e * m * n * k, torch.bfloat16)
            def device_us(fn):
                ms = cs.device_ms(fn, calls, iters)
                return None if ms is None else 1e3 * ms

            us = {"library": device_us(library)}
            for lib_name, lib in libs.items():
                for split in ((1,) if plan.layout == "k_fast" else SPLITS):
                    us[f"{lib_name}/S{split}"] = device_us(caller(lib, split, and_g, or_g))
            us["library_after"] = device_us(library)
            row = dict(arch=arch, shape=name, E=e, M=m, K=k, N=n, launches_per_step=per,
                       plan=cs._plan_str(plan), bound_us=1e3 * bound, us=us, card=smi)
            rows_out.append(row)
            print(json.dumps(row), flush=True)
            del ws, calls
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows_out, indent=1))


if __name__ == "__main__":
    main()
