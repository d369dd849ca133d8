"""Time the port's ft_matmul kernels at the serving path's decode shapes, over
every cluster split, beside three ablations and the library call, on one card.

    python3 tools/ft_matmul_sweep.py [--out FILE]

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
The ablations are built into build/ft_matmul_sweep/ by substituting text in
the source; they are probes, never loaded by the port.  Needs one CUDA card;
exits non-zero without one.
"""
from __future__ import annotations

import argparse
import ctypes
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


def caller(lib: ctypes.CDLL, split: int, and_g, or_g):
    """``(x, w) -> bf16 out`` through ``lib`` at the plan's layout and strip
    width but the given split."""
    from repro_torch.kernels import ft_matmul as FM

    rows, cols = and_g.shape

    def run(x, w):
        plan = FM.plan_of(x, w)
        stream = torch.cuda.current_stream().cuda_stream
        tail = (1, 1, rows, cols, FM.LAYOUTS.index(plan.layout), split, plan.bn, 1, stream)
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
            raise RuntimeError(f"launch failed: CUDA error {rc} at split {split}")
        return out
    return run


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every row as JSON to this file")
    args = ap.parse_args()
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
    libs.update({k: bind(v) for k, v in build_ablations(ROOT / "build" / "ft_matmul_sweep").items()})
    and_g, or_g = cs.fault_grids(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    rows_out = []
    for arch in (cs.QWEN, cs.GRANITE):
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
