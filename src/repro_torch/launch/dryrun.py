"""Dry run: trace every (architecture × input-shape × mesh) cell without
allocating a byte.

On the ``host`` mesh (one device, the port's default) each cell's step is
traced on ``meta`` tensors of the full width
(:func:`repro_torch.launch.probes.step_fn`: the fused prefill, the decode
step, the train step) and the record holds what the reference's compiled
cell reports: ``cost_analysis`` (FLOPs, bytes accessed: an unfused eager
count, :mod:`repro_torch.launch.hlo_stats`), ``collectives`` (all zero on
one device), ``op_histogram`` and ``memory_analysis``, whose argument and
output bytes are the exact sizes of the step's inputs and outputs.  The
trace keeps no temporaries, so there is no ``temp_size_in_bytes``.

On the production meshes (``single``: 16 × 16, ``multi``: 2 × 16 × 16) the
port has no sharded step yet (ROADMAP A), so the record is
``"status": "specs_only"``: the spec trees of params (Megatron TP),
optimizer state (ZeRO-1) and inputs, each spec checked to divide its
dimension, and the argument bytes one device holds under them.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --mesh host
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --mesh single
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, applicable, input_shardings, input_specs
from repro_torch.dist.sharding import axis_sizes, local_bytes, param_specs, spec_axes, use_mesh, zero1_specs
from repro_torch.launch.hlo_stats import collective_stats, op_histogram
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.probes import meta_params, trace_step

OUT_DIR = "experiments/bench_torch/dryrun"
MESH_KINDS = ("host", "single", "multi")


def _fmt_bytes(b):
    return f"{b / 2**30:.2f} GiB" if b >= 2**30 else f"{b / 2**20:.2f} MiB"


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _flat_specs(tree, path: str = "") -> dict:
    """A spec tree as ``{"key.path": [entries]}``, one entry a leaf as the
    reference's pytree has them (a layer stack's leaf once)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_specs(tree[k], f"{path}.{k}" if path else str(k)))
        return out
    if isinstance(tree, list):
        return _flat_specs(tree[0], path)
    return {path: [list(e) if isinstance(e, tuple) else e for e in tree]}


def check_divides(tree, spec_tree, mesh, what: str) -> None:
    """Every spec's mesh axes divide the dimension they shard (a layer stack's
    spec is checked on the stacked shape)."""
    sizes = axis_sizes(mesh)

    def walk(t, sp, path, n_layers=None):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], sp[k], f"{path}.{k}", n_layers)
            return
        if isinstance(t, list):
            for a, b in zip(t, sp):
                walk(a, b, path, len(t))
            return
        shape = tuple(t.shape) if n_layers is None else (n_layers, *t.shape)
        if len(sp) > len(shape):
            raise ValueError(f"{what}{path}: spec {sp} has more entries than {shape} has dims")
        for d, e in enumerate(sp):
            g = 1
            for a in spec_axes(e):
                g *= sizes[a]
            if shape[d] % g:
                raise ValueError(f"{what}{path}: spec {sp} puts {g} devices on dim {d} of {shape}")

    walk(tree, spec_tree, "")


def _specs_only(rec: dict, cfg, cell, mesh) -> dict:
    params = meta_params(cfg)
    pspecs = param_specs(params, mesh)
    inputs = input_specs(cfg, cell)
    ispecs = input_shardings(cfg, cell, mesh)
    check_divides(params, pspecs, mesh, "params")
    check_divides(inputs, ispecs, mesh, "inputs")
    per_dev = {"params": local_bytes(params, pspecs, mesh), "inputs": local_bytes(inputs, ispecs, mesh)}
    specs = {"params": _flat_specs(pspecs), "inputs": _flat_specs(ispecs)}
    if cell.kind == "train":
        ospecs = zero1_specs(params, mesh)
        check_divides(params, ospecs, mesh, "opt")
        # AdamW's m and v (f32, the params' shapes) under ZeRO-1; step and gnorm replicated
        per_dev["opt"] = 2 * local_bytes(params, ospecs, mesh) + 8
        specs["opt"] = {"m": _flat_specs(ospecs), "v": _flat_specs(ospecs), "step": [], "gnorm": []}
    rec["specs"] = specs
    rec["argument_bytes_per_device"] = per_dev
    rec["memory_analysis"] = {"argument_size_in_bytes": sum(per_dev.values())}
    rec["status"] = "specs_only"
    return rec


def run_cell(arch: str, shape: str, mesh_kind: str = "host", *, n_micro: int = 8, verbose: bool = True) -> dict:
    if mesh_kind not in MESH_KINDS:
        raise ValueError(f"unknown mesh kind {mesh_kind!r}; known: {MESH_KINDS}")
    cfg = get_config(arch)
    cell = SHAPES[shape]
    if not applicable(cfg, cell):
        return {"arch": arch, "shape": shape, "mesh": mesh_kind, "status": "skipped"}
    mesh = make_host_mesh(device="cpu") if mesh_kind == "host" else make_production_mesh(
        multi_pod=mesh_kind == "multi")
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind, "n_devices": mesh.size}
    t0 = time.perf_counter()
    with use_mesh(mesh):
        if mesh_kind != "host":
            rec = _specs_only(rec, cfg, cell, mesh)
            rec["specs_s"] = round(time.perf_counter() - t0, 3)
            if verbose:
                print(f"  specs only: argument bytes per device "
                      f"{ {k: _fmt_bytes(v) for k, v in rec['argument_bytes_per_device'].items()} }")
            return rec
        trace, args, out, _ = trace_step(cfg, cell, n_micro=n_micro if cell.kind == "train" else 1)
    rec["trace_s"] = round(time.perf_counter() - t0, 3)
    rec["memory_analysis"] = {"argument_size_in_bytes": _nbytes(args), "output_size_in_bytes": _nbytes(out)}
    rec["cost_analysis"] = {"flops": float(trace.flops), "bytes accessed": float(trace.bytes)}
    cs = collective_stats(trace, mesh.size)
    rec["collectives"] = {
        "counts": cs.counts,
        "result_bytes": cs.result_bytes,
        "wire_bytes": cs.wire_bytes,
        "total_wire_bytes": cs.total_wire_bytes,
    }
    rec["op_histogram"] = op_histogram(trace)
    rec["n_ops"] = len(trace.records)
    rec["status"] = "ok"
    if verbose:
        print(f"  memory_analysis: { {k: _fmt_bytes(v) for k, v in rec['memory_analysis'].items()} }")
        print(f"  cost_analysis: flops={trace.flops:.3e} bytes={trace.bytes:.3e}  trace {rec['trace_s']} s")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="dry run of every (arch x shape x mesh) cell on meta tensors")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="host", choices=[*MESH_KINDS, "both", "all"],
                    help="host (default; traced), single / multi (specs only), both = single + multi")
    ap.add_argument("--n-micro", type=int, default=8)
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--stop-on-fail", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"both": ["single", "multi"], "all": list(MESH_KINDS)}.get(args.mesh, [args.mesh])
    os.makedirs(args.out_dir, exist_ok=True)

    results = []
    failed = 0
    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                tag = f"{arch}__{shape}__{mk}"
                print(f"[dryrun] {tag}", flush=True)
                try:
                    rec = run_cell(arch, shape, mk, n_micro=args.n_micro)
                except Exception as e:
                    failed += 1
                    rec = {"arch": arch, "shape": shape, "mesh": mk, "status": "FAILED",
                           "error": f"{type(e).__name__}: {e}"}
                    print(f"  FAILED: {rec['error']}")
                    traceback.print_exc()
                    if args.stop_on_fail:
                        raise
                if rec["status"] == "skipped":
                    print("  skipped (long_500k needs sub-quadratic mixing)")
                results.append(rec)
                with open(os.path.join(args.out_dir, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=1)
    ok = sum(r["status"] == "ok" for r in results)
    so = sum(r["status"] == "specs_only" for r in results)
    sk = sum(r["status"] == "skipped" for r in results)
    print(f"\n[dryrun] {ok} ok, {so} specs only, {sk} skipped, {failed} failed / {len(results)} cells")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
