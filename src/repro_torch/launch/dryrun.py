"""Dry run: trace every (architecture × input-shape × mesh) cell without
allocating a byte.

Each cell's step is traced on ``meta`` tensors of the full width
(:func:`repro_torch.launch.probes.step_fn`: the fused prefill, the decode
step, the train step) and the record holds what the reference's compiled
cell reports: ``cost_analysis`` (FLOPs, bytes accessed: an unfused eager
count, :mod:`repro_torch.launch.hlo_stats`), ``collectives``,
``op_histogram`` (and ``dot_flops``, the matmuls' share of the FLOPs) and
``memory_analysis``, whose argument and output bytes
are the exact sizes of the step's inputs and outputs.  The trace keeps no
temporaries, so there is no ``temp_size_in_bytes``.

On the ``host`` mesh (one device) the collectives are all zero.  On the
production meshes (``single``: 16 × 16, ``multi``: 2 × 16 × 16) the step
runs on DTensors of a ``fake`` process group
(:func:`~repro_torch.launch.mesh.fake_device_mesh`): params by the Megatron
TP specs, optimizer state by ZeRO-1, inputs and cache by their specs, and
every figure is one device's, as in the reference's SPMD module:
FLOPs and bytes of its local shards, the collectives with their real group
sizes, its argument and output bytes.  The record also keeps the spec trees
(``specs``, each spec checked to divide its dimension) and the argument
bytes they give one device (``argument_bytes_per_device``), which the
traced ``argument_size_in_bytes`` must equal.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --mesh host
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --mesh both
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
from repro_torch.launch.hlo_stats import collective_stats, dot_flops, op_histogram
from repro_torch.launch.mesh import fake_device_mesh, make_host_mesh, make_production_mesh
from repro_torch.launch.probes import meta_params, trace_step

OUT_DIR = "experiments/bench_torch/dryrun"
MESH_KINDS = ("host", "single", "multi")


def _fmt_bytes(b):
    return f"{b / 2**30:.2f} GiB" if b >= 2**30 else f"{b / 2**20:.2f} MiB"


def _nbytes(tree) -> int:
    """Bytes one device holds of a tree: a DTensor's local shard."""
    def local(t):
        return t._local_tensor if hasattr(t, "_local_tensor") else t

    return sum(local(t).numel() * local(t).element_size() for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


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


def spec_record(rec: dict, cfg, cell, mesh) -> dict:
    """``rec`` with the cell's spec trees (params by Megatron TP, inputs,
    and for a train cell the optimizer state by ZeRO-1), each spec checked
    to divide its dimension, and the argument bytes one device holds under
    them (``argument_bytes_per_device``)."""
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
    return rec


def run_cell(arch: str, shape: str, mesh_kind: str = "host", *, n_micro: int = 8, verbose: bool = True) -> dict:
    """The record of one cell (see the module's docstring)."""
    if mesh_kind not in MESH_KINDS:
        raise ValueError(f"unknown mesh kind {mesh_kind!r}; known: {MESH_KINDS}")
    cfg = get_config(arch)
    cell = SHAPES[shape]
    if not applicable(cfg, cell):
        return {"arch": arch, "shape": shape, "mesh": mesh_kind, "status": "skipped"}
    n_micro = n_micro if cell.kind == "train" else 1
    t0 = time.perf_counter()
    if mesh_kind == "host":
        mesh = make_host_mesh(device="cpu")
        rec = {"arch": arch, "shape": shape, "mesh": mesh_kind, "n_devices": mesh.size}
        with use_mesh(mesh):
            trace, args, out, _ = trace_step(cfg, cell, n_micro=n_micro)
    else:
        spec = make_production_mesh(multi_pod=mesh_kind == "multi")
        rec = spec_record({"arch": arch, "shape": shape, "mesh": mesh_kind, "n_devices": spec.size}, cfg, cell, spec)
        rec["specs_s"] = round(time.perf_counter() - t0, 3)
        t0 = time.perf_counter()
        with fake_device_mesh(spec) as mesh:
            trace, args, out, _ = trace_step(cfg, cell, n_micro=n_micro, mesh=mesh)
    rec["trace_s"] = round(time.perf_counter() - t0, 3)
    rec["memory_analysis"] = {"argument_size_in_bytes": _nbytes(args), "output_size_in_bytes": _nbytes(out)}
    if "argument_bytes_per_device" in rec and rec["memory_analysis"]["argument_size_in_bytes"] != sum(
            rec["argument_bytes_per_device"].values()):
        raise RuntimeError(f"{arch} {shape} {mesh_kind}: the traced step's arguments hold "
                             f"{rec['memory_analysis']['argument_size_in_bytes']} bytes a device, its specs "
                             f"{rec['argument_bytes_per_device']}")
    rec["cost_analysis"] = {"flops": float(trace.flops), "bytes accessed": float(trace.bytes)}
    cs = collective_stats(trace, rec["n_devices"])
    rec["collectives"] = {
        "counts": cs.counts,
        "result_bytes": cs.result_bytes,
        "wire_bytes": cs.wire_bytes,
        "total_wire_bytes": cs.total_wire_bytes,
    }
    rec["op_histogram"] = op_histogram(trace)
    rec["dot_flops"] = float(dot_flops(trace))
    rec["n_ops"] = len(trace.records)
    rec["status"] = "ok"
    if verbose:
        print(f"  memory_analysis: { {k: _fmt_bytes(v) for k, v in rec['memory_analysis'].items()} }")
        print(f"  cost_analysis: flops={trace.flops:.3e} bytes={trace.bytes:.3e}  trace {rec['trace_s']} s")
        if mesh_kind != "host":
            print(f"  collectives: { {k: v for k, v in cs.counts.items() if v} } "
                  f"wire={_fmt_bytes(int(cs.total_wire_bytes))}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="dry run of every (arch x shape x mesh) cell on meta tensors")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="host", choices=[*MESH_KINDS, "both", "all"],
                    help="host (default), single / multi (sharded on a fake process group), both = single + multi")
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
    sk = sum(r["status"] == "skipped" for r in results)
    print(f"\n[dryrun] {ok} ok, {sk} skipped, {failed} failed / {len(results)} cells")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
