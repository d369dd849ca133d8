"""Cost probes for the roofline: FLOPs, bytes and collective wire bytes of
one step per (arch × shape) cell, counted on ``meta`` tensors.

Each probe traces the port's own step under
:class:`~repro_torch.launch.hlo_stats.OpTrace`, on ``meta`` params and
inputs of the cell's full width, so nothing is allocated:

  * prefill — ``forward(last_only=True)``, the fused prefill;
  * decode  — ``decode_step`` (the f32 masters cast inside the step, as the
    reference's step casts them; with ``serve_bf16`` the working copies the
    server holds, so no cast);
  * train   — ``launch/train.py``'s step: ``loss_fn`` and its backward per
    microbatch, then the AdamW update.

The reference needs reduced-depth probes because XLA's ``cost_analysis``
counts a loop body once; it lowers unrolled probes and solves a linear
system.  An eager trace counts every layer, so the full-depth count can be
taken directly (``direct=True``), and it is, beside the reconstruction:

    serve:   cost(L)    = E + L·B
    train:   cost(M, L) = U + L·u + M·(E + L·B)

with B the cost of a layer, E a microbatch's overhead (embedding, head,
loss), U the step's and u its per-layer part (the optimizer update and the
gradient buffers scale with the params, so with L).  The reference's train
formula has no u: it takes U at the first probe's depth and scales the
per-layer optimizer cost by M.  Here a fourth probe, (2, L2), separates it,
so the reconstruction is exact.  The hybrid family adds a term per shared
block application, g(L) = ceil(L / attn_every), and one probe depth
(attn_every + 1), so that a last partial group (zamba2-1.2b's 38 layers in
groups of 6) is counted exactly.  The moe family's probes keep the config's
first-k dense blocks, and its full depth is ``n_layers`` counted with them;
the reference scales from ``n_layers - first_k_dense`` and so counts one
MoE layer fewer than deepseek-moe-16b has (ROADMAP C).

A probe runs on one device, the host mesh, whose collectives are all zero;
:func:`trace_step` also traces a step sharded on a ``DeviceMesh`` of the
``fake`` process group, which the dry run's production cells use.

    PYTHONPATH=src python -m repro_torch.launch.probes --arch qwen1.5-0.5b --shape decode_32k
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import traceback

import numpy as np
import torch

from repro_torch.configs.shapes import SHAPES, ShapeCell, applicable, input_shardings, input_specs
from repro_torch.dist.sharding import distribute, param_specs, use_mesh
from repro_torch.launch.hlo_stats import _COLLECTIVES, OpTrace, collective_stats
from repro_torch.models.lm import LMConfig, cast_params, decode_step, forward, init_params

OUT_DIR = "experiments/bench_torch/probes"


@dataclasses.dataclass
class Cost:
    flops: float
    bytes: float
    wire: float
    coll_counts: dict
    wire_by_kind: dict = dataclasses.field(default_factory=dict)

    def _merge(self, o, f):
        kinds = set(self.wire_by_kind) | set(o.wire_by_kind)
        return {k: f(self.wire_by_kind.get(k, 0.0), o.wire_by_kind.get(k, 0.0)) for k in kinds}

    def __sub__(self, o):
        return Cost(self.flops - o.flops, self.bytes - o.bytes, self.wire - o.wire,
                    self.coll_counts, self._merge(o, lambda a, b: a - b))

    def scale(self, k):
        return Cost(self.flops * k, self.bytes * k, self.wire * k, self.coll_counts,
                    {n: v * k for n, v in self.wire_by_kind.items()})

    def __add__(self, o):
        return Cost(self.flops + o.flops, self.bytes + o.bytes, self.wire + o.wire,
                    self.coll_counts, self._merge(o, lambda a, b: a + b))

    def asdict(self):
        return {"flops": self.flops, "bytes": self.bytes, "wire_bytes": self.wire,
                "wire_by_kind": self.wire_by_kind}

    def vector(self) -> np.ndarray:
        return np.array([self.flops, self.bytes, self.wire]
                        + [self.wire_by_kind.get(k, 0.0) for k in _COLLECTIVES], dtype=np.float64)

    @staticmethod
    def of_vector(v: np.ndarray, coll_counts: dict | None = None) -> "Cost":
        return Cost(float(v[0]), float(v[1]), float(v[2]), coll_counts or {},
                    {k: float(x) for k, x in zip(_COLLECTIVES, v[3:])})


def cost_of(trace: OpTrace, n_dev: int = 1) -> Cost:
    cs = collective_stats(trace, n_dev)
    return Cost(float(trace.flops), float(trace.bytes), float(cs.total_wire_bytes), cs.counts,
                dict(cs.wire_bytes))


# --------------------------------------------------------------------------- #
# the traced steps
# --------------------------------------------------------------------------- #
def _probe_cfg(cfg: LMConfig, n_layers: int) -> LMConfig:
    """``cfg`` at ``n_layers`` (the moe family's first-k dense blocks kept;
    the port's layer loops are Python loops, so there is nothing to
    unroll)."""
    return dataclasses.replace(cfg, n_layers=n_layers)


def _probe_layers(cfg: LMConfig) -> tuple[list[int], int]:
    """(the depths to probe, the full depth).  The hybrid family adds the
    depth ``attn_every + 1`` (one layer into a second group)."""
    if cfg.family == "hybrid":
        ae = cfg.attn_every or cfg.n_layers
        return ([ae, 2 * ae, ae + 1] if ae > 1 else [1, 2]), cfg.n_layers
    k = cfg.first_k_dense if cfg.family == "moe" else 0
    return [k + 1, k + 2], cfg.n_layers  # encdec: the encoder's fixed depth lands in E


def _layer_terms(cfg: LMConfig, n_layers: int) -> list[float]:
    """The per-depth terms of the cost model: [1, L] (and the hybrid's
    shared-block applications, ceil(L / attn_every))."""
    if cfg.family == "hybrid" and (cfg.attn_every or cfg.n_layers) > 1:
        return [1.0, float(n_layers), float(math.ceil(n_layers / cfg.attn_every))]
    return [1.0, float(n_layers)]


def meta_params(cfg: LMConfig, dtype: torch.dtype | None = None):
    """Full-width ``meta`` params: the f32 masters, or copies in ``dtype``."""
    params = init_params(torch.Generator(), cfg, device="meta")
    return params if dtype is None else cast_params(params, dtype)


def hyca_context():
    """A protected context on the 32 x 32 array with 4 faults (the training
    CLI's), wrapped in the call ledger's stand-in context: the protection
    decisions of the protected step, each protected call a plain matmul
    (so ``meta`` operands work) and one ledger row a call."""
    from repro_torch.core.engine import HyCAConfig
    from repro_torch.core.ftcontext import build_ftcontext
    from repro_torch.launch.train import cli_fault_state
    from repro_torch.obs.counters import _LedgerRecorder

    ftc = build_ftcontext(cli_fault_state(4, 0, device="cpu"), HyCAConfig(rows=32, cols=32, mode="protected"))
    return _LedgerRecorder(ftc)


def step_fn(cfg: LMConfig, cell: ShapeCell, *, n_micro: int = 1, serve_bf16: bool = False,
            cast_once: bool = False, hyca: bool = False, mesh=None):
    """``(fn, args)``: the port's step for this cell and its ``meta``
    arguments; ``fn(*args)`` returns the step's outputs.  With ``hyca`` the
    step's context is :func:`hyca_context`'s recorder, available after a call
    as ``fn.recorder``.

    ``mesh``: a mesh bound to a ``DeviceMesh`` (:func:`~repro_torch.launch.
    mesh.fake_device_mesh`) to run the step sharded on: the params are
    DTensors by :func:`~repro_torch.dist.sharding.param_specs`, the inputs
    and the cache by :func:`~repro_torch.configs.shapes.input_shardings`,
    the train step's optimizer state by ZeRO-1
    (:func:`~repro_torch.launch.train.sharded_state`), all on ``meta``.
    Every output is redistributed to its spec, so no pending sum is left
    unreduced."""
    if cell.kind != "train" and cast_once:
        raise ValueError("cast_once is a train-step option; prefill and decode steps have no microbatches")
    if cell.kind == "train" and serve_bf16:
        raise ValueError("serve_bf16 is a serving option; the train step keeps f32 masters")
    batch = input_specs(cfg, cell)
    rec = hyca_context() if hyca else None
    if mesh is not None:
        batch = distribute(batch, input_shardings(cfg, cell, mesh), mesh)
    if cell.kind == "train":
        from repro_torch.core.engine import HyCAConfig
        from repro_torch.launch.train import (
            TrainConfig, cli_fault_state, make_sharded_train_step, make_train_step, sharded_state,
        )
        from repro_torch.optim.adamw import adamw_init

        tc = TrainConfig(n_micro=n_micro, cast_once=cast_once, hyca_mode="protected" if hyca else "off")
        params = meta_params(cfg)
        if mesh is not None:
            sharded = make_sharded_train_step(cfg, tc, mesh)
            state = sharded_state(params, mesh)

            def fn(state, batch):
                return sharded(state, batch)
        else:
            step = make_train_step(cfg, tc, hyca=HyCAConfig(rows=32, cols=32) if hyca else None,
                                   wrap_ftc=(lambda _: rec) if hyca else None)
            state = {"params": params, "opt": adamw_init(params)}
            fault = cli_fault_state(4, 0, device="cpu") if hyca else None

            def fn(state, batch):
                return step(state, batch, fault)

        args = (state, batch)
    else:
        params = meta_params(cfg, (torch.bfloat16 if serve_bf16 else None) if cell.kind == "prefill"
                             else (cfg.dtype if serve_bf16 else None))
        if mesh is not None:
            params = distribute(params, param_specs(params, mesh), mesh)
        ctx = (lambda: use_mesh(mesh)) if mesh is not None else contextlib.nullcontext
        if cell.kind == "prefill":
            def fn(params, batch):
                with torch.no_grad(), ctx():
                    return forward(params, cfg, batch, ftc=rec, last_only=True)

            args = (params, batch)
        elif cell.kind == "decode":
            def fn(params, cache, token):
                with torch.no_grad(), ctx():
                    work = params if serve_bf16 else cast_params(params, cfg.dtype)
                    return decode_step(work, cfg, cache, {"token": token}, ftc=rec)

            args = (params, batch["cache"], batch["token"])
        else:
            raise ValueError(cell.kind)
    fn.recorder = rec
    return fn, args


def trace_step(cfg: LMConfig, cell: ShapeCell, **kw) -> tuple[OpTrace, tuple, object, object]:
    """``(trace, args, outputs, recorder)`` of one step of this cell on
    ``meta`` (:func:`step_fn`'s keywords); on a ``mesh``, the trace counts
    what one device runs (:class:`~repro_torch.launch.hlo_stats.OpTrace`)."""
    fn, args = step_fn(cfg, cell, **kw)
    with OpTrace() as trace:
        out = fn(*args)
    return trace, args, out, fn.recorder


def _cost(cfg, cell, n_dev, **kw) -> tuple[Cost, object]:
    trace, _, _, rec = trace_step(cfg, cell, **kw)
    return cost_of(trace, n_dev), rec


# --------------------------------------------------------------------------- #
# the probes and their reconstruction
# --------------------------------------------------------------------------- #
def probe_cell(
    arch_cfg: LMConfig,
    cell: ShapeCell,
    mesh=None,
    *,
    n_micro_full: int = 8,
    cast_once: bool = False,
    profile: str = "tp",
    serve_bf16: bool = False,
    hyca: bool = False,
    direct: bool = False,
) -> dict:
    """Per-step totals for one (arch × shape) cell, reconstructed from
    reduced-depth probes; ``direct`` also traces the full-depth step and
    records its count and the reconstruction's relative error.  ``mesh``:
    a one-device mesh (None: the host mesh); a larger mesh raises, since a
    sharded step is traced whole by the dry run (``trace_step(mesh=...)``).  On one device every ``profile`` is the same
    program; it is recorded."""
    from repro_torch.dist.sharding import PROFILE_RULES

    if profile not in PROFILE_RULES:
        raise ValueError(f"unknown profile {profile!r}; known: {tuple(PROFILE_RULES)}")
    n_dev = 1 if mesh is None else int(math.prod(mesh.shape))
    if n_dev != 1:
        raise NotImplementedError(
            f"a {tuple(mesh.shape)} mesh: the probes reconstruct a step on one device and probe no sharded "
            "step; trace one with launch/dryrun.py (run_cell on 'single' or 'multi')")
    depths, l_full = _probe_layers(arch_cfg)
    kw = dict(serve_bf16=serve_bf16, cast_once=cast_once, hyca=hyca)
    micros = [1]
    if cell.kind == "train":
        # hold the MICROBATCH at the production size, vary (n_micro, L) around it
        mb = cell.global_batch // n_micro_full
        micros = [1, 2]
    rows, costs = [], []
    with use_mesh(mesh):
        for m in micros:
            c = dataclasses.replace(cell, global_batch=m * mb) if cell.kind == "train" else cell
            for L in depths:
                cost, _ = _cost(_probe_cfg(arch_cfg, L), c, n_dev, n_micro=m, **kw)
                t = _layer_terms(arch_cfg, L)
                rows.append(t + [m * x for x in t] if cell.kind == "train" else t)
                costs.append(cost)
    coeff = np.linalg.solve(np.array(rows), np.stack([c.vector() for c in costs]))
    counts = costs[1].coll_counts
    terms = [Cost.of_vector(v, counts) for v in coeff]
    n_t = len(_layer_terms(arch_cfg, l_full))
    t_full = np.array(_layer_terms(arch_cfg, l_full))
    m_full = n_micro_full if cell.kind == "train" else 1
    per_micro = Cost.of_vector(t_full @ coeff[-n_t:], counts)
    if cell.kind == "train":
        per_step = Cost.of_vector(t_full @ coeff[:n_t], counts)
        total = per_step + per_micro.scale(m_full)
    else:
        per_step = Cost(0, 0, 0, {})
        total = per_micro
    micro = terms[-n_t:]
    rec = {
        "per_layer": micro[1].asdict(),
        "per_micro_overhead": micro[0].asdict(),
        "per_step_overhead": per_step.asdict(),
        "total": total.asdict(),
        "probe_layers": depths,
        "effective_layers": l_full,
        "n_micro": m_full,
        "collective_counts_probe": counts,
        "n_devices": n_dev,
    }
    if n_t == 3:
        rec["per_shared_block"] = micro[2].asdict()
    if cell.kind == "train":
        rec["per_layer_step"] = terms[1].asdict()
    if hyca:
        _, recorder = _cost(_probe_cfg(arch_cfg, depths[0]), dataclasses.replace(cell, global_batch=mb)
                            if cell.kind == "train" else cell, n_dev, n_micro=1, **kw)
        rec["protected_calls_probe"] = sum(1 for r in recorder.rows if r.protected)
    if direct:
        full, recorder = _cost(arch_cfg, cell, n_dev, n_micro=m_full, **kw)
        if hyca:
            rec["protected_calls"] = sum(1 for r in recorder.rows if r.protected)
        rec["direct"] = full.asdict()
        rec["direct_rel_err"] = {k: abs(total.asdict()[k] - full.asdict()[k]) / max(abs(full.asdict()[k]), 1e-300)
                                 for k in ("flops", "bytes")}
    return rec


def main(argv=None) -> int:
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch.mesh import make_host_mesh

    ap = argparse.ArgumentParser(description="cost probes of the port's steps on meta tensors")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--cast-once", action="store_true")
    ap.add_argument("--n-micro", type=int, default=8)
    ap.add_argument("--loss-chunks", type=int, default=0)
    ap.add_argument("--profile", default="tp", choices=["tp", "dp", "ep"])
    ap.add_argument("--serve-bf16", action="store_true")
    ap.add_argument("--hyca", action="store_true", help="protected-mode matmuls, recorded through the call ledger")
    ap.add_argument("--remat", default=None, choices=[None, "full", "dots", "off"])
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    os.makedirs(args.out_dir, exist_ok=True)
    mesh = make_host_mesh(device="cpu")  # a meta trace runs on no card
    failed = 0
    for a in archs:
        cfg = get_config(a)
        if args.loss_chunks:
            cfg = dataclasses.replace(cfg, loss_chunks=args.loss_chunks)
        if args.remat == "off":
            cfg = dataclasses.replace(cfg, remat=False)
        elif args.remat:
            cfg = dataclasses.replace(cfg, remat_policy=args.remat)
        for s in shapes:
            cell = SHAPES[s]
            if not applicable(cfg, cell):
                continue
            tag = f"{a}__{s}" + (f"__{args.tag}" if args.tag else "")
            print(f"[probe] {tag}", flush=True)
            try:
                rec = probe_cell(cfg, cell, mesh, cast_once=args.cast_once, profile=args.profile,
                                 serve_bf16=args.serve_bf16, n_micro_full=args.n_micro, hyca=args.hyca,
                                 direct=True)
                rec.update({
                    "arch": a, "shape": s, "status": "ok",
                    "opts": {"cast_once": args.cast_once, "profile": args.profile,
                             "serve_bf16": args.serve_bf16, "remat": args.remat, "hyca": args.hyca,
                             "loss_chunks": args.loss_chunks},
                })
            except Exception as e:
                traceback.print_exc()
                failed += 1
                rec = {"arch": a, "shape": s, "status": "FAILED", "error": f"{type(e).__name__}: {e}"[:500]}
            with open(os.path.join(args.out_dir, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
            if rec["status"] == "ok":
                t = rec["total"]
                print(f"  total flops={t['flops']:.3e} bytes={t['bytes']:.3e} wire={t['wire_bytes']:.3e}"
                      + (f"  direct rel err {rec['direct_rel_err']}" if "direct" in rec else ""), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
