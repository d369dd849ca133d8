"""The training step and its command-line entry point, on one device; and the train step
sharded on DTensors (:func:`make_sharded_train_step`, ZeRO-1 optimizer
state), which the dry run traces on the production meshes.

``make_train_step`` is the reference's train step without a mesh:

  * microbatch gradient accumulation in f32 (a Python loop over
    ``n_micro`` slices of the batch);
  * optional ``cast_once``: the f32 masters cast to ``cfg.dtype`` once a
    step, the gradients taken with respect to those copies;
  * an optional gradient mask (:func:`repro_torch.repair.retrain.grad_mask`)
    that also gates the update, so frozen leaves stay bit for bit;
  * optional top-k gradient compression with error feedback;
  * the ``cosine_warmup`` schedule and AdamW;
  * optional HyCA protection: an FTContext routes every weight matmul
    through the engine with the fault table an argument of the step.

It trains under ``hyca_dispatch="twopass"`` (the default) and ``"plain"``.
The fused dispatch carries no gradient: the reference's fused epilogue
works on bit patterns, so on its ``ref`` backend ``jax.grad`` is zero, and
its Pallas kernels cannot be transposed (ROADMAP C5).  A fused protected or
unprotected train step is refused.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core.engine import FaultState, HyCAConfig
from repro_torch.core.ftcontext import FTContext, ProtectPolicy, build_ftcontext
from repro_torch.dist.sharding import is_dtensor
from repro_torch.models.lm import LMConfig, cast_params, init_params, loss_fn
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.compression import compress, ef_init
from repro_torch.optim.schedules import cosine_warmup
from repro_torch.tree import stack_tree, tree_leaves, tree_map, tree_map2, unstack_tree


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_micro: int = 8
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    warmup: int = 100
    total_steps: int = 1000
    grad_compress_ratio: float = 0.0   # 0 = off
    hyca_mode: str = "off"             # off | protected | unprotected
    hyca_dispatch: str = "twopass"     # plain | twopass (fused: refused, C5)
    protect_fraction: float = 1.0      # fraction of main-stack layers protected
    aux_weight: float = 0.01
    cast_once: bool = False            # cast the masters once a step, not per microbatch


def make_ftc(tc: TrainConfig, hyca: HyCAConfig | None, state: FaultState | None,
             plan=None) -> FTContext | None:
    """The training FTContext (None: protection off).  ``plan``: an optional
    RepairPlan (or per-site dict) the forward runs with."""
    if hyca is None or tc.hyca_mode == "off" or state is None:
        return None
    return build_ftcontext(
        state, dataclasses.replace(hyca, mode=tc.hyca_mode),
        policy=ProtectPolicy(layer_fraction=tc.protect_fraction),
        dispatch=tc.hyca_dispatch,
        plan=plan,
    )


def init_state(gen: torch.Generator, cfg: LMConfig, tc: TrainConfig) -> dict:
    """{"params", "opt"[, "ef"]} on the generator's device."""
    params = init_params(gen, cfg)
    state = {"params": params, "opt": adamw_init(params)}
    if tc.grad_compress_ratio:
        state["ef"] = ef_init(params)
    return state


def _split_micro(batch: dict, n_micro: int) -> dict:
    def f(x):
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} does not split into {n_micro} microbatches")
        return x.reshape(n_micro, b // n_micro, *x.shape[1:])

    return {k: f(v) for k, v in batch.items()}


def make_train_step(cfg: LMConfig, tc: TrainConfig, *, hyca: HyCAConfig | None = None,
                    plan=None, grad_mask=None, wrap_ftc=None):
    """``step(state, batch, fault_state=None) -> (state, metrics)``.

    ``batch``: {"tokens", "labels"} (B, S) int tensors on the state's
    device.  ``metrics``: 0-d tensors ``loss``, ``aux``, ``lr``, ``gnorm``.
    The step returns a new state and leaves the one it was given as it was.

    ``plan``: a RepairPlan (or per-site dict) the protected forward applies.
    ``grad_mask``: a tree of broadcastable multipliers matching the params;
    the gradients are masked before the optimizer and the update is gated
    by it, so frozen leaves stay bit for bit.
    ``wrap_ftc``: applied to the step's FTContext (when there is one) before
    the forward sees it; the cost probes (``launch/probes.py``) record the
    protected calls through it."""
    if tc.hyca_mode != "off" and tc.hyca_dispatch == "fused":
        raise ValueError(
            "hyca_dispatch='fused' cannot train (ROADMAP C5): the fused epilogue works on bit "
            "patterns and carries no gradient, the reference's ref backend gives zero gradients and "
            "its Pallas kernels cannot be transposed; train under hyca_dispatch='twopass'"
        )

    def step(state: dict, batch: dict, fault_state: FaultState | None = None) -> tuple[dict, dict]:
        params = state["params"]
        fwd = cast_params(params, cfg.dtype) if tc.cast_once else params
        leaves = tree_map(lambda a: a.detach().requires_grad_(), fwd)
        flat = tree_leaves(leaves)
        micro = _split_micro(batch, tc.n_micro)
        ftc = make_ftc(tc, hyca, fault_state, plan)
        if ftc is not None and wrap_ftc is not None:
            ftc = wrap_ftc(ftc)
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
        gflat = tree_leaves(gsum)
        dev = flat[0].device
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        asum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(tc.n_micro):
            mb = {k: v[i] for k, v in micro.items()}
            loss, metrics = loss_fn(leaves, cfg, mb, aux_weight=tc.aux_weight, ftc=ftc)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
            with torch.no_grad():
                for acc, g in zip(gflat, grads):
                    if g is not None:
                        acc.add_(g.to(torch.float32))
                lsum += metrics["loss"].detach()
                asum += metrics["aux"].detach()
        with torch.no_grad():
            grads = tree_map(lambda g: g / tc.n_micro, gsum)
            if grad_mask is not None:
                grads = tree_map2(lambda g, m: g * m, grads, grad_mask)
            new_state = dict(state)
            if tc.grad_compress_ratio:
                grads, new_state["ef"], _ = compress(grads, state["ef"], tc.grad_compress_ratio)
            lr = cosine_warmup(state["opt"]["step"], peak_lr=tc.opt.lr, warmup=tc.warmup,
                               total=tc.total_steps)
            new_params, new_opt = adamw_update(grads, state["opt"], params, tc.opt, lr)
            if grad_mask is not None:
                new_params = tree_map2(lambda new, old, m: torch.where(m > 0, new, old),
                                       new_params, params, grad_mask)
            new_state["params"], new_state["opt"] = new_params, new_opt
            metrics = {"loss": lsum / tc.n_micro, "aux": asum / tc.n_micro, "lr": lr,
                       "gnorm": new_opt["gnorm"]}
        return new_state, metrics

    return step


def sharded_state(params: Any, mesh) -> dict:
    """The train state of :func:`make_sharded_train_step` for ``params``
    (``meta`` or real, in the port's layout) on ``mesh`` (a ``DeviceMesh``
    or a :class:`~repro_torch.launch.mesh.BoundMesh`): the params as DTensors by their specs, AdamW's ``m`` and
    ``v`` in the reference's stacked layout (:func:`~repro_torch.tree.
    stack_tree`) by the ZeRO-1 specs, ``step`` and ``gnorm`` replicated.
    ZeRO-1 puts the data axes on the layer axis of some small stacked
    leaves (norm scales, RWKV's ``mu``), which a per-layer tensor cannot
    hold; a stacked leaf can, so each device holds the optimizer bytes
    ``local_bytes(params, zero1_specs(...))`` counts."""
    from repro_torch.dist.sharding import distribute, param_specs, stacked_specs, zero1_specs

    opt = adamw_init(params)
    ospecs = stacked_specs(zero1_specs(params, mesh))
    return {"params": distribute(params, param_specs(params, mesh), mesh),
            "opt": {"m": distribute(stack_tree(opt["m"]), ospecs, mesh),
                    "v": distribute(stack_tree(opt["v"]), ospecs, mesh),
                    "step": distribute(opt["step"], (), mesh), "gnorm": distribute(opt["gnorm"], (), mesh)}}


def make_sharded_train_step(cfg: LMConfig, tc: TrainConfig, mesh):
    """``step(state, batch) -> (state, metrics)`` on DTensors of ``mesh``:
    the step of :func:`make_train_step` without a fault context, mask or
    compression, with ZeRO-1 optimizer state (:func:`sharded_state`), under
    the current rules (the tp profile's by default, as the reference's
    dry run traces its step, ``src/repro/launch/train.py:221``).

    ``batch``: {"tokens", "labels"} (B, S) DTensors, batch over the data
    axes.  Microbatch ``i`` takes rows ``i, i + n_micro, ...``, so that
    every device's rows split evenly without a collective (the plain step
    takes contiguous rows; the step sums the same rows).  Each microbatch's
    gradients are summed as DTensors (a data-parallel gradient stays a
    pending sum), reduced once into their ZeRO-1 shards (a reduce-scatter
    over the data axes), AdamW updates the shards, and the new params are
    gathered back to their specs.  Every output carries its spec's
    placements, none a pending sum."""
    from repro_torch.dist.sharding import param_specs, redistribute, stacked_specs, use_mesh, zero1_specs

    if tc.hyca_mode != "off" or tc.grad_compress_ratio or tc.cast_once:
        raise ValueError("the sharded train step has no fault context, compression or cast_once")

    def step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        pspecs = param_specs(params, mesh)
        ospecs = stacked_specs(zero1_specs(params, mesh))
        with use_mesh(mesh):
            leaves = tree_map(lambda a: a.detach().requires_grad_(), params)
            flat = tree_leaves(leaves)
            micro = {k: v.reshape(v.shape[0] // tc.n_micro, tc.n_micro, *v.shape[1:]) for k, v in batch.items()}
            gsum = lsum = asum = None
            for i in range(tc.n_micro):
                mb = {k: v[:, i] for k, v in micro.items()}
                loss, metrics = loss_fn(leaves, cfg, mb, aux_weight=tc.aux_weight)
                grads = [torch.zeros_like(p, dtype=torch.float32) if g is None else g.to(torch.float32)
                         for p, g in zip(flat, torch.autograd.grad(loss, flat, allow_unused=True))]
                with torch.no_grad():
                    gsum = grads if gsum is None else [a + g for a, g in zip(gsum, grads)]
                    lsum = metrics["loss"].detach() if lsum is None else lsum + metrics["loss"].detach()
                    asum = metrics["aux"].detach() if asum is None else asum + metrics["aux"].detach()
            with torch.no_grad():
                grads = _unflatten(params, [g / tc.n_micro for g in gsum])
                lr = cosine_warmup(state["opt"]["step"], peak_lr=tc.opt.lr, warmup=tc.warmup,
                                   total=tc.total_steps)
                g_o = redistribute(stack_tree(grads), ospecs, mesh)
                p_o = redistribute(stack_tree(params), ospecs, mesh)
                new_p, new_opt = adamw_update(g_o, state["opt"], p_o, tc.opt, lr)
                new_params = unstack_tree(redistribute(new_p, stacked_specs(pspecs), mesh), params)
                metrics = {"loss": lsum / tc.n_micro, "aux": asum / tc.n_micro, "lr": lr, "gnorm": new_opt["gnorm"]}
                metrics = {k: redistribute(v, (), mesh) if is_dtensor(v) else v for k, v in metrics.items()}
                new_opt["gnorm"] = metrics["gnorm"]
        return {**state, "params": new_params, "opt": new_opt}, metrics

    return step


def _unflatten(like, flat: list):
    """``flat`` (tensors in :func:`tree_leaves` order) in ``like``'s
    structure."""
    it = iter(flat)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return next(it)

    return walk(like)


# --------------------------------------------------------------------------- #
# CLI driver
# --------------------------------------------------------------------------- #
def batch_to(batch: dict, device) -> dict:
    """A numpy batch of :class:`~repro_torch.data.pipeline.SyntheticLM` as
    tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def cli_fault_state(n_faults: int, seed: int, *, device) -> FaultState:
    """The CLI's seeded fault map on a 32 x 32 array: ``n_faults`` distinct
    PEs drawn from ``seed``, the stuck-at signatures from the default
    generator, as the reference's CLI draws them."""
    from repro_torch.core.engine import fault_state_from_map

    fmap = np.zeros((32, 32), bool)
    rng = np.random.default_rng(seed)
    fmap.reshape(-1)[rng.choice(32 * 32, size=n_faults, replace=False)] = True
    return fault_state_from_map(fmap, max_faults=max(n_faults, 1), device=device)


def main(argv=None):
    from repro_torch.checkpoint.store import CheckpointManager
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-micro", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--compress", type=float, default=0.0)
    ap.add_argument("--hyca-mode", default="off", choices=["off", "protected", "unprotected"])
    ap.add_argument("--hyca-dispatch", default="twopass", choices=["plain", "twopass", "fused"])
    ap.add_argument("--protect-fraction", type=float, default=1.0)
    ap.add_argument("--hyca-faults", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write per-step train.step events as JSONL to PATH "
                         "and a final-summary gauge file to PATH.prom")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but CUDA is not available; pass --device cpu")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tc = TrainConfig(
        n_micro=args.n_micro,
        opt=AdamWConfig(lr=args.lr),
        total_steps=args.steps,
        warmup=max(1, args.steps // 10),
        grad_compress_ratio=args.compress,
        hyca_mode=args.hyca_mode,
        hyca_dispatch=args.hyca_dispatch,
        protect_fraction=args.protect_fraction,
    )
    state = init_state(torch.Generator(device=dev).manual_seed(args.seed), cfg, tc)
    data = SyntheticLM(DataConfig(seed=args.seed, batch=args.batch, seq_len=args.seq), cfg)

    hyca_cfg = fault_state = None
    if args.hyca_mode != "off":
        hyca_cfg = HyCAConfig(rows=32, cols=32, mode=args.hyca_mode)
        fault_state = cli_fault_state(args.hyca_faults, args.seed, device=dev)
    step_fn = make_train_step(cfg, tc, hyca=hyca_cfg)

    mgr = CheckpointManager(args.ckpt_dir, every=args.ckpt_every) if args.ckpt_dir else None
    start = 0
    if mgr is not None:
        resumed = mgr.resume(state, device=dev)
        if resumed is not None:
            start, state = resumed
            print(f"[train] resumed from step {start}")

    log = None
    if args.metrics_out:
        from repro_torch.obs.events import EventLog

        log = EventLog()

    last_loss = last_gnorm = None
    for step in range(start, args.steps):
        batch = batch_to(data.batch(step), dev)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch, fault_state)
        loss = float(metrics["loss"])  # the host reads the loss: the step has ended
        dt = time.perf_counter() - t0
        last_loss, last_gnorm = loss, float(metrics["gnorm"])
        if log is not None:
            log.step = step
            log.emit("train.step", loss=loss, lr=float(metrics["lr"]), gnorm=last_gnorm, ms=dt * 1e3)
        if step % max(1, args.steps // 20) == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d} loss {loss:8.4f} lr {float(metrics['lr']):.2e} "
                  f"gnorm {last_gnorm:7.3f} {dt*1e3:7.1f} ms")
        if mgr is not None:
            mgr.maybe_save(step + 1, state, {"arch": cfg.name})
    if log is not None:
        from repro_torch.obs.export import write_metrics_out

        times = [e.data["ms"] for e in log.of_kind("train.step")]
        summary = {
            "steps": len(times),
            "loss_final": last_loss,
            "gnorm_final": last_gnorm,
            "step_ms_mean": sum(times) / len(times) if times else None,
        }
        path, prom = write_metrics_out(args.metrics_out, summary, log,
                                       labels={"arch": cfg.name, "hyca_mode": args.hyca_mode})
        print(f"[train] metrics: events -> {path}  summary -> {prom}")
    return state


if __name__ == "__main__":
    main()
