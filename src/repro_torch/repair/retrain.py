"""Reduce-style fault-aware retraining (Hanif & Shafique, arXiv:2305.12595).

Remap and prune (:mod:`repro_torch.repair.plan`, :mod:`repro_torch.repair.prune`)
turn the over-capacity corruption into structured zeros; retraining then
recovers most of the pruned accuracy by fine-tuning the model with the
faulty array in the forward pass, so the surviving channels learn to cover
for the zeroed ones.  The budget is small: a handful of steps, only the
affected parameter groups unfrozen.

Two entry points:

  * :func:`retrain` runs :func:`repro_torch.launch.train.make_train_step`
    with the faulty FTContext and the plan active and a gradient mask that
    freezes everything outside the trainable set; it returns repaired params
    to swap into a running
    :class:`~repro_torch.serving.server.FaultTolerantServer`.
  * :func:`finetune_vmapped` is the campaign-scale path: a small model
    fine-tuned under every sampled fault configuration at once, batched over
    the configs (the batched FaultStates and RepairPlans of
    :mod:`repro_torch.core.campaign`); it makes the retrain curve of
    ``bench/repair_recovery.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.engine import FaultState, HyCAConfig, RepairPlan
from repro_torch.tree import map_with_path, tree_leaves, tree_map

__all__ = ["RetrainConfig", "grad_mask", "retrain", "finetune_vmapped"]


@dataclasses.dataclass(frozen=True)
class RetrainConfig:
    """The budget.  ``steps``/``lr``/``n_micro``/``batch``/``seq_len``: the
    optimisation budget; ``trainable``: substrings of a leaf's key path that
    may update (default the FFN stacks); ``layer_range``: an optional [lo,
    hi) of the main-stack layers (``blocks``) to unfreeze."""

    steps: int = 8
    lr: float = 5e-4
    n_micro: int = 1
    batch: int = 4
    seq_len: int = 32
    trainable: tuple[str, ...] = ("ffn",)
    layer_range: tuple[int, int] | None = None
    protect_fraction: float = 1.0
    dispatch: str = "twopass"
    seed: int = 0


def grad_mask(params: Any, rc: RetrainConfig) -> Any:
    """A tree like ``params`` of rank-matched f32 multipliers, 1 where a leaf
    may update and 0 where it is frozen.  The key path is the reference's
    (``blocks/ffn/up``), and a ``layer_range`` selects layers of the
    ``blocks`` stack, so the masks are the reference's with its stacked
    leaves split by layer."""

    def one(path, layer, leaf):
        p = "/".join(path)
        on = (not rc.trainable) or any(t in p for t in rc.trainable)
        if on and rc.layer_range is not None and path[0] == "blocks":
            lo, hi = rc.layer_range
            on = lo <= layer < hi
        return torch.full((1,) * leaf.dim(), float(on), dtype=torch.float32, device=leaf.device)

    return map_with_path(one, params)


def retrain(
    params: Any,
    cfg,
    *,
    hyca: HyCAConfig,
    state: FaultState,
    plan: RepairPlan | dict | None,
    rc: RetrainConfig | None = None,
    data: Any = None,
) -> tuple[Any, dict]:
    """Budgeted fault-aware fine-tune of the f32 master ``params`` of LM
    config ``cfg``, on their device.

    The forward runs protected on the faulty array (``state``) with the
    repair ``plan`` active, so the gradients see the pruned zeros.
    ``data``: anything with ``.batch(step)`` returning numpy arrays (default
    :class:`~repro_torch.data.pipeline.SyntheticLM`).  ``params`` are left
    as they were.  Returns ``(repaired_params, report)``."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.train import TrainConfig, batch_to, make_train_step
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    rc = rc or RetrainConfig()
    tc = TrainConfig(
        n_micro=rc.n_micro,
        opt=AdamWConfig(lr=rc.lr),
        warmup=1,
        total_steps=max(rc.steps, 1),
        hyca_mode="protected",
        hyca_dispatch=rc.dispatch,
        protect_fraction=rc.protect_fraction,
    )
    device = tree_leaves(params)[0].device
    train_state = {"params": params, "opt": adamw_init(params)}
    data = data or SyntheticLM(DataConfig(seed=rc.seed, batch=rc.batch, seq_len=rc.seq_len), cfg)
    step_fn = make_train_step(cfg, tc, hyca=hyca, plan=plan, grad_mask=grad_mask(params, rc))
    losses: list[float] = []
    for step in range(rc.steps):
        train_state, metrics = step_fn(train_state, batch_to(data.batch(step), device), state)
        losses.append(float(metrics["loss"]))
    report = {
        "steps": rc.steps,
        "losses": losses,
        "loss_first": losses[0] if losses else None,
        "loss_last": losses[-1] if losses else None,
        "trainable": list(rc.trainable),
        "device": str(device),
    }
    return train_state["params"], report


def finetune_vmapped(
    loss_fn: Callable[[Any, FaultState, RepairPlan], torch.Tensor],
    params: Any,
    states: FaultState,
    plans: RepairPlan,
    *,
    steps: int,
    lr: float,
) -> Any:
    """SGD fine-tune under every fault configuration at once.

    ``states``/``plans`` carry a leading config axis of n configs
    (:func:`repro_torch.core.campaign.batched_fault_states` /
    :func:`repro_torch.core.campaign.batched_repair_plans`).  ``params``
    (one model) is copied to every config; returns params whose leaves carry
    that leading axis, one adapted model per fault configuration.

    The contract differs from the reference's, whose ``loss_fn(params,
    state, plan)`` is one config's scalar loss, ``vmap``-ed over the configs:
    here ``loss_fn(params_b, states, plans)`` takes the batched params (each
    leaf (n, ...)) with the batched tables and returns the (n,) per-config
    losses, routing its forward through the faulty array batched (e.g.
    :func:`~repro_torch.core.engine.hyca_matmul_batched` with ``w_axis=0``).
    Config i's loss reads only config i's params, so the gradient of the
    summed losses is each config's own gradient, and each step is
    ``p - lr * grad`` per config, as the reference's per-config scan."""
    n = states.fpt.shape[0]
    p = tree_map(lambda a: a.detach().expand(n, *a.shape).clone(), params)
    for _ in range(steps):
        leaves = [a.requires_grad_() for a in tree_leaves(p)]
        losses = loss_fn(p, states, plans)
        if tuple(losses.shape) != (n,):
            raise ValueError(f"loss_fn must return the ({n},) per-config losses, got shape {tuple(losses.shape)}")
        grads = dict(zip(map(id, leaves), torch.autograd.grad(losses.sum(), leaves)))
        p = tree_map(lambda a: (a - lr * grads[id(a)]).to(a.dtype).detach(), p)
    return p
