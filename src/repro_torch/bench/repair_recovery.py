"""Repair recovery: accuracy vs PER with model-side remediation, the
flattened capacity cliff (the twin of the reference's repair_recovery
benchmark).

Fig. 2 shows accuracy collapsing on an unprotected array and HyCA restoring
it bit-exactly while #faults <= DPPU capacity.  Past that capacity the
over-capacity regime is recoverable in the model: four curves over a PER
grid straddling the cliff, every fault configuration evaluated batched in
one call per mode —

  * ``unprotected``  — no DPPU (Fig. 2's collapse);
  * ``protected``    — the DPPU repairs the leftmost ``capacity`` faults, the
                       overflow corrupts (the cliff);
  * ``remap``        — the remap planner routes the least-salient output
                       residue classes onto the unrepairable PE columns and
                       prunes them;
  * ``retrain``      — remap plus a budgeted fine-tune of every config at
                       once (:func:`~repro_torch.repair.retrain.finetune_vmapped`)
                       with the faulty array in the forward pass.

The task, fault maps, PERs, config counts and retrain steps are the
reference's (numpy-seeded); the MLP's initial params are drawn from numpy at
the reference's scale (0.3 · N(0, 1)), so its weights and accuracies differ
from the reference's ``jax.random`` ones, and it is held to the reference's
seven claims.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.bench.common import Claims, device_name, sync
from repro_torch.core import campaign as cp
from repro_torch.core.engine import FaultState, HyCAConfig, hyca_matmul_batched
from repro_torch.core.fault_models import random_fault_maps
from repro_torch.core.redundancy import DPPUConfig
from repro_torch.repair import finetune_vmapped, fold_channel_salience

ROWS = COLS = 16
DPPU = DPPUConfig(size=8, group_size=8)   # capacity 8 of 256 PEs
CLASSES, D_IN, HIDDEN = 16, 32, 32


def _make_task(rng):
    centers = rng.standard_normal((CLASSES, D_IN)) * 1.2

    def make(n):
        y = rng.integers(0, CLASSES, n)
        x = centers[y] + 0.9 * rng.standard_normal((n, D_IN))
        return x.astype(np.float32), y.astype(np.int32)

    return make


def init_params(device) -> dict:
    """The MLP's initial params, from numpy at the reference's scale."""
    init = np.random.default_rng(0)
    return {k: torch.tensor(init.standard_normal(shape) * 0.3, dtype=torch.float32, device=device)
            for k, shape in (("w1", (D_IN, HIDDEN)), ("w2", (HIDDEN, CLASSES)))}


def forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The clean MLP: logits of one model."""
    return torch.relu(x @ p["w1"]) @ p["w2"]


def forward_batched(p: dict, x: torch.Tensor, states: FaultState, plans, cfg: HyCAConfig,
                    *, per_config: bool) -> torch.Tensor:
    """(n, rows, classes) logits of every fault config: the first layer on
    the faulty array (batched over the configs' tables), the second plain.
    ``per_config``: the params' leaves carry the config axis (one model a
    config, as ``finetune_vmapped`` makes them)."""
    h = hyca_matmul_batched(x, p["w1"], states, cfg=cfg, plans=plans, x_axis=None,
                            w_axis=0 if per_config else None)
    return torch.relu(h) @ p["w2"]


def cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the last-but-one axis (one loss a config)."""
    lp = torch.log_softmax(logits, dim=-1)
    return -lp.gather(-1, y.expand(*lp.shape[:-1])[..., None])[..., 0].mean(-1)


def train_clean(params: dict, x: torch.Tensor, y: torch.Tensor, steps: int, lr: float = 0.4) -> dict:
    """Full-batch gradient descent on the clean MLP."""
    p = {k: v.clone() for k, v in params.items()}
    for _ in range(steps):
        leaves = [p[k].requires_grad_() for k in sorted(p)]
        g = torch.autograd.grad(cross_entropy(forward(p, x), y), leaves)
        p = {k: (p[k] - lr * gk).detach() for k, gk in zip(sorted(p), g)}
    return p


def run(quick: bool = False, device="cuda") -> dict:
    dev = cp.resolve_device(device)
    rng = np.random.default_rng(0)
    make = _make_task(rng)
    xtr, ytr = make(2048 if quick else 4096)
    xte, yte = make(256 if quick else 512)

    cfg_p = HyCAConfig(rows=ROWS, cols=COLS, dppu=DPPU, mode="protected")
    cfg_u = dataclasses.replace(cfg_p, mode="unprotected")
    capacity = cfg_p.capacity

    def t(a, dtype=torch.float32):
        return torch.from_numpy(a).to(dev, dtype)

    params = train_clean(init_params(dev), t(xtr), t(ytr, torch.long), 200 if quick else 400)
    xt, yt = t(xte), t(yte, torch.long)
    clean_acc = float((forward(params, xt).argmax(-1) == yt).float().mean())

    # PER grid straddling the 8/256 cliff (E[faults] crosses capacity ~3.1%)
    pers = [0.01, 0.03, 0.06, 0.10] if quick else [0.01, 0.02, 0.03, 0.045, 0.06, 0.08, 0.10]
    n_cfg = 16 if quick else 48
    retrain_steps = 30 if quick else 60
    sal = fold_channel_salience(np.linalg.norm(params["w1"].cpu().numpy(), axis=0), COLS)
    xj, yj = t(xtr[:1024]), t(ytr[:1024], torch.long)

    def acc(p, states, plans, cfg, per_config=False) -> np.ndarray:
        pred = forward_batched(p, xt, states, plans, cfg, per_config=per_config).argmax(-1)
        return (pred == yt[None]).float().mean(-1).cpu().numpy()

    def loss(p, states, plans):
        return cross_entropy(forward_batched(p, xj, states, plans, cfg_p, per_config=True), yj)

    curves: dict[str, dict[float, dict]] = {"unprotected": {}, "protected": {}, "remap": {}, "retrain": {}}
    mean_faults, seconds_per_point = {}, {}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    base_bytes = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    for per in pers:
        t0 = time.perf_counter()
        maps = random_fault_maps(rng, n_cfg, ROWS, COLS, per)
        mean_faults[per] = float(maps.reshape(n_cfg, -1).sum(1).mean())
        states = cp.batched_fault_states(maps, seed=int(per * 1e6) + 1, device=dev)
        valid = states.fpt[..., 0] >= 0   # visible stuck-at-1 exponent faults
        states = FaultState(states.fpt, torch.where(valid, 30, 0).to(torch.int32),
                            torch.where(valid, 1, 0).to(torch.int32))
        plans = cp.batched_repair_plans(states, sal, rows=ROWS, cols=COLS, capacity=capacity, device=dev)
        idplans = cp.identity_plans(n_cfg, ROWS, COLS, device=dev)
        tuned = finetune_vmapped(loss, params, states, plans, steps=retrain_steps, lr=0.3)
        curves["unprotected"][per] = cp.summarize_accuracy(acc(params, states, idplans, cfg_u))
        curves["protected"][per] = cp.summarize_accuracy(acc(params, states, idplans, cfg_p))
        curves["remap"][per] = cp.summarize_accuracy(acc(params, states, plans, cfg_p))
        curves["retrain"][per] = cp.summarize_accuracy(acc(tuned, states, plans, cfg_p, per_config=True))
        sync(dev)
        seconds_per_point[per] = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base_bytes if dev.type == "cuda" else None

    hi, lo = pers[-1], pers[0]
    c = Claims("repair")
    c.check("clean accuracy is high (>0.95)", clean_acc > 0.95, f"{clean_acc:.3f}")
    c.check(
        "below the cliff, protected ~= clean (DPPU covers everything)",
        curves["protected"][lo]["mean"] > clean_acc - 0.02,
        f"protected@{lo:.0%}={curves['protected'][lo]['mean']:.3f}",
    )
    c.check(
        "past the cliff, protected-only collapses",
        curves["protected"][hi]["mean"] < clean_acc - 0.25,
        f"protected@{hi:.0%}={curves['protected'][hi]['mean']:.3f}",
    )
    m_p, m_r, m_t = (curves[k][hi] for k in ("protected", "remap", "retrain"))
    c.check(
        "remap flattens the cliff (CI-robust margin over protected-only)",
        m_r["mean"] - m_r["ci95"] > m_p["mean"] + m_p["ci95"] + 0.15,
        f"remap={m_r['mean']:.3f}±{m_r['ci95']:.3f} vs protected={m_p['mean']:.3f}±{m_p['ci95']:.3f}",
    )
    c.check(
        "retrain recovers at least remap, and decisively beats protected-only",
        m_t["mean"] >= m_r["mean"] - m_r["ci95"] - m_t["ci95"]
        and m_t["mean"] - m_t["ci95"] > m_p["mean"] + m_p["ci95"] + 0.15,
        f"retrain={m_t['mean']:.3f}±{m_t['ci95']:.3f}",
    )
    c.check(
        "remediation holds near-clean accuracy at 3x capacity in faults",
        m_t["mean"] > clean_acc - 0.08,
        f"retrain@{hi:.0%}={m_t['mean']:.3f} (E[faults]={mean_faults[hi]:.1f}, capacity={capacity})",
    )
    c.check(
        "remap curve degrades monotonically but gently",
        all(
            curves["remap"][pers[i]]["mean"] >= curves["remap"][pers[i + 1]]["mean"] - 0.05
            for i in range(len(pers) - 1)
        ),
    )
    return {
        "clean_acc": clean_acc,
        "capacity": capacity,
        "rows": ROWS, "cols": COLS,
        "pers": pers,
        "mean_faults": mean_faults,
        "n_configs": n_cfg,
        "retrain_steps": retrain_steps,
        "curves": curves,
        "device": device_name(dev),
        "seconds_per_point": seconds_per_point,
        "peak_bytes": peak,
        "claims": c.items,
        "all_ok": c.all_ok,
    }
