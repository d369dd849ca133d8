"""FTContext dispatch-layer overhead: protected vs. off decode steps (the
twin of the reference's ft_overhead benchmark).

Measures the per-step cost of routing every protected-site matmul through
the fault-aware dispatcher, across three representative families (dense /
MoE / SSM, at smoke size), for each dispatch mode:

  * ``off``: ftc=None, the plain-matmul path (baseline);
  * ``twopass``: engine.hyca_matmul (corrupt + DPPU overwrite), eager by
    rule (its engine validates the fault table on the host every call);
  * ``fused``: the CUDA ``ft_matmul`` / ``ft_matmul_batched`` kernels on a
    card (their plain versions on the CPU).

Each mode's step is :func:`repro_torch.launch.serve.make_decode`'s: a CUDA
graph on a card where one holds it (off, fused), eager otherwise.  The
fault table is swapped into the context in place, so a protected run and
its fault-free reference run the same graph, as the reference's traced
fault-table argument shares one compiled program.

Two record sets: ``results`` (whole-model overhead per family, with
``fused_speedup_x`` = twopass_ms / fused_ms) and ``site_results`` (one site
group protected at a time, keyed ``(arch, site)``).

Timing is min-of-repeats (each repeat resets the KV cache in place and
averages ``steps`` decode steps, ending in a device sync) with the repeats
of all modes round-robined (:func:`_time_interleaved`).

Claims: protected-mode steps produce logits bit-exact with the same step on
a fault-free array while faults <= capacity, for twopass, fused, and fused
with a RepairPlan; every overhead ratio is finite and positive.  The timing
claims (fused no slower than twopass within 5%; the dense family's fused
overhead <= 1.10x) are asserted in full mode only, as in the reference.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.bench.common import Claims, device_name, sync
from repro_torch.configs import get_smoke_config
from repro_torch.core.engine import HyCAConfig, empty_fault_state, fault_state_from_map, identity_plan
from repro_torch.core.ftcontext import ProtectPolicy, build_ftcontext
from repro_torch.core.redundancy import DPPUConfig
from repro_torch.launch.serve import make_decode
from repro_torch.models.lm import init_cache, init_params
from repro_torch.tree import tree_leaves

FAMILIES = ["qwen1.5-0.5b", "deepseek-moe-16b", "rwkv6-7b"]
ROWS = COLS = 8
DPPU = 8
N_FAULTS = 4

# Site groups for the per-site breakdown; only groups a family exercises
# are measured (protecting an absent site times the off path).
SITE_GROUPS: dict[str, tuple[str, ...]] = {
    "attention": ("attn.qkv", "attn.out"),
    "ffn": ("ffn",),
    "moe": ("moe.router", "moe.expert"),
    "ssm": ("ssm.in", "ssm.out"),
    "head": ("head",),
}
ARCH_GROUPS: dict[str, tuple[str, ...]] = {
    "qwen1.5-0.5b": ("attention", "ffn", "head"),
    "deepseek-moe-16b": ("attention", "ffn", "moe", "head"),
    "rwkv6-7b": ("ssm", "ffn", "head"),
}


class _Step:
    """One mode's decode step over its own KV cache, run with one fault
    table: the table is swapped into the context in place when it is not
    the one there, and the cache is reset in place, so the step (a CUDA
    graph on a card) keeps its addresses."""

    def __init__(self, cfg, ftc, state, n_slots: int, smax: int, device):
        self.fn, _ = make_decode(cfg, device, ftc=ftc)
        self.ftc, self.state = ftc, state
        self.cache = init_cache(cfg, n_slots, smax, device=device)
        self.fresh = [t.clone() for t in tree_leaves(self.cache)]

    def reset(self) -> None:
        for t, f in zip(tree_leaves(self.cache), self.fresh):
            t.copy_(f)

    def __call__(self, params, tok, state=None) -> torch.Tensor:
        """One step with ``state`` (default: the step's own table)."""
        state = self.state if state is None else state
        if self.ftc is not None and self.ftc.state is not state:
            self.ftc.swap(state=state)
        logits, _ = self.fn(params, self.cache, {"token": tok})
        return logits


def _time_interleaved(entries: dict[str, _Step], params, tok, *, steps: int, repeats: int,
                      device) -> dict[str, float]:
    """Min-of-repeats ms/step of each entry, the repeats round-robined
    across entries: every mode gets a sample in every window of the
    machine's speed, so drift divides out of the ratios."""
    for step in entries.values():  # capture (or first run) + warm-up
        step.reset()
        step(params, tok)
    sync(device)
    best = {name: float("inf") for name in entries}
    for _ in range(repeats):
        for name, step in entries.items():
            step.reset()
            step(params, tok)  # re-warm this window
            sync(device)
            t0 = time.perf_counter()
            for _ in range(steps):
                step(params, tok)
            sync(device)
            best[name] = min(best[name], (time.perf_counter() - t0) / steps * 1e3)
    return best


def _bit_exact(step: _Step, empty, params, tok) -> bool:
    """The step with its faults against the same step on a fault-free
    array, each from a fresh cache."""
    out = []
    for state in (step.state, empty):
        step.reset()
        out.append(step(params, tok, state).float())
    return bool(torch.equal(*out))


def _bench_arch(arch: str, *, n_slots: int, smax: int, steps: int, repeats: int, claims: Claims,
                timing_claims: bool, device) -> tuple[dict, list[dict]]:
    cfg = get_smoke_config(arch)
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    fmap = np.zeros((ROWS, COLS), bool)
    fmap.reshape(-1)[rng.choice(ROWS * COLS, size=N_FAULTS, replace=False)] = True
    state = fault_state_from_map(fmap, max_faults=N_FAULTS, rng=rng, device=device)
    empty = empty_fault_state(N_FAULTS, device=device)
    hyca = HyCAConfig(rows=ROWS, cols=COLS, dppu=DPPUConfig(size=DPPU, group_size=DPPU), mode="protected")
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (n_slots, 1)).astype(np.int32)).to(device)

    def entry(ftc):
        return _Step(cfg, ftc, state, n_slots, smax, device)

    entries = {"off": entry(None)}
    for name in ("twopass", "fused"):
        entries[name] = entry(build_ftcontext(state, hyca, dispatch=name))
    times = _time_interleaved(entries, params, tok, steps=steps, repeats=repeats, device=device)
    result: dict = {"arch": arch}
    for name, step in entries.items():
        result[f"{name}_ms_per_step"] = round(times[name], 3)
        if step.ftc is not None:
            claims.check(
                f"{arch}: {name} protected logits bit-exact with fault-free "
                f"run (faults <= capacity)",
                _bit_exact(step, empty, params, tok),
            )

    # fused + RepairPlan: the kernel's plan epilogue with the identity plan
    # (native mapping, nothing pruned) stays bit-exact with the fault-free run
    plan_step = entry(build_ftcontext(state, hyca, dispatch="fused",
                                      plan=identity_plan(ROWS, COLS, device=device)))
    claims.check(
        f"{arch}: fused+plan protected logits bit-exact with fault-free run "
        f"(identity plan, faults <= capacity)",
        _bit_exact(plan_step, empty, params, tok),
    )

    off_ms = max(result["off_ms_per_step"], 1e-9)
    for name in ("twopass", "fused"):
        result[f"{name}_overhead_x"] = round(result[f"{name}_ms_per_step"] / off_ms, 3)
        claims.check(
            f"{arch}: {name} overhead ratio finite and positive",
            0 < result[f"{name}_overhead_x"] < float("inf"),
            f"{result[f'{name}_overhead_x']}x",
        )
    result["fused_speedup_x"] = round(
        result["twopass_ms_per_step"] / max(result["fused_ms_per_step"], 1e-9), 3
    )
    if timing_claims:
        claims.check(
            f"{arch}: fused no slower than twopass (<= 5% tolerance)",
            result["fused_ms_per_step"] <= result["twopass_ms_per_step"] * 1.05,
            f"fused {result['fused_ms_per_step']} ms vs twopass "
            f"{result['twopass_ms_per_step']} ms",
        )

    # per-site breakdown: one site group protected at a time, all (group,
    # dispatch) pairs in one round-robin WITH its own off entry, so the
    # site rows' denominators come from the same block as their numerators
    site_entries: dict[str, _Step] = {"off": entries["off"]}
    for group in ARCH_GROUPS[arch]:
        policy = ProtectPolicy(sites=frozenset(SITE_GROUPS[group]))
        for name in ("twopass", "fused"):
            site_entries[f"{group}/{name}"] = entry(build_ftcontext(state, hyca, policy=policy, dispatch=name))
    site_times = _time_interleaved(site_entries, params, tok, steps=steps, repeats=repeats, device=device)
    site_off_ms = max(site_times["off"], 1e-9)
    site_rows: list[dict] = []
    for group in ARCH_GROUPS[arch]:
        row: dict = {"arch": arch, "site": group}
        for name in ("twopass", "fused"):
            ms = site_times[f"{group}/{name}"]
            row[f"{name}_ms_per_step"] = round(ms, 3)
            row[f"{name}_overhead_x"] = round(ms / site_off_ms, 3)
        row["fused_speedup_x"] = round(
            row["twopass_ms_per_step"] / max(row["fused_ms_per_step"], 1e-9), 3
        )
        site_rows.append(row)
    return result, site_rows


def run(quick: bool = False, device="cuda", families: tuple[str, ...] | None = None) -> dict:
    """``families``: the families to measure (default :data:`FAMILIES`, all
    three); the dense family's timing claim is checked when qwen is among
    them."""
    # full mode asserts the timing claims, so it buys noise robustness with
    # longer windows: 48-step windows x best-of-8
    steps = 8 if quick else 48
    repeats = 3 if quick else 8
    # batch 16 is the serving-representative decode batch
    n_slots = 4 if quick else 16
    claims = Claims("ft_overhead")
    per_arch: list[dict] = []
    per_site: list[dict] = []
    for a in families or FAMILIES:
        # KV capacity covers the warm-up and every timed step
        r, s = _bench_arch(a, n_slots=n_slots, smax=steps + 8, steps=steps, repeats=repeats,
                           claims=claims, timing_claims=not quick, device=device)
        per_arch.append(r)
        per_site.extend(s)
    dense = next((r for r in per_arch if r["arch"] == "qwen1.5-0.5b"), None)
    if not quick and dense is not None:
        claims.check(
            "qwen1.5-0.5b: fused overhead meets the <= 1.10x ROADMAP target",
            dense["fused_overhead_x"] <= 1.10,
            f"{dense['fused_overhead_x']}x",
        )
    return {
        "device": device_name(device),
        "steps": steps,
        "repeats": repeats,
        "n_slots": n_slots,
        "rows": ROWS, "cols": COLS, "dppu": DPPU, "n_faults": N_FAULTS,
        "results": per_arch,
        "site_results": per_site,
        "claims": claims.items,
        "all_ok": claims.all_ok,
    }
