"""Serving-layer goodput vs. fault rate: protected vs. unprotected (the
twin of the reference's serving_goodput benchmark).

The serving analogue of the paper's Fig. 10.  One fixed request trace is
served three ways on the same virtual array: fault-free reference (mode
``off``), HyCA-protected (faults confirmed at power-on, DPPU-repaired or
column-retired), and unprotected (faults corrupt freely), across a sweep of
fault counts (reported as PER = n / (rows·cols)).  Goodput counts only
tokens of completed requests that match the reference bit for bit.  The
trace, the nested fault sets and the stuck-bit draws are the reference's.

Expected shape:
  * protected goodput equals the reference while faults <= DPPU capacity
    (bit-exact serving) and degrades gracefully beyond it: admission
    capacity shrinks with the surviving column prefix, correctness holds;
  * unprotected goodput collapses as soon as a fault lands on a column a
    served matmul touches.

The protected curve, ``capacity``, ``surviving_cols`` and
``effective_slots`` depend on no float order.  Which unprotected tokens a
stuck bit corrupts can depend on the accumulation order of the bf16 step.
"""
from __future__ import annotations

import numpy as np

from repro_torch.bench.common import Claims, device_name
from repro_torch.serving import FaultInjector, FaultTolerantServer, ServerConfig

ROWS = COLS = 8
DPPU = 4  # capacity 4 on an 8x8 array


def _trace(rng: np.random.Generator, vocab: int, n_requests: int) -> list[dict]:
    return [
        {"step": int(i // 3), "prompt": rng.integers(0, vocab, size=5), "max_new_tokens": 6}
        for i in range(n_requests)
    ]


def _serve(mode: str, fault_coords: list[tuple[int, int]], trace: list[dict], seed: int, device="cuda"):
    # n_slots == ROWS so every PE row is mapped by the decode batch; stuck
    # bits are drawn from [20, 32): on the bf16 serving path bits below the
    # f32->bf16 rounding point are quantized away, so only the surviving
    # bits measure the unprotected risk
    cfg = ServerConfig(
        arch="qwen1.5-0.5b", n_slots=ROWS, smax=32, mode=mode,
        rows=ROWS, cols=COLS, dppu_size=DPPU, seed=seed, device=device,
    )
    inj = FaultInjector(ROWS, COLS, seed=seed + 1)
    srv = FaultTolerantServer(cfg, injector=inj)
    brng = np.random.default_rng(seed + 7)
    for r, c in fault_coords:
        inj.inject_at(r, c, bit=int(brng.integers(20, 32)), val=1)
    if mode == "protected":
        srv.manager.bist()
    summary = srv.run([dict(t) for t in trace], max_steps=400)
    return srv, summary


def run(quick: bool = False, device="cuda") -> dict:
    rng = np.random.default_rng(0)
    n_requests = 8 if quick else 12
    trace = _trace(rng, 512, n_requests)
    fault_counts = [0, 2, 4, 6, 8, 16] if quick else [0, 1, 2, 4, 5, 6, 8, 12, 16]

    # nested fault sets (prefixes of one permutation) so degradation is
    # monotone by construction, not by sampling luck
    cells = [(int(i) // COLS, int(i) % COLS) for i in rng.permutation(ROWS * COLS)]

    ref_srv, _ = _serve("off", [], trace, seed=0, device=device)
    reference = ref_srv.completions_by_rid()
    ref_good = ref_srv.metrics.goodput_tokens(reference)

    curve = {"per": [], "n_faults": [], "protected": [], "unprotected": [],
             "protected_per_step": [], "unprotected_per_step": [],
             "surviving_cols": [], "effective_slots": []}
    for n in fault_counts:
        coords = cells[:n]
        p_srv, p_sum = _serve("protected", coords, trace, seed=0, device=device)
        u_srv, u_sum = _serve("unprotected", coords, trace, seed=0, device=device)
        p_good = p_srv.metrics.goodput_tokens(reference)
        u_good = u_srv.metrics.goodput_tokens(reference)
        curve["per"].append(n / (ROWS * COLS))
        curve["n_faults"].append(n)
        curve["protected"].append(p_good)
        curve["unprotected"].append(u_good)
        curve["protected_per_step"].append(p_good / max(p_sum["steps"], 1))
        curve["unprotected_per_step"].append(u_good / max(u_sum["steps"], 1))
        curve["surviving_cols"].append(p_srv.manager.surviving_cols)
        curve["effective_slots"].append(p_sum["effective_slots_final"])

    c = Claims("serving_goodput")
    cap = ServerConfig(rows=ROWS, cols=COLS, dppu_size=DPPU).hyca().capacity
    within = [i for i, n in enumerate(fault_counts) if n <= cap]
    c.check(
        f"protected serving is bit-exact with the reference while faults <= capacity ({cap})",
        all(curve["protected"][i] == ref_good for i in within),
        f"protected={[curve['protected'][i] for i in within]} ref={ref_good}",
    )
    c.check(
        "protected goodput/step degrades monotonically past capacity (never crashes)",
        all(
            curve["protected_per_step"][i] >= curve["protected_per_step"][i + 1] - 1e-9
            for i in range(len(fault_counts) - 1)
        ),
        f"per_step={['%.2f' % v for v in curve['protected_per_step']]}",
    )
    c.check(
        "protected goodput >= unprotected goodput at every fault count",
        all(p >= u for p, u in zip(curve["protected"], curve["unprotected"])),
    )
    c.check(
        "unprotected goodput collapses at the highest fault count",
        curve["unprotected"][-1] < 0.5 * max(ref_good, 1),
        f"unprotected={curve['unprotected'][-1]} ref={ref_good}",
    )
    return {"reference_goodput": ref_good, "curve": curve, "capacity": cap,
            "device": device_name(device), "claims": c.items, "all_ok": c.all_ok}
