"""Fig. 10: fully-functional probability of RR/CR/DR/HyCA under random and
clustered fault models (the twin of the reference's fig10 benchmark).

Paper claims: HyCA outperforms all three; the advantage grows under the
clustered distribution; HyCA's FFP is distribution-insensitive and cliffs at
PER = DPPU_size / (rows·cols) = 3.13%.

Engines (``engine=``):
  * ``campaign`` (default): the batched FaultCampaign, one sampled batch per
    PER point shared by all schemes, all configs evaluated at once per
    scheme on ``device``; a per-point subsample is re-evaluated with the
    per-config NumPy reference and asserted bit-identical.
  * ``legacy``: the original ``reliability.sweep`` per-config loop.
"""
from __future__ import annotations

import numpy as np

from repro_torch.bench.common import Claims
from repro_torch.core import campaign as cp
from repro_torch.core.redundancy import DPPUConfig
from repro_torch.core.reliability import sweep

PERS = [0.005, 0.01, 0.02, 0.025, 0.03, 0.0313, 0.035, 0.04, 0.06]
SCHEMES = ("RR", "CR", "DR", "HyCA")


def _legacy_tables(n: int) -> tuple[dict, int]:
    out = {}
    for model in ("random", "clustered"):
        res = sweep(SCHEMES, PERS, fault_model=model, n_configs=n,
                    dppu=DPPUConfig(size=32))
        t: dict = {}
        for r in res:
            t.setdefault(r.scheme, {})[r.per] = r.fully_functional_prob
        out[model] = t
    iterations = len(SCHEMES) * len(PERS) * n * 2
    return out, iterations


def _campaign_tables(n: int, c: Claims, device) -> tuple[dict, dict, int]:
    out, ci = {}, {}
    iterations = 0
    parity_ok = True
    for model in ("random", "clustered"):
        spec = cp.CampaignSpec(
            rows=32, cols=32, fault_model=model, n_configs=n,
            schemes=SCHEMES, dppu=DPPUConfig(size=32),
        )
        run = cp.run_campaign(spec, PERS, device=device)
        iterations += run.python_iterations
        t: dict = {}
        w: dict = {}
        for r in run.results:
            t.setdefault(r.scheme, {})[r.per] = r.fully_functional_prob
            w.setdefault(r.scheme, {})[r.per] = r.ffp_ci95
        out[model], ci[model] = t, w
        # reference parity on a subsample of the SAME sampled point
        sub = min(n, 200)
        i_mid = len(PERS) // 2
        point = cp.sample_point(spec, PERS[i_mid], seed=cp.point_seed(spec.seed, i_mid))
        point.maps = point.maps[:sub]
        point.spare_faulty = {k: v[:sub] for k, v in point.spare_faulty.items()}
        point.hyca_caps = point.hyca_caps[:sub]
        sub_spec = cp.CampaignSpec(
            rows=32, cols=32, fault_model=model, n_configs=sub,
            schemes=SCHEMES, dppu=DPPUConfig(size=32),
        )
        vm = cp.evaluate_point(sub_spec, point, engine="vmapped", device=device)
        ref = cp.evaluate_point(sub_spec, point, engine="reference")
        parity_ok &= all(
            a.fully_functional_prob == b.fully_functional_prob
            and a.remaining_power == b.remaining_power
            for a, b in zip(vm, ref)
        )
    c.check(
        "vmapped campaign == per-config NumPy reference on identical samples "
        "(bit-identical FFP + remaining power, all schemes, both models)",
        parity_ok,
    )
    return out, ci, iterations


def run(quick: bool = False, engine: str = "campaign", device="cuda") -> dict:
    n = 300 if quick else 3000
    c = Claims("fig10")
    ci: dict = {}
    if engine == "campaign":
        out, ci, iterations = _campaign_tables(n, c, device)
        legacy_iterations = len(SCHEMES) * len(PERS) * n * 2
        c.check(
            "campaign engine: >= 10x fewer Python-level iterations than the "
            "legacy per-config loop",
            iterations * 10 <= legacy_iterations,
            f"{iterations} vs {legacy_iterations}",
        )
    elif engine == "legacy":
        out, _ = _legacy_tables(n)
    else:
        raise ValueError(f"unknown engine {engine!r}")

    def tol(model, scheme, per, base=0.02):
        # statistical slack: the campaign's own CI half-width when available
        return max(base, ci.get(model, {}).get(scheme, {}).get(per, 0.0))

    c.check(
        "HyCA FFP >= every classical scheme at every PER (both models)",
        all(
            out[m]["HyCA"][p] >= out[m][s][p] - tol(m, "HyCA", p)
            for m in out for s in ("RR", "CR", "DR") for p in PERS
        ),
    )
    c.check(
        "HyCA cliff: FFP high at PER 2.5% but ~0 at PER 4% (capacity 32/1024)",
        out["random"]["HyCA"][0.025] > 0.8 and out["random"]["HyCA"][0.04] < 0.12,
        f"ffp(2.5%)={out['random']['HyCA'][0.025]:.2f} ffp(4%)={out['random']['HyCA'][0.04]:.3f}",
    )
    # distribution insensitivity holds away from the capacity cliff (at the
    # cliff, FFP = P(#faults <= 32) and the *count* distributions differ)
    pre_cliff = [p for p in PERS if p <= 0.025]
    diff = max(abs(out["random"]["HyCA"][p] - out["clustered"]["HyCA"][p]) for p in pre_cliff)
    c.check(
        "HyCA is fault-distribution insensitive below the capacity cliff",
        diff < 0.1,
        f"max |diff| pre-cliff = {diff:.3f}",
    )

    def gap(model):
        return np.mean([
            out[model]["HyCA"][p]
            - np.mean([out[model][s][p] for s in ("RR", "CR", "DR")])
            for p in PERS[:5]
        ])
    c.check(
        "advantage over the classical schemes enlarges under clustered faults",
        gap("clustered") >= gap("random") - 0.02,
        f"mean gap random={gap('random'):.3f} clustered={gap('clustered'):.3f}",
    )
    return {"table": out, "ci95": ci, "engine": engine,
            "claims": c.items, "all_ok": c.all_ok}
