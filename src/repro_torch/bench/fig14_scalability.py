"""Fig. 14: FFP scalability across computing-array sizes (16×16 … 128×128)
under both fault models (the twin of the reference's fig14 benchmark).

Paper claims: RR/CR/DR FFP curves vary dramatically across array sizes (the
redundancy intensity changes), while HyCA (capacity = Col) shows consistent
fault-tolerance across sizes and distributions when compared at the same
expected-fault-per-capacity operating point.

``engine="campaign"`` (default): each (model, size) cell is one batched
FaultCampaign on ``device``: the per-config Python loop the legacy engine
paid (schemes × pers × n_configs iterations per cell) collapses into
schemes × pers batched evaluations.
"""
from __future__ import annotations


from repro_torch.bench.common import Claims
from repro_torch.core import campaign as cp
from repro_torch.core.redundancy import DPPUConfig
from repro_torch.core.reliability import evaluate_scheme


SIZES = [(16, 16), (32, 32), (64, 64)]
SIZES_FULL = SIZES + [(128, 128)]
PERS = [0.005, 0.01, 0.02, 0.03]
SCHEMES = ("RR", "CR", "DR", "HyCA")


def _cell_campaign(model: str, r_: int, c_: int, n: int, device) -> dict:
    spec = cp.CampaignSpec(rows=r_, cols=c_, fault_model=model, n_configs=n,
                           schemes=SCHEMES, dppu=DPPUConfig(size=c_))
    run_ = cp.run_campaign(spec, PERS, device=device)
    t: dict = {}
    for res in run_.results:
        t.setdefault(res.scheme, {})[res.per] = res.fully_functional_prob
    return t


def _cell_legacy(model: str, r_: int, c_: int, n: int, device=None) -> dict:
    t: dict = {}
    for s in SCHEMES:
        for p in PERS:
            res = evaluate_scheme(
                s, p, rows=r_, cols=c_, fault_model=model, n_configs=n,
                dppu=DPPUConfig(size=c_),
            )
            t.setdefault(s, {})[p] = res.fully_functional_prob
    return t


def run(quick: bool = False, engine: str = "campaign", device="cuda") -> dict:
    n = 200 if quick else 1500
    sizes = SIZES if quick else SIZES_FULL
    cell = _cell_campaign if engine == "campaign" else _cell_legacy
    out = {}
    for model in ("random", "clustered"):
        for (r_, c_) in sizes:
            out.setdefault(model, {})[f"{r_}x{c_}"] = cell(model, r_, c_, n, device)

    c = Claims("fig14")
    # classical schemes: spread of FFP across sizes at PER=1% is large
    def spread(scheme, model):
        vals = [out[model][f"{r}x{cc}"][scheme][0.01] for (r, cc) in sizes]
        return max(vals) - min(vals)
    c.check(
        "classical schemes' FFP varies strongly with array size (spread > 0.25 @1%)",
        max(spread(s, "random") for s in ("RR", "CR", "DR")) > 0.25,
        ", ".join(f"{s}:{spread(s,'random'):.2f}" for s in ("RR", "CR", "DR")),
    )
    # HyCA: at the matched operating point per = capacity/(rows*cols) * 0.5
    hy = []
    for (r_, c_) in sizes:
        p_half = 0.5 * c_ / (r_ * c_)
        if engine == "campaign":
            spec = cp.CampaignSpec(rows=r_, cols=c_, n_configs=n,
                                   schemes=("HyCA",), dppu=DPPUConfig(size=c_))
            hy.append(cp.run_campaign(spec, [p_half], device=device).results[0].fully_functional_prob)
        else:
            res = evaluate_scheme("HyCA", p_half, rows=r_, cols=c_, n_configs=n,
                                  dppu=DPPUConfig(size=c_))
            hy.append(res.fully_functional_prob)
    c.check(
        "HyCA consistent across sizes at matched load (FFP ~1 at 50% capacity)",
        min(hy) > 0.9,
        " ".join(f"{v:.2f}" for v in hy),
    )
    # away from each size's capacity cliff (cliff PER = cols/(rows·cols));
    # at the cliff FFP = P(#faults <= capacity) and the clustered model's
    # heavier count tails differ by construction
    def off_cliff(r_, c_, p):
        cliff = c_ / (r_ * c_)
        return p < 0.7 * cliff or p > 1.5 * cliff
    c.check(
        "HyCA insensitive to the fault model at every size (off-cliff PERs)",
        all(
            abs(out["random"][f"{r}x{cc}"]["HyCA"][p] - out["clustered"][f"{r}x{cc}"]["HyCA"][p]) < 0.12
            for (r, cc) in sizes for p in PERS if off_cliff(r, cc, p)
        ),
    )
    return {"table": out, "hyca_matched_load_ffp": hy, "engine": engine,
            "claims": c.items, "all_ok": c.all_ok}
