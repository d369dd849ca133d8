"""FaultCampaign: the batched Monte-Carlo fault-injection engine (paper Sec. V).

The paper's evidence is statistical: FFP and remaining-computing-power curves
over thousands of sampled fault configurations (Figs. 3, 10, 11, 14), and
accuracy-vs-PER collapse over sampled fault maps (Fig. 2).  The legacy
``reliability.evaluate_scheme`` walks those configurations one at a time in a
Python loop; this module evaluates a whole operating point at once:

  * fault maps are sampled as a batch, either with the NumPy reference
    streams on the host (bit-identical to the legacy loop) or on the device
    with an explicit ``torch.Generator`` (``sampler="device"``, the fast path
    for large campaigns; held statistically, since torch cannot replay JAX's
    threefry streams);
  * repair outcomes of all four schemes (RR / CR / DR / HyCA) are batched
    torch ops over the config axis on the device, DR's bipartite
    fault-to-spare matching included, reformulated as an incremental
    union-find feasibility scan (:func:`_dr_eval`) whose host loop runs over
    the ``n + 1`` fault steps, never over configs;
  * batched :class:`~repro_torch.core.engine.FaultState` tables (leading
    config axis) drive protected / unprotected forward passes through
    :func:`~repro_torch.core.engine.hyca_matmul_batched`, so accuracy
    campaigns (Fig. 2) never loop over fault configurations;
  * summaries carry binomial confidence intervals, which double as the
    tolerance of the golden-stats tests.

Seed plumbing is explicit and shared by construction: one
:class:`CampaignPoint` holds the fault maps every scheme is evaluated on.

DR feasibility (why the union-find scan is exact): a fault at (r, c) can be
repaired by diagonal spare r or spare c, an edge {r, c} in a multigraph whose
vertices are the *working* spares (a fault next to a dead spare degenerates
to a self-loop on the surviving endpoint).  A fault set is fully matchable
iff every connected component has #edges <= #vertices (the
transversal-matroid / bicircular independence criterion).  The legacy greedy
processes faults in column order and drops a fault iff its prefix just became
infeasible, so the first infeasible prefix is exactly the legacy first
unmatched fault, and its column bounds the surviving prefix.  A feasible
prefix has at most ``n_spares`` edges, so scanning the first
``n_spares + 1`` column-ordered faults decides both outcomes.

Entry points that make or move tensors take ``device="cuda"`` and raise
without CUDA unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import fault_models as fm
from repro_torch.core import redundancy as red
from repro_torch.core.engine import FaultState, RepairPlan, empty_fault_state, identity_plan
from repro_torch.core.reliability import point_seed  # shared seed derivation (re-export)

__all__ = [
    "ChaosSpec",
    "CampaignSpec",
    "CampaignPoint",
    "CampaignResult",
    "CampaignRun",
    "batched_fault_states",
    "batched_repair_plans",
    "batched_single_fault_states",
    "apply_chaos",
    "chaos_maps",
    "chaos_signatures",
    "identity_plans",
    "binomial_halfwidth",
    "device_clustered_maps",
    "device_dppu_capacity",
    "device_random_maps",
    "evaluate_batched",
    "evaluate_point",
    "evaluate_reference",
    "mean_halfwidth",
    "point_seed",
    "run_campaign",
    "sample_point",
    "summarize_accuracy",
    "take_config",
]


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; asking for CUDA where there is none
    raises: the campaign never falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the campaign on the CPU"
        )
    return dev


# --------------------------------------------------------------------------- #
# statistics
# --------------------------------------------------------------------------- #
Z95 = 1.959963984540054  # two-sided 95% normal quantile


def binomial_halfwidth(p_hat: float, n: int, *, z: float = Z95) -> float:
    """Wald binomial CI half-width for an empirical proportion, floored at
    z/(2n) so a degenerate 0/1 estimate still reports the resolution limit
    of the sample size."""
    if n <= 0:
        return 1.0
    w = z * math.sqrt(max(p_hat * (1.0 - p_hat), 0.0) / n)
    return max(w, z / (2.0 * n))


def mean_halfwidth(samples: np.ndarray, *, z: float = Z95) -> float:
    """Normal-approximation CI half-width for the mean of bounded samples."""
    s = np.asarray(samples, np.float64)
    if s.size <= 1:
        return 1.0
    return float(z * s.std(ddof=1) / math.sqrt(s.size))


def summarize_accuracy(acc: np.ndarray) -> dict:
    """Per-config accuracy vector -> mean ± CI and campaign quantiles."""
    a = np.asarray(acc, np.float64)
    return {
        "mean": float(a.mean()),
        "ci95": mean_halfwidth(a),
        "q10": float(np.quantile(a, 0.10)),
        "q50": float(np.quantile(a, 0.50)),
        "q90": float(np.quantile(a, 0.90)),
        "min": float(a.min()),
        "max": float(a.max()),
    }


# --------------------------------------------------------------------------- #
# campaign specification + sampling (shared by construction)
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class CampaignSpec:
    rows: int = 32
    cols: int = 32
    fault_model: str = "random"          # random | clustered
    n_configs: int = 2000
    schemes: tuple[str, ...] = red.SCHEMES
    dppu: red.DPPUConfig | None = None   # HyCA DPPU (default: size=cols)
    seed: int = 0
    sampler: str = "numpy"               # numpy (legacy-aligned) | device
    # remediation applied to the HyCA scheme's degradation model: "none"
    # keeps the paper's column-prefix discard; "remap" prunes one
    # least-salient residue class per unrepairable column instead, so
    # remaining computing power is cols - #broken columns.  FFP is unchanged
    # (remap adds no repair capacity).
    repair: str = "none"

    def dppu_cfg(self) -> red.DPPUConfig:
        return self.dppu or red.DPPUConfig(size=self.cols)

    def __post_init__(self):
        if self.repair not in ("none", "remap"):
            raise ValueError(f"unknown repair mode {self.repair!r}")


@dataclasses.dataclass
class CampaignPoint:
    """One PER operating point: the fault maps shared by EVERY scheme plus the
    per-scheme auxiliary draws (spare health / DPPU lane capacity).  Host
    numpy arrays from the numpy sampler, tensors on the device from the
    device sampler."""

    per: float
    maps: np.ndarray | torch.Tensor                     # (n, rows, cols) bool
    spare_faulty: dict[str, np.ndarray | torch.Tensor]  # scheme -> (n, n_spares) bool
    hyca_caps: np.ndarray | torch.Tensor | None         # (n,) int, None if HyCA not in play


@dataclasses.dataclass(frozen=True)
class CampaignResult:
    scheme: str
    per: float
    fault_model: str
    n_configs: int
    fully_functional_prob: float
    ffp_ci95: float
    remaining_power: float
    remaining_power_ci95: float
    repair: str = "none"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class CampaignRun:
    spec: CampaignSpec
    results: list[CampaignResult]
    python_iterations: int  # host-loop trips (legacy: schemes*pers*n_configs)

    def table(self) -> dict[str, dict[float, float]]:
        out: dict[str, dict[float, float]] = {}
        for r in self.results:
            out.setdefault(r.scheme, {})[r.per] = r.fully_functional_prob
        return out

    def get(self, scheme: str, per: float) -> CampaignResult:
        for r in self.results:
            if r.scheme == scheme and r.per == per:
                return r
        raise KeyError((scheme, per))


def _numpy_point(spec: CampaignSpec, per: float, seed: int) -> CampaignPoint:
    """Legacy-aligned NumPy sampling: replay the exact ``evaluate_scheme``
    stream (fresh ``default_rng(seed)``, maps first, then the scheme's
    auxiliary draws), so campaign results are bit-identical to the
    per-config loop at the same seed.  The maps are sampled ONCE; each
    scheme's aux stream restarts from a snapshot of the post-maps state."""
    rng = np.random.default_rng(seed)
    maps = fm.sample_fault_maps(
        rng, spec.n_configs, spec.rows, spec.cols, per, spec.fault_model  # type: ignore[arg-type]
    )
    state_after_maps = rng.bit_generator.state
    spare: dict[str, np.ndarray] = {}
    caps: np.ndarray | None = None
    for scheme in spec.schemes:
        g = np.random.default_rng(seed)
        g.bit_generator.state = state_after_maps
        if scheme == "HyCA":
            cfg = spec.dppu_cfg()
            lane = red.dppu_capacity(g, cfg, per, spec.n_configs)
            caps = np.minimum(lane, red.effective_capacity(cfg, spec.cols))
        else:
            n_sp = red.n_spares(scheme, spec.rows, spec.cols)
            spare[scheme] = g.random((spec.n_configs, n_sp)) < per
    return CampaignPoint(per=per, maps=maps, spare_faulty=spare, hyca_caps=caps)


def _generator(seed: int, device: torch.device) -> torch.Generator:
    """The explicit generator of one device draw."""
    return torch.Generator(device=device).manual_seed(int(seed))


def _role_seed(seed: int, role: int) -> int:
    """Per-role seed of one operating point's device draws (the counterpart
    of the reference's ``fold_in``): maps take role 0, scheme ``i`` role
    ``i + 1``."""
    return (seed * 1_000_003 + role) % (1 << 63)


def _device_point(spec: CampaignSpec, per: float, seed: int, device) -> CampaignPoint:
    """On-device sampling: one generator per role, so the maps are drawn
    once and shared across schemes by construction."""
    dev = resolve_device(device)
    kmaps = _role_seed(seed, 0)
    if spec.fault_model == "random":
        maps = device_random_maps(kmaps, spec.n_configs, spec.rows, spec.cols, per, device=dev)
    elif spec.fault_model == "clustered":
        maps = device_clustered_maps(kmaps, spec.n_configs, spec.rows, spec.cols, per, device=dev)
    else:
        raise ValueError(f"unknown fault model {spec.fault_model!r}")
    spare: dict[str, torch.Tensor] = {}
    caps: torch.Tensor | None = None
    for i, scheme in enumerate(spec.schemes):
        ks = _role_seed(seed, i + 1)
        if scheme == "HyCA":
            cfg = spec.dppu_cfg()
            lane = device_dppu_capacity(ks, cfg, per, spec.n_configs, device=dev)
            caps = torch.clamp(lane, max=red.effective_capacity(cfg, spec.cols))
        else:
            n_sp = red.n_spares(scheme, spec.rows, spec.cols)
            g = _generator(ks, dev)
            spare[scheme] = torch.rand((spec.n_configs, n_sp), generator=g, device=dev) < per
    return CampaignPoint(per=per, maps=maps, spare_faulty=spare, hyca_caps=caps)


def sample_point(spec: CampaignSpec, per: float, *, seed: int | None = None, device="cuda") -> CampaignPoint:
    """Sample one operating point's fault maps + per-scheme auxiliaries.  The
    numpy sampler stays on the host and ignores ``device``; the device
    sampler draws on ``device``."""
    s = spec.seed if seed is None else seed
    if spec.sampler == "numpy":
        return _numpy_point(spec, per, s)
    if spec.sampler == "device":
        return _device_point(spec, per, s, device)
    raise ValueError(f"unknown sampler {spec.sampler!r}")


# --------------------------------------------------------------------------- #
# device samplers (the fast path for large campaigns)
# --------------------------------------------------------------------------- #
def device_random_maps(seed: int, n: int, rows: int, cols: int, per: float,
                       *, device="cuda") -> torch.Tensor:
    """(n, rows, cols) i.i.d. Bernoulli(per) fault maps, sampled on device."""
    dev = resolve_device(device)
    g = _generator(seed, dev)
    return torch.rand((n, rows, cols), generator=g, device=dev) < per


def device_clustered_maps(
    seed: int,
    n: int,
    rows: int,
    cols: int,
    per: float,
    cluster_size_mean: float = 4.0,
    cluster_sigma: float = 1.5,
    *,
    max_clusters: int = 64,
    max_satellites: int = 16,
    device="cuda",
) -> torch.Tensor:
    """Device Meyer–Pradhan-style clustered maps (``fm.clustered_fault_maps``'
    semantics with static loop bounds): the per-map fault COUNT is exactly
    Binomial(rows*cols, per), the property that makes HyCA's FFP
    distribution-insensitive, while placement is cluster-wise (geometric
    cluster sizes, Gaussian satellite offsets clipped in bounds), topped up
    with uniform-without-replacement fills.  All ``n`` maps advance together:
    the host loop runs over the ``max_clusters`` clusters, never over maps."""
    dev = resolve_device(device)
    g = _generator(seed, dev)
    size_p = 1.0 / max(cluster_size_mean, 1.0)
    log_q = math.log1p(-size_p) if size_p < 1.0 else -math.inf  # geometric(size_p) by inversion
    rc = rows * cols
    target = (torch.rand((n, rc), generator=g, device=dev) < per).sum(dim=1)
    hits = torch.zeros((n, rc), dtype=torch.int32, device=dev)
    placed = torch.zeros(n, dtype=torch.long, device=dev)
    sat = torch.arange(max_satellites, device=dev)
    for _ in range(max_clusters):
        cr = torch.rand(n, generator=g, device=dev) * rows
        cc = torch.rand(n, generator=g, device=dev) * cols
        u = torch.rand(n, generator=g, device=dev)
        geo = torch.floor(torch.log1p(-u) / log_q).long() + 1
        size = torch.minimum(torch.clamp(geo, max=max_satellites), target - placed)
        off = torch.randn((n, 2, max_satellites), generator=g, device=dev) * cluster_sigma
        rr = torch.clamp(torch.round(cr[:, None] + off[:, 0]), 0, rows - 1).long()
        cc2 = torch.clamp(torch.round(cc[:, None] + off[:, 1]), 0, cols - 1).long()
        sel = (sat[None, :] < size[:, None]).to(torch.int32)
        # an add of counts, not an overwriting scatter: satellites that land
        # on one cell are duplicates, and adds of ints commute
        hits.scatter_add_(1, rr * cols + cc2, sel)
        placed = (hits > 0).sum(dim=1)
    m = hits > 0
    # top-up: uniform without replacement over the healthy cells
    pri = torch.rand((n, rc), generator=g, device=dev)
    pri = torch.where(m, torch.full_like(pri, math.inf), pri)
    rank = torch.argsort(torch.argsort(pri, dim=1), dim=1)
    fill = rank < (target - placed)[:, None]
    return (m | fill).reshape(n, rows, cols)


def device_dppu_capacity(seed: int, cfg: red.DPPUConfig, per: float, n: int,
                         *, device="cuda") -> torch.Tensor:
    """Device mirror of :func:`repro_torch.core.redundancy.dppu_capacity`: a
    redundancy subgroup survives iff at most one member is faulty; an
    unhealthy group contributes zero lanes.  (n,) int32."""
    dev = resolve_device(device)
    g = _generator(seed, dev)
    mult_sub = -(-cfg.group_size // cfg.mult_red_group)
    add_units = max(cfg.group_size - 1, 1)
    add_sub = -(-add_units // cfg.adder_red_group)
    m_faults = torch.rand((n, cfg.n_groups, mult_sub, cfg.mult_red_group + 1), generator=g, device=dev) < per
    a_faults = torch.rand((n, cfg.n_groups, add_sub, cfg.adder_red_group + 1), generator=g, device=dev) < per
    m_ok = (m_faults.sum(-1) <= 1).all(-1)
    a_ok = (a_faults.sum(-1) <= 1).all(-1)
    return ((m_ok & a_ok).sum(-1) * cfg.group_size).to(torch.int32)


# --------------------------------------------------------------------------- #
# batched scheme evaluation: torch ops over the config axis
# --------------------------------------------------------------------------- #
def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 where there is none):
    ``jnp.argmax`` of a bool.  torch's argmax takes no bool, so cast first;
    its tie rule, the first maximum, is jnp's."""
    return torch.argmax(mask.to(torch.uint8), dim=-1).to(torch.int32)


def _finish(ff: torch.Tensor, first: torch.Tensor, cols: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(ff, surviving columns): all ``cols`` where fully functional."""
    first = first.to(torch.int32)
    return ff, torch.where(ff, torch.full_like(first, cols), first)


def _rr_eval(maps: torch.Tensor, spare_faulty: torch.Tensor, *, cols: int):
    per_row = maps.sum(dim=2)
    repaired_rows = (per_row == 1) & ~spare_faulty
    ff = ((per_row == 0) | repaired_rows).all(dim=1)
    unrepaired = maps & ~repaired_rows[:, :, None]
    return _finish(ff, _first_true(unrepaired.any(dim=1)), cols)


def _cr_eval(maps: torch.Tensor, spare_faulty: torch.Tensor, *, cols: int):
    per_col = maps.sum(dim=1)
    repairable = (per_col == 0) | ((per_col == 1) & ~spare_faulty)
    return _finish(repairable.all(dim=1), _first_true(~repairable), cols)


def _hyca_eval(maps: torch.Tensor, capacity: torch.Tensor, *, cols: int, repair: str = "none"):
    counts = maps.sum(dim=1).to(torch.int32)
    cap = capacity.to(torch.int32)[:, None]
    ff = counts.sum(dim=1) <= cap[:, 0]
    csum = torch.cumsum(counts, dim=1)
    if repair == "remap":
        # a column holds an unrepaired fault iff its trailing fault overflows
        # capacity (leftmost-first priority); each such column costs ONE
        # pruned residue class instead of the whole suffix
        broken = (csum > cap) & (counts > 0)
        return _finish(ff, cols - broken.sum(dim=1), cols)
    # first column whose cumulative fault count exceeds capacity: the
    # (capacity)-th leftmost fault's column (Section IV-B repair priority)
    return _finish(ff, _first_true(csum >= cap + 1), cols)


def _ordered_sub_faults(sub: torch.Tensor, k: int):
    """First ``k`` faults of each sub-array in leftmost-first (col, then row)
    order, the legacy greedy matcher's processing order; a sentinel key
    sorts the healthy cells last."""
    b, nr, nc = sub.shape
    r = torch.arange(nr, device=sub.device)[:, None]
    c = torch.arange(nc, device=sub.device)[None, :]
    sentinel = nr * nc
    key = torch.where(sub, c * nr + r, torch.full_like(c * nr + r, sentinel)).reshape(b, -1)  # flat idx is row-major
    order = torch.argsort(key, dim=1, stable=True)[:, :k]
    valid = key.gather(1, order) < sentinel
    zero = torch.zeros_like(order)
    return torch.where(valid, order // nc, zero), torch.where(valid, order % nc, zero), valid


def _dr_sub_feasibility(fr, fc, valid, spare_ok, *, n_spares: int, cols: int, col_offset: int):
    """Incremental union-find feasibility over the column-ordered faults of
    one square(ish) sub-array, for every config at once: (B, n_spares)
    parent / size / verts / edges arrays; ``find`` is exactly ``find_iters``
    gathers, with no path compression; union by size.  The host loops over
    the fault steps.  Returns (infeasible, first_bad_global_col)."""
    b, k = fr.shape
    dev = fr.device
    find_iters = int(math.ceil(math.log2(max(n_spares, 2)))) + 2
    parent = torch.arange(n_spares, device=dev).repeat(b, 1)
    size = torch.ones((b, n_spares), dtype=torch.int32, device=dev)
    verts = spare_ok.to(torch.int32)
    edges = torch.zeros((b, n_spares), dtype=torch.int32, device=dev)
    bad = torch.zeros(b, dtype=torch.bool, device=dev)
    bad_col = torch.full((b,), cols, dtype=torch.int32, device=dev)

    def at(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        return a.gather(1, i[:, None])[:, 0]

    def find(v: torch.Tensor) -> torch.Tensor:
        for _ in range(find_iters):
            v = at(parent, v)
        return v

    def add_at(a: torch.Tensor, i: torch.Tensor, v: torch.Tensor) -> None:
        # one index per row: no duplicate writers
        a.scatter_add_(1, i[:, None], v.to(a.dtype)[:, None])

    zero = torch.zeros(b, dtype=torch.int32, device=dev)
    for t in range(k):
        r, c, ok = fr[:, t], fc[:, t], valid[:, t]
        r_ok, c_ok = at(spare_ok, r), at(spare_ok, c)
        usable = r_ok | c_ok
        a = torch.where(r_ok, r, c)   # surviving endpoint(s): both usable ->
        bb = torch.where(c_ok, c, r)  # edge {r, c}; one usable -> self-loop
        ra, rb = find(a), find(bb)
        swap = at(size, rb) > at(size, ra)
        hi = torch.where(swap, rb, ra)
        lo = torch.where(swap, ra, rb)
        do_union = ok & usable & (ra != rb)
        parent.scatter_(1, lo[:, None], torch.where(do_union, hi, at(parent, lo))[:, None])
        add_at(size, hi, torch.where(do_union, at(size, lo), zero))
        add_at(verts, hi, torch.where(do_union, at(verts, lo), zero))
        add_at(edges, hi, torch.where(do_union, at(edges, lo), zero))
        root = torch.where(do_union, hi, ra)
        add_edge = ok & usable
        add_at(edges, root, add_edge)
        over = at(edges, root) > at(verts, root)  # component carries >1 cycle
        newly_bad = ok & (~usable | (add_edge & over))
        first = newly_bad & ~bad
        bad_col = torch.where(first, (col_offset + c).to(torch.int32), bad_col)
        bad = bad | newly_bad
    return bad, bad_col


def _dr_eval(maps: torch.Tensor, spare_faulty: torch.Tensor, *, rows: int, cols: int):
    b = maps.shape[0]
    n = min(rows, cols)
    n_sub = -(-max(rows, cols) // n)
    bad_any = torch.zeros(b, dtype=torch.bool, device=maps.device)
    first_col = torch.full((b,), cols, dtype=torch.int32, device=maps.device)
    for s in range(n_sub):
        if rows >= cols:
            sub = maps[:, s * n : (s + 1) * n, :]
            col_offset = 0
        else:
            sub = maps[:, :, s * n : (s + 1) * n]
            col_offset = s * n
        spare_ok = ~spare_faulty[:, s * n : (s + 1) * n]
        k = min(n + 1, sub.shape[1] * sub.shape[2])
        fr, fc, valid = _ordered_sub_faults(sub, k)
        bad, bad_col = _dr_sub_feasibility(fr, fc, valid, spare_ok, n_spares=n, cols=cols, col_offset=col_offset)
        bad_any = bad_any | bad
        first_col = torch.minimum(first_col, torch.where(bad, bad_col, torch.full_like(bad_col, cols)))
    return _finish(~bad_any, first_col, cols)


def evaluate_batched(maps, aux, *, scheme: str, repair: str = "none") -> tuple[torch.Tensor, torch.Tensor]:
    """Batched repair outcome: (ff bool, surviving_columns int32) per config,
    on the maps' device.

    ``maps``: (n, rows, cols) bool tensor; ``aux``: (n, n_spares) spare
    health for RR/CR/DR, (n,) DPPU capacities for HyCA.  ``repair``:
    HyCA-only remediation mode ("none" | "remap", see :class:`CampaignSpec`).
    """
    maps = torch.as_tensor(maps)
    aux = torch.as_tensor(aux).to(maps.device)
    rows, cols = maps.shape[-2], maps.shape[-1]
    if scheme == "RR":
        return _rr_eval(maps, aux, cols=cols)
    if scheme == "CR":
        return _cr_eval(maps, aux, cols=cols)
    if scheme == "DR":
        return _dr_eval(maps, aux, rows=rows, cols=cols)
    if scheme == "HyCA":
        return _hyca_eval(maps, aux, cols=cols, repair=repair)
    raise ValueError(f"unknown scheme {scheme!r}")


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def evaluate_reference(point: CampaignPoint, scheme: str, repair: str = "none"):
    """The per-config NumPy loop over the SAME sampled batch, the
    asserted-identical reference for the batched path.  Returns (ff, surv)
    NumPy arrays."""
    maps = _host(point.maps)
    n = maps.shape[0]
    ff = np.zeros(n, bool)
    surv = np.zeros(n, np.int64)
    if scheme == "HyCA":
        assert point.hyca_caps is not None
        caps = _host(point.hyca_caps)
        fn = red.hyca_remap_repair if repair == "remap" else red.hyca_repair
        for i in range(n):
            ff[i], surv[i] = fn(maps[i], int(caps[i]))
    else:
        spare = _host(point.spare_faulty[scheme])
        for i in range(n):
            ff[i], surv[i] = red.repair(scheme, maps[i], spare_faulty=spare[i])
    return ff, surv


def evaluate_point(
    spec: CampaignSpec, point: CampaignPoint, *, engine: str = "vmapped", device="cuda"
) -> list[CampaignResult]:
    """Evaluate every scheme of ``spec`` on one sampled point.  ``engine``:
    ``vmapped`` (batched torch ops over the config axis on ``device``; the
    maps go there once) or ``reference`` (the legacy per-config NumPy loop
    on identical samples, on the host)."""
    if engine not in ("vmapped", "reference"):
        raise ValueError(f"unknown engine {engine!r}")
    dev = resolve_device(device) if engine == "vmapped" else None
    maps_dev = torch.as_tensor(point.maps).to(dev) if dev is not None else None
    out = []
    for scheme in spec.schemes:
        repair = spec.repair if scheme == "HyCA" else "none"
        if dev is not None:
            aux = point.hyca_caps if scheme == "HyCA" else point.spare_faulty[scheme]
            aux = torch.as_tensor(aux).to(dev)
            ff_d, surv_d = evaluate_batched(maps_dev, aux, scheme=scheme, repair=repair)
            ff, surv = ff_d.cpu().numpy(), surv_d.cpu().numpy()
        else:
            ff, surv = evaluate_reference(point, scheme, repair)
        n = spec.n_configs
        ffp = float(ff.mean())
        out.append(CampaignResult(
            scheme=scheme,
            per=point.per,
            fault_model=spec.fault_model,
            n_configs=n,
            fully_functional_prob=ffp,
            ffp_ci95=binomial_halfwidth(ffp, n),
            remaining_power=float(surv.mean() / spec.cols),
            remaining_power_ci95=mean_halfwidth(surv / spec.cols),
            repair=repair,
        ))
    return out


def run_campaign(
    spec: CampaignSpec, pers: Sequence[float], *, engine: str = "vmapped", device="cuda"
) -> CampaignRun:
    """Sweep a PER grid: one sampled point per PER (maps shared across all
    schemes by construction), all configs evaluated at once per scheme.
    Host-level Python iterations = len(pers) · len(schemes); the legacy loop
    paid an extra ×n_configs."""
    if engine == "vmapped" or spec.sampler == "device":
        resolve_device(device)
    results: list[CampaignResult] = []
    iterations = 0
    for i, per in enumerate(pers):
        point = sample_point(spec, float(per), seed=point_seed(spec.seed, i), device=device)
        results.extend(evaluate_point(spec, point, engine=engine, device=device))
        iterations += len(spec.schemes)
    return CampaignRun(spec=spec, results=results, python_iterations=iterations)


# --------------------------------------------------------------------------- #
# batched FaultStates: accuracy campaigns over hyca_matmul_batched
# --------------------------------------------------------------------------- #
def batched_fault_states(
    maps: np.ndarray, *, max_faults: int | None = None, seed: int = 0, device="cuda"
) -> FaultState:
    """(n, rows, cols) fault maps -> ONE FaultState whose leaves carry a
    leading config axis, ready for
    :func:`~repro_torch.core.engine.hyca_matmul_batched`.  Entries are
    leftmost-sorted per config (the Section IV-B repair priority, as
    ``fault_state_from_map``); stuck-at signatures are drawn per PE with the
    reference's numpy calls, then merged on the device in one batched merge.
    ``max_faults`` is a campaign-wide bound (default rows*cols, which can
    never truncate)."""
    dev = resolve_device(device)
    maps = np.asarray(maps, bool)
    n, rows, cols = maps.shape
    m = max_faults or rows * cols
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 32, size=(n, rows, cols)).astype(np.int32)
    vals = rng.integers(0, 2, size=(n, rows, cols)).astype(np.int32)
    empty = empty_fault_state(m, device=dev)
    states = FaultState(empty.fpt.expand(n, m, 2), empty.stuck_bit.expand(n, m), empty.stuck_val.expand(n, m))
    return states.merge_batched(
        torch.from_numpy(maps).to(dev),
        stuck_bit=torch.from_numpy(bits).to(dev),
        stuck_val=torch.from_numpy(vals).to(dev),
    )


def take_config(states: FaultState, i: int) -> FaultState:
    """Slice one config's FaultState out of a batched (leading-axis) state."""
    return FaultState(states.fpt[i], states.stuck_bit[i], states.stuck_val[i])


def batched_single_fault_states(
    rng: np.random.Generator,
    n: int,
    rows: int,
    cols: int,
    *,
    max_faults: int = 1,
    acc_bits: int = 32,
    device="cuda",
) -> tuple[FaultState, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``n`` single-fault configs: one uniformly placed stuck-at fault each,
    as a batched FaultState (leading config axis, ``max_faults`` slots so it
    composes with same-shaped multi-fault tables) PLUS the host ground-truth
    draws ``(r, c, bit, val)``."""
    dev = resolve_device(device)
    r = rng.integers(0, rows, size=n).astype(np.int32)
    c = rng.integers(0, cols, size=n).astype(np.int32)
    bit = rng.integers(0, acc_bits, size=n).astype(np.int32)
    val = rng.integers(0, 2, size=n).astype(np.int32)
    fpt = np.full((n, max_faults, 2), -1, np.int32)
    fpt[:, 0, 0], fpt[:, 0, 1] = r, c
    bits = np.zeros((n, max_faults), np.int32)
    vals = np.zeros((n, max_faults), np.int32)
    bits[:, 0], vals[:, 0] = bit, val
    states = FaultState(*(torch.from_numpy(a).to(dev) for a in (fpt, bits, vals)))
    return states, r, c, bit, val


def batched_repair_plans(
    states: FaultState,
    salience,
    *,
    rows: int,
    cols: int,
    capacity: int,
    prune: bool = True,
    device="cuda",
) -> RepairPlan:
    """One remap :class:`~repro_torch.core.engine.RepairPlan` per campaign
    config, all built by the same batched tensor ops on ``device``.

    ``states``: batched FaultState (:func:`batched_fault_states`);
    ``salience``: (cols,) per-residue-class salience shared by every config.
    The result's leaves carry the leading config axis: feed them with the
    batched states to :func:`~repro_torch.core.engine.hyca_matmul_batched`."""
    from repro_torch.repair.plan import remap_plan_device

    dev = resolve_device(device)
    return remap_plan_device(
        states.fpt.to(dev), torch.as_tensor(salience).to(dev),
        rows=rows, cols=cols, capacity=capacity, prune=prune,
    )


def identity_plans(n: int, rows: int, cols: int, *, device="cuda") -> RepairPlan:
    """Batched identity plans (leading config axis): the protected-only
    baseline through the same batched call as the remap runs."""
    one = identity_plan(rows, cols, device=resolve_device(device))
    return RepairPlan(one.col_map.expand(n, cols).contiguous(), one.prune.expand(n, rows, cols).contiguous())


# --------------------------------------------------------------------------- #
# chaos hook: campaign-sampled fault maps into running servers
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """Inject campaign-sampled fault maps into live serving replicas at a
    chosen step, the fleet's counterpart of a Monte-Carlo fault
    configuration.  The runtime is not told: the ScanEngine probes must find
    the faults, which is what the chaos experiment measures."""

    per: float = 0.02
    fault_model: str = "random"   # random | clustered
    at_step: int = 0
    replicas: tuple[int, ...] | None = None  # None = every live replica
    seed: int = 0

    def targets(self, n_replicas: int) -> tuple[int, ...]:
        if self.replicas is None:
            return tuple(range(n_replicas))
        return tuple(i for i in self.replicas if 0 <= i < n_replicas)


def chaos_maps(spec: ChaosSpec, n: int, rows: int, cols: int) -> np.ndarray:
    """(n, rows, cols) campaign-distribution fault maps for chaos injection
    (host numpy, the reference's calls: the same spec gives the same maps)."""
    rng = np.random.default_rng(spec.seed)
    return fm.sample_fault_maps(rng, n, rows, cols, spec.per, spec.fault_model)  # type: ignore[arg-type]


def chaos_signatures(spec: ChaosSpec, n: int, rows: int, cols: int) -> tuple[np.ndarray, np.ndarray]:
    """(n, rows, cols) stuck-bit / stuck-val grids for chaos injection, drawn
    from the spec's seed rather than each injector's own RNG, so both fleet
    engines inject the same signatures for the same spec (probe
    detectability depends on the stuck bit)."""
    rng = np.random.default_rng([spec.seed, 0xC11A05])
    bits = rng.integers(0, 32, size=(n, rows, cols), dtype=np.int32)
    vals = rng.integers(0, 2, size=(n, rows, cols), dtype=np.int32)
    return bits, vals


def apply_chaos(injector, fault_map: np.ndarray, *, bits: np.ndarray | None = None,
                vals: np.ndarray | None = None) -> int:
    """Merge a sampled map into a FaultInjector's ground truth; returns the
    number of new faults (PEs already faulty are unchanged).  With ``bits``
    and ``vals`` (one :func:`chaos_signatures` slice) the stuck-at
    signatures come from those grids instead of the injector's RNG."""
    before = injector.n_faults
    m = np.asarray(fault_map, bool)
    if bits is None or vals is None:
        injector.inject_map(m)
    else:
        for r, c in np.argwhere(m):
            injector.inject_at(int(r), int(c), bit=int(bits[r, c]), val=int(vals[r, c]))
    return injector.n_faults - before
