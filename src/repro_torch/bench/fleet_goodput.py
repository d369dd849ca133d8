"""Fleet goodput under chaos — the vectorized engine's headline (the twin
of the reference's fleet_goodput benchmark).

``run_vfleet`` advances the whole fleet one batched tick at a time (a CUDA
graph replay on a card), so production-scale campaigns (1000 replicas x 10k
steps of trace-driven traffic, Poisson wearout, a mid-run chaos event,
spare-pool replacement) take the card minutes at most; the legacy
per-server ``run_fleet`` loop is O(replicas*steps) host iterations with a
real decode each.

Records:

  * quick-size sweep — three scenarios on one geometry, so the first two
    share one build: ``baseline`` (no faults), ``chaos-pool`` and
    ``chaos-region`` (same wearout + chaos event, pool vs region spare
    policy).  Always emitted, in quick and full mode.  The baseline draws
    nothing at random, so its counts equal the reference's row.
  * ``headline-1000x10k`` — full mode only: the production-scale campaign,
    with its wall time in the JSON.

Claims: cross-engine parity on the pinned small-fleet config, no rebuild
across scenarios and fault-rate points, pooled spares beat region-locked
spares, chaos costs goodput vs baseline, and the headline completes in
minutes on the device.
"""
from __future__ import annotations

import dataclasses

from repro_torch.bench.common import Claims, device_name
from repro_torch.serving import ChaosSpec, FleetConfig, ServerConfig, TrafficSpec
from repro_torch.serving.fleet import run_fleet
from repro_torch.serving.vfleet import _TRACES, run_vfleet

_SERVER = ServerConfig(
    n_slots=4, smax=64, mode="protected", scan_block=2,
    rows=8, cols=8, dppu_size=4,
)
_TRAFFIC = TrafficSpec(
    request_rate=0.3, sla_steps=64, seed=2, n_classes=2, tail=0.4,
    burst_rate=0.05, burst_size=4.0,
    diurnal_amplitude=0.4, diurnal_period=2000,
)


N_REGIONS = 4


def _sweep_cfg(n_replicas: int, steps: int, policy: str, *,
               chaos: bool, device="cuda") -> FleetConfig:
    # the chaos event is a *localized* failure domain: every target sits in
    # region 0 (replica index ≡ 0 mod N_REGIONS), each hit hard enough
    # (per=0.15 on an 8x8 array ≈ 9.6 faults >> DPPU capacity 4) to retire.
    # A shared pool can spend every spare on the stricken region; region-
    # locked spares can only spend region 0's quarter — the goodput gap
    # between the two scenarios is the paper's pooled-redundancy argument
    # at fleet scale.
    targets = tuple(range(0, n_replicas, N_REGIONS))
    return FleetConfig(
        n_replicas=n_replicas, n_spares=max(2, n_replicas // 5),
        spare_policy=policy, n_regions=N_REGIONS if policy == "region" else 1,
        steps=steps, retire_fraction=0.25, seed=0, chunk_steps=250,
        fault_rate=3e-4 if chaos else 0.0,
        chaos=ChaosSpec(per=0.15, at_step=steps // 5, seed=1,
                        replicas=targets) if chaos else None,
        traffic=dataclasses.replace(
            _TRAFFIC, diurnal_period=max(steps // 5, 1)),
        server=dataclasses.replace(_SERVER, device=device),
    )


def _record(fleet: str, cfg: FleetConfig, report: dict) -> dict:
    return {
        "fleet": fleet,
        "n_replicas": cfg.n_replicas,
        "steps": cfg.steps,
        "fault_rate": cfg.fault_rate,
        "spare_policy": cfg.spare_policy,
        "goodput_tokens": report["goodput_tokens"],
        "goodput_per_step": report["goodput_per_step"],
        "requests_completed": report["requests_completed"],
        "requests_expired": report["requests_expired"],
        "slo_attainment": report["slo_attainment"],
        "retirements": report["retirements"],
        "replacements": report["replacements"],
        "alive_final": report["alive_final"],
        "alive_mean": report["alive_mean"],
        "latency_e2e_p50": report["latency_e2e_p50"],
        "latency_e2e_p99": report["latency_e2e_p99"],
        "sim_wall_s": report["sim_wall_s"],
    }


def run(quick: bool = False, device="cuda", headline_steps: int = 10_000) -> dict:
    """``headline_steps``: the headline's depth (full mode), cut only where
    the caller's time limit forces it; the record names its depth."""
    c = Claims("fleet_goodput")
    results: list[dict] = []

    # ---- quick-size sweep: three scenarios, one build for the first two - #
    n_replicas, steps = 64, 600
    scenarios = [
        ("baseline", _sweep_cfg(n_replicas, steps, "pool", chaos=False, device=device)),
        ("chaos-pool", _sweep_cfg(n_replicas, steps, "pool", chaos=True, device=device)),
        ("chaos-region", _sweep_cfg(n_replicas, steps, "region", chaos=True, device=device)),
    ]
    reports = {}
    traces_after = {}
    for name, cfg in scenarios:
        reports[name] = run_vfleet(cfg)
        traces_after[name] = len(_TRACES)
        results.append(_record(name, cfg, reports[name]))
    c.check(
        "chaos scenario reuses the baseline's build "
        "(the chaos map / rate are rewritten buffers, not statics)",
        traces_after["chaos-pool"] == traces_after["baseline"],
        f"new traces: {traces_after['chaos-pool'] - traces_after['baseline']}",
    )
    n1 = len(_TRACES)
    for i, rate in enumerate((1e-4, 1e-3)):
        run_vfleet(dataclasses.replace(
            scenarios[1][1], fault_rate=rate, seed=i + 1))
    c.check(
        "zero rebuilds across fault-rate sweep points",
        len(_TRACES) == n1,
        f"rebuilds: {len(_TRACES) - n1}",
    )
    c.check(
        "chaos + wearout cost goodput vs the fault-free baseline",
        reports["baseline"]["goodput_tokens"] > reports["chaos-pool"]["goodput_tokens"],
        f"baseline={reports['baseline']['goodput_tokens']} "
        f"chaos={reports['chaos-pool']['goodput_tokens']}",
    )
    c.check(
        "pooled spares serve at least as much as region-locked spares",
        reports["chaos-pool"]["goodput_tokens"] >= reports["chaos-region"]["goodput_tokens"],
        f"pool={reports['chaos-pool']['goodput_tokens']} "
        f"region={reports['chaos-region']['goodput_tokens']}",
    )

    # ---- cross-engine parity on the pinned small fleet ------------------ #
    parity_cfg = FleetConfig(
        n_replicas=3, n_spares=2, spare_policy="pool", n_regions=1, steps=48,
        fault_rate=0.0, retire_fraction=0.25, seed=0,
        chaos=ChaosSpec(per=0.3, at_step=10, seed=3),
        traffic=TrafficSpec(request_rate=0.8, sla_steps=12, seed=5),
        server=ServerConfig(n_slots=2, smax=32, mode="protected",
                            scan_block=2, rows=4, cols=4, dppu_size=2, device=device),
    )
    legacy = run_fleet(parity_cfg)
    vec = run_vfleet(parity_cfg)
    parity_keys = (
        "goodput_tokens", "requests_completed", "requests_expired",
        "requests_lost", "retirements", "replacements", "spares_remaining",
        "chaos_injected", "slo_requests", "slo_met", "slo_misses",
    )
    diffs = {k: (legacy[k], vec[k]) for k in parity_keys if legacy[k] != vec[k]}
    c.check(
        "vectorized engine matches the legacy fleet loop key-for-key "
        "on the pinned config",
        not diffs, f"diffs={diffs}" if diffs else f"{len(parity_keys)} keys equal",
    )
    parity = {"legacy": {k: legacy[k] for k in parity_keys},
              "vfleet": {k: vec[k] for k in parity_keys}}

    # ---- the headline: 1000 replicas x 10k steps (full mode only) ------- #
    headline = None
    if not quick:
        cfg = _sweep_cfg(1000, headline_steps, "pool", chaos=True, device=device)
        report = run_vfleet(cfg)
        name = "headline-1000x10k" if headline_steps == 10_000 else f"headline-1000x{headline_steps}-reduced"
        headline = _record(name, cfg, report)
        results.append(headline)
        c.check(
            f"1000 replicas x {headline_steps} steps of goodput-under-chaos "
            f"completes in minutes on the device",
            report["sim_wall_s"] < 900,
            f"sim_wall_s={report['sim_wall_s']:.1f}",
        )
        c.check(
            "the spare pool keeps the chaos-hit fleet serving "
            "(goodput never collapses to zero after the event)",
            report["goodput_tokens"] > 0 and report["alive_final"] > 0,
            f"alive_final={report['alive_final']} "
            f"goodput={report['goodput_tokens']}",
        )

    return {
        "results": results,
        "parity": parity,
        "headline": headline,
        "device": device_name(device),
        "claims": c.items,
        "all_ok": c.all_ok,
    }
