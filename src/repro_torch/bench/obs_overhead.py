"""Telemetry tax: traced + series serving vs. bare serving (the twin of the
reference's obs_overhead benchmark).

Both serving engines carry device-side series rows and the server derives
lifecycle spans from its event log.  The design contract is that none of it
costs meaningful wall time: the vfleet writes its series rows inside the
tick (one device copy a channel, no host read until the chunk's harvest),
the server one asynchronous row copy a step, and spans are a post-hoc fold
over events the server was already emitting.  This benchmark pins that
contract with numbers:

  * ``vfleet`` row — ``run_vfleet`` on the fleet_goodput quick geometry,
    series off vs. on.  Same chunk count, same chaos event; the series adds
    11 ring channels to the carried state.
  * ``server`` row — the host-loop ``FaultTolerantServer`` under chaos,
    bare vs. fully traced (series ring + request-lifecycle events + span
    build + histogram render), the ``launch/serve --series --spans-out``
    path end to end.

Timing is min-of-repeats with bare/traced repeats interleaved (same
rationale as ft_overhead: the min rejects scheduler noise, interleaving
cancels machine-speed drift out of the ratio).  Each row records
``bare_wall_s``, ``traced_wall_s`` and ``overhead_x`` = traced/bare,
budgeted at 1.10 in full mode.

Claims: traced vfleet output is bit-exact with bare on the shared report
keys (series-on must not perturb the simulation), the traced server still
detects the chaos burst, and — full mode only, quick runs are too noisy —
every ``overhead_x`` <= 1.10.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.bench.common import Claims, device_name
from repro_torch.serving import ChaosSpec, FleetConfig, ServerConfig, TrafficSpec
from repro_torch.serving.server import FaultTolerantServer
from repro_torch.serving.vfleet import run_vfleet

OVERHEAD_BUDGET_X = 1.10

_SERVER = ServerConfig(
    n_slots=4, smax=64, mode="protected", scan_block=2,
    rows=8, cols=8, dppu_size=4,
)


def _vfleet_cfg(*, series: bool, steps: int, device="cuda") -> FleetConfig:
    return FleetConfig(
        n_replicas=32, n_spares=6, spare_policy="pool", steps=steps,
        retire_fraction=0.25, seed=0, chunk_steps=200, fault_rate=0.0,
        chaos=ChaosSpec(per=0.15, at_step=steps // 5, seed=1),
        traffic=TrafficSpec(request_rate=0.3, sla_steps=64, seed=2),
        server=dataclasses.replace(_SERVER, device=device), series=series,
    )


def _time_interleaved(fns: dict[str, callable], repeats: int) -> dict[str, float]:
    """Min-of-repeats wall per labelled thunk, repeats round-robined so
    machine-speed drift hits every label equally."""
    best = {k: float("inf") for k in fns}
    for _ in range(repeats):
        for k, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            best[k] = min(best[k], time.perf_counter() - t0)
    return best


def _server_once(*, series: bool, traced: bool, steps: int, device="cuda") -> dict:
    """One chaos serve; with ``traced`` also exercise the consumers the
    launch path runs (span build + histogram text render)."""
    srv = FaultTolerantServer(dataclasses.replace(
        _SERVER, arch="qwen1.5-0.5b", series=series, seed=0, device=device))
    rng = np.random.default_rng(3)
    trace = [{"step": 0, "prompt": rng.integers(0, 512, size=4),
              "max_new_tokens": 8} for _ in range(6)]

    def chaos(s):
        if s.step_idx == 2:
            s.injector.inject_at(1, 1, bit=30, val=1)
            s.log.emit("chaos.injected", n=1)

    summary = srv.run(trace, max_steps=steps, on_step=chaos)
    if traced:
        from repro_torch.obs.export import histograms_text
        from repro_torch.obs.trace import build_traces

        summary["_spans"] = sum(len(t.spans) for t in build_traces(srv.log))
        summary["_prom"] = len(histograms_text(srv.metrics.latency_lists()))
        srv.series_host()
    return summary


def run(quick: bool = False, device="cuda", paths: tuple[str, ...] = ("vfleet", "server")) -> dict:
    """``paths``: the rows to measure (both by default)."""
    c = Claims("obs_overhead")
    steps = 400 if quick else 1000
    srv_steps = 48 if quick else 96
    repeats = 3 if quick else 5
    results = []

    if "vfleet" in paths:
        # ---- vfleet: series off vs on, warm both builds ----------------- #
        cfg_off = _vfleet_cfg(series=False, steps=steps, device=device)
        cfg_on = _vfleet_cfg(series=True, steps=steps, device=device)
        rep_off, rep_on = run_vfleet(cfg_off), run_vfleet(cfg_on)
        shared = [k for k, v in rep_off.items()
                  if k != "sim_wall_s" and not isinstance(v, dict)]
        c.check(
            "series-on vfleet report is bit-exact with series-off "
            "(telemetry must not perturb the simulation)",
            all(rep_off[k] == rep_on[k] for k in shared),
            f"{len(shared)} shared report keys",
        )
        c.check("series harvest covers every step",
                rep_on["series"]["tokens"].shape[0] == steps,
                f"rows={rep_on['series']['tokens'].shape[0]}")
        wall = _time_interleaved({
            "bare": lambda: run_vfleet(cfg_off),
            "traced": lambda: run_vfleet(cfg_on),
        }, repeats)
        results.append({
            "path": "vfleet", "n_replicas": cfg_on.n_replicas, "steps": steps,
            "bare_wall_s": round(wall["bare"], 4),
            "traced_wall_s": round(wall["traced"], 4),
            "overhead_x": round(wall["traced"] / wall["bare"], 3),
        })

    if "server" in paths:
        # ---- host-loop server: bare vs fully traced --------------------- #
        warm = _server_once(series=True, traced=True, steps=srv_steps, device=device)
        c.check("traced server still confirms the chaos fault",
                warm["detections"] >= 1, f"detections={warm['detections']}")
        c.check("traced server emits request + fault spans",
                warm["_spans"] > 0, f"spans={warm['_spans']}")
        _server_once(series=False, traced=False, steps=srv_steps, device=device)  # warm bare
        swall = _time_interleaved({
            "bare": lambda: _server_once(series=False, traced=False,
                                         steps=srv_steps, device=device),
            "traced": lambda: _server_once(series=True, traced=True,
                                           steps=srv_steps, device=device),
        }, repeats)
        results.append({
            "path": "server", "n_replicas": 1, "steps": srv_steps,
            "bare_wall_s": round(swall["bare"], 4),
            "traced_wall_s": round(swall["traced"], 4),
            "overhead_x": round(swall["traced"] / swall["bare"], 3),
        })

    if not quick:
        for r in results:
            c.check(
                f"{r['path']}: telemetry tax within {OVERHEAD_BUDGET_X}x bare",
                r["overhead_x"] <= OVERHEAD_BUDGET_X,
                f"overhead_x={r['overhead_x']}",
            )

    return {
        "quick": quick, "repeats": repeats,
        "overhead_budget_x": OVERHEAD_BUDGET_X,
        "results": results,
        "device": device_name(device),
        "claims": c.items, "all_ok": c.all_ok,
    }
