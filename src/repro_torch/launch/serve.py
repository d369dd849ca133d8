"""Serving steps: prefill (forward, last-position logits) and one-token
decode against a KV cache, plus the serving CLI over the fault-aware
runtime (:mod:`repro_torch.serving`).

The port has no device mesh yet, so the step builders take an explicit
``device`` where the reference takes a ``Mesh``, and the specs they return
beside the step are ``None``.  The decode step is the port's compiled form:
on a card, under the ``plain`` and ``fused`` dispatches, one CUDA graph over
static buffers (:class:`~repro_torch.serving.server.CapturedStep`, the
server's own step), and eager elsewhere.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --mode protected --faults 3
"""
from __future__ import annotations

import argparse
import time
import numpy as np
import torch

from repro_torch.core.ftcontext import FTContext
from repro_torch.models.lm import LMConfig, forward
from repro_torch.serving.server import CapturedStep, ServerConfig, resolve_device


def make_prefill(cfg: LMConfig, device: str = "cuda", *, ftc: FTContext | None = None):
    """``(prefill, None)``: ``prefill(params, batch)`` runs ``forward(...,
    last_only=True, ftc=ftc)`` and returns the last position's logits (B, 1,
    padded vocab).  Where the reference takes a mesh and the param and batch
    shapes its sharding specs are built from, the port takes the device:
    it has no mesh, so the specs are ``None``.  The prefill runs eagerly on
    ``device``'s tensors; asking for CUDA where there is none raises."""
    resolve_device(device)

    def prefill(params, batch):
        with torch.no_grad():
            logits, _ = forward(params, cfg, batch, last_only=True, ftc=ftc)
        return logits

    return prefill, None


class _DecodeHost:
    """What a :class:`CapturedStep` reads of its model bundle: the model,
    the context, the working params, the device and the step's config."""

    def __init__(self, cfg: LMConfig, ftc: FTContext | None, params, device: torch.device, n_slots: int):
        self.lm, self.ftc, self.work, self.device = cfg, ftc, params, device
        dispatch = "plain" if ftc is None else ftc.dispatch
        self.cfg = ServerConfig(n_slots=n_slots, dispatch=dispatch, device=str(device))


class DecodeStep:
    """:func:`make_decode`'s step: ``step(params, cache, batch) -> (logits,
    cache)``.  ``captured`` is the :class:`CapturedStep` over the cache of
    the last call (None before the first): its ``captures`` and ``replays``
    say whether the step ran as a CUDA graph."""

    def __init__(self, cfg: LMConfig, device: torch.device, batch: int | None, ftc: FTContext | None):
        self.cfg, self.device, self.batch, self.ftc = cfg, device, batch, ftc
        self.captured: CapturedStep | None = None

    def __call__(self, params, cache, tokens: dict):
        tok = tokens["token"]
        if self.batch is not None and tok.shape[0] != self.batch:
            raise ValueError(f"the step was built for a batch of {self.batch}, got tokens {tuple(tok.shape)}")
        s = self.captured
        if s is None or s.cache is not cache:
            host = _DecodeHost(self.cfg, self.ftc, params, self.device, tok.shape[0])
            self.captured = s = CapturedStep(host, cache)
        elif params is not s.params:
            s.swap_params(params)
        s.tokens.copy_(tok)
        with torch.no_grad():
            s()
        return s.logits.clone(), cache


def make_decode(cfg: LMConfig, device: str = "cuda", *, batch: int | None = None, ftc: FTContext | None = None):
    """``(step, None)``: ``step(params, cache, batch)`` (a :class:`DecodeStep`)
    runs ``decode_step`` over ``batch`` = {"token": (B, 1) ints} and returns
    ``(logits, cache)``: the logits (B, 1, padded vocab) as a new tensor,
    and ``cache`` itself, advanced in place (the reference donates the
    cache; here the step's graph reads and writes it at fixed addresses).

    The step is a :class:`CapturedStep` over the cache it is called with:
    captured on its first call as a CUDA graph wherever one holds it (a
    card, dispatch ``plain`` or ``fused``), eager otherwise (``twopass``,
    the CPU).  It holds one cache at a time: a call with another cache
    object builds the step over that one and drops the old step and its
    graph; a call with other params recaptures over them.  A fault table or
    plan swapped into ``ftc`` in place (:meth:`FTContext.swap`) is served by
    the same graph.  ``batch`` fixes B when given.  Where the reference
    takes a mesh and the shapes of its sharding specs, the port takes the
    device, and the specs are ``None``."""
    return DecodeStep(cfg, resolve_device(device), batch, ftc), None


# --------------------------------------------------------------------------- #
# CLI: a thin front-end over repro_torch.serving (the fault-aware runtime)
# --------------------------------------------------------------------------- #
def main(argv=None):
    from repro_torch.configs import get_smoke_config
    from repro_torch.serving import FaultTolerantServer

    ap = argparse.ArgumentParser(
        description="Fault-aware continuous-batching inference server (smoke scale)."
    )
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--slots", type=int, default=4, help="decode slots (max batch)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=16, help="max new tokens per request")
    ap.add_argument("--mode", default="protected", choices=["off", "protected", "unprotected"])
    ap.add_argument("--faults", type=int, default=0, help="faults injected at power-on")
    ap.add_argument("--fault-rate", type=float, default=0.0, help="Poisson new faults/step")
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--cols", type=int, default=8)
    ap.add_argument("--dppu", type=int, default=4)
    ap.add_argument("--protect-fraction", type=float, default=1.0)
    ap.add_argument("--dispatch", default="twopass", choices=["twopass", "fused"],
                    help="FTContext kernel dispatch for protected matmuls")
    ap.add_argument("--repair", default="none", choices=["none", "remap", "retrain"],
                    help="model-side remediation past DPPU capacity "
                         "(repro_torch.repair): remap prunes least-salient channels "
                         "onto broken columns; retrain also fine-tunes the "
                         "replica's params on a budget")
    ap.add_argument("--retrain-steps", type=int, default=4,
                    help="fine-tune budget when --repair retrain")
    ap.add_argument("--scan-block", type=int, default=1,
                    help="PE-grid rows probed per scan step (must divide --rows; "
                         "p = scan_block*cols DPPU groups scan in parallel)")
    ap.add_argument("--dppu-groups", type=int, default=0,
                    help="report the Section IV-D cycle model at this grouping "
                         "(0 = the grouping --scan-block implies)")
    ap.add_argument("--sla", type=int, default=0, help="deadline in steps (0 = none)")
    ap.add_argument("--max-steps", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chaos-per", type=float, default=0.0,
                    help="chaos experiment: inject a campaign-sampled fault map "
                         "at this PER into the running server (0 = off)")
    ap.add_argument("--chaos-at", type=int, default=0,
                    help="server step at which the chaos map is injected")
    ap.add_argument("--chaos-model", default="random", choices=["random", "clustered"],
                    help="fault distribution of the chaos map")
    ap.add_argument("--counters", action="store_true",
                    help="carry the repro_torch.obs device-side Counters through "
                         "the step (exact fault/recompute accounting; "
                         "bit-exact with counters off)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the event log as JSONL to PATH and a "
                         "Prometheus-style rendering of the summary (gauges "
                         "+ latency histograms) to PATH.prom")
    ap.add_argument("--series", action="store_true",
                    help="carry a repro_torch.obs SeriesBuffer ring through the "
                         "step loop (per-step device-side telemetry)")
    ap.add_argument("--series-out", default=None, metavar="PATH",
                    help="harvest the series ring to PATH.npz (implies "
                         "--series); feed to python -m repro_torch.obs.replay")
    ap.add_argument("--spans-out", default=None, metavar="PATH",
                    help="derive repro_torch.obs.trace lifecycle spans from the "
                         "event log and write them as JSONL to PATH")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve an HTTP /metrics endpoint on 127.0.0.1:PORT "
                         "during the run (0 = pick a free port); the scrape "
                         "returns the same Prometheus text --metrics-out writes")
    ap.add_argument("--metrics-hold", type=float, default=0.0, metavar="SEC",
                    help="keep the /metrics endpoint up SEC seconds after "
                         "the run finishes (lets an external scraper catch "
                         "the final state)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = ServerConfig(
        arch=args.arch, n_slots=args.slots, smax=args.prompt_len + args.gen + 2,
        mode=args.mode, rows=args.rows, cols=args.cols, dppu_size=args.dppu,
        protect_fraction=args.protect_fraction, dispatch=args.dispatch,
        scan_block=args.scan_block, fault_rate=args.fault_rate, seed=args.seed,
        repair=args.repair, retrain_steps=args.retrain_steps,
        counters=args.counters,
        series=args.series or args.series_out is not None,
        device=args.device,
    )
    server = FaultTolerantServer(cfg)
    if args.faults:
        server.injector.inject_n(args.faults)
        if args.mode == "protected":
            server.manager.bist()

    lm = get_smoke_config(args.arch)
    rng = np.random.default_rng(args.seed)
    trace = [
        {
            "step": int(rng.integers(0, max(args.requests // 2, 1))),
            "prompt": rng.integers(0, lm.vocab, size=args.prompt_len),
            "max_new_tokens": args.gen,
            **({"deadline_step": int(rng.integers(0, args.requests)) + args.sla} if args.sla else {}),
        }
        for _ in range(args.requests)
    ]
    on_step = None
    chaos_state = {"injected": None}
    if args.chaos_per > 0:
        from repro_torch.core.campaign import ChaosSpec, apply_chaos, chaos_maps

        chaos = ChaosSpec(per=args.chaos_per, fault_model=args.chaos_model,
                          at_step=args.chaos_at, seed=args.seed + 99)
        cmap = chaos_maps(chaos, 1, args.rows, args.cols)[0]

        def on_step(srv):
            if srv.step_idx == chaos.at_step and chaos_state["injected"] is None:
                n = apply_chaos(srv.injector, cmap)
                chaos_state["injected"] = n
                srv.log.emit("chaos.injected", n=n)

    labels = {"arch": lm.name, "mode": args.mode}
    httpd = None
    if args.metrics_port is not None:
        from repro_torch.obs.export import histograms_text, prometheus_text
        from repro_torch.obs.httpd import MetricsServer

        def _render_prom():
            return (prometheus_text(server.metrics.summary(counters=server.counters_host()), labels=labels)
                    + histograms_text(server.metrics.latency_lists(), labels=labels))

        httpd = MetricsServer(_render_prom, port=args.metrics_port)
        # flush: a scraper tails the redirected log for the bound port
        print(f"[serve] /metrics live on http://127.0.0.1:{httpd.start()}/metrics", flush=True)
    try:
        t0 = time.perf_counter()
        summary = server.run(trace, max_steps=args.max_steps, on_step=on_step)
        dt = time.perf_counter() - t0
        _report(args, server, lm, summary, dt, chaos_state, labels)
        if httpd is not None and args.metrics_hold > 0:
            print(f"[serve] holding /metrics for {args.metrics_hold:g}s", flush=True)
            time.sleep(args.metrics_hold)
    finally:
        if httpd is not None:
            httpd.stop()
    return summary


def _report(args, server, lm, summary: dict, dt: float, chaos_state: dict, labels: dict) -> None:
    """The CLI's printed lines and its ``--metrics-out``, ``--series-out``
    and ``--spans-out`` files."""
    from repro_torch.core.detection import detection_cycles

    groups = args.dppu_groups or args.scan_block * args.cols
    print(f"[serve] arch={lm.name} mode={args.mode} slots={args.slots} "
          f"faults={server.injector.n_faults} confirmed={server.manager.n_confirmed} "
          f"surviving_cols={server.manager.surviving_cols}/{args.cols}")
    if args.repair != "none":
        print(f"[serve] repair={args.repair}: remapped={server.manager.n_remapped} "
              f"quality_fraction={server.manager.quality_fraction:.2f} "
              f"events={len(server.repair_events)}")
    if args.chaos_per > 0:
        print(f"[serve] chaos: {chaos_state['injected'] or 0} faults injected "
              f"at step {args.chaos_at} (PER {args.chaos_per}, {args.chaos_model}); "
              f"detection is the ScanEngine's job")
    print(f"[serve] scan: block={args.scan_block} rows/step "
          f"({server.manager.steps_per_sweep} steps/sweep); cycle model "
          f"p={groups}: {detection_cycles(args.rows, args.cols, dppu_groups=groups)} "
          f"cycles/sweep (p=1: {detection_cycles(args.rows, args.cols)})")
    if summary.get("detections"):
        print(f"[serve] detection latency (steps, measured): "
              f"mean={summary['detect_latency_mean_steps']:.1f} "
              f"p50={summary['detect_latency_p50_steps']:.1f} "
              f"p95={summary['detect_latency_p95_steps']:.1f} "
              f"over {summary['detections']} confirmations "
              f"(injected at steps {summary['injection_steps']})")
    if args.counters:
        c = summary["counters"]
        print(f"[serve] counters: steps={c['steps']} "
              f"protected_calls={c['protected_calls']} plain={c['plain_calls']} "
              f"fault={c['fault_fraction']:.2e} corrupted={c['corrupted_fraction']:.2e} "
              f"pruned={c['pruned_fraction']:.2e}")
    for k in ("steps", "tokens", "tokens_per_step", "goodput_tokens",
              "requests_completed", "requests_failed", "ttft_mean_steps",
              "queue_depth_mean", "scan_sweeps", "effective_slots_final"):
        print(f"    {k:>22} = {summary[k]}")
    print(f"    {'wall_s':>22} = {dt:.2f}")
    if args.metrics_out:
        from repro_torch.obs.export import write_metrics_out

        path, prom = write_metrics_out(args.metrics_out, summary, server.log, labels=labels,
                                       histograms=server.metrics.latency_lists())
        print(f"[serve] metrics: events -> {path}  summary -> {prom}")
    if args.series_out:
        from repro_torch.obs.series import save_series

        written = save_series(args.series_out, server.series_host(), meta={
            "arch": lm.name, "mode": args.mode, "start_step": server.series_start_step(),
        })
        print(f"[serve] series: {server.series.written} steps -> {written}")
    if args.spans_out:
        from repro_torch.obs.trace import build_traces, write_spans

        n = write_spans(args.spans_out, build_traces(server.log))
        print(f"[serve] spans: {n} -> {args.spans_out}")


if __name__ == "__main__":
    main()
