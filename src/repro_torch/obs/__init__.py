"""repro_torch.obs — observability for the fault-tolerant runtime.

  * :mod:`repro_torch.obs.counters` — device-side FT counters: a
    :class:`Counters` tensor accumulated once a step from a static call
    ledger and the engine's own fault grids (element-exact fault /
    recomputed / corrupted / pruned counts, per-site call counts); the
    decode step's outputs are bit for bit those of a counters-off run.
  * :mod:`repro_torch.obs.events` — the fault-lifecycle event log (JSONL);
    detection and repair latency derive from it.
  * :mod:`repro_torch.obs.trace` — per-entity lifecycle spans over the log:
    request and fault traces, OTLP-style JSONL with deterministic ids.
  * :mod:`repro_torch.obs.series` — the device-side :class:`SeriesBuffer`
    ring the serving loop records one row a step into.
  * :mod:`repro_torch.obs.phases` — the serving step's host phase spans
    (:class:`PhaseClock`): host ms by phase, and ``serve.*`` ranges in a
    profiler's trace while one records.
  * :mod:`repro_torch.obs.export` / :mod:`repro_torch.obs.schema` — the
    Prometheus text exporter (gauges and latency histograms), the stdlib
    ``/metrics`` endpoint (:mod:`repro_torch.obs.httpd`) and the event
    schema validator.
  * ``python -m repro_torch.obs.replay`` — the postmortem CLI joining the
    event JSONL with a series artifact into a per-incident timeline.
"""
from repro_torch.obs.counters import (  # noqa: F401
    Counters,
    SiteCall,
    ledger_stats,
    trace_site_calls,
)
from repro_torch.obs.events import (  # noqa: F401
    Event,
    EventLog,
    detection_records,
    repair_records,
)
from repro_torch.obs.export import prometheus_text, write_metrics_out  # noqa: F401
from repro_torch.obs.fallbacks import (  # noqa: F401
    fallback_summary,
    record_site_fallback,
    reset_site_fallbacks,
    site_fallback_total,
)
from repro_torch.obs.series import (  # noqa: F401
    SeriesBuffer,
    load_series,
    save_series,
)
_TRACE_EXPORTS = ("Span", "Trace", "build_traces", "fault_traces",
                  "request_traces", "write_spans", "validate_span",
                  "validate_spans_jsonl")


def __getattr__(name):
    # lazy: `python -m repro_torch.obs.schema` / `-m repro_torch.obs.trace`
    # import this package first, and an eager import here would import the
    # CLI module twice (runpy warns about exactly that)
    if name in ("validate_event", "validate_jsonl", "KIND_SCHEMAS"):
        from repro_torch.obs import schema

        return getattr(schema, name)
    if name in _TRACE_EXPORTS:
        from repro_torch.obs import trace

        return getattr(trace, name)
    raise AttributeError(f"module 'repro_torch.obs' has no attribute {name!r}")
