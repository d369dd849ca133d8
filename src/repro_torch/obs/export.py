"""Metric export: Prometheus-style text + JSONL event dump.

:func:`write_metrics_out` writes two artifacts: the event log as JSONL at
PATH (validated by ``python -m repro_torch.obs.schema``) and the flattened
summary as a
Prometheus text-format gauge file at ``PATH + ".prom"`` — the de-facto
scrape format, so a node exporter's textfile collector (or a human with
grep) can consume serving telemetry without a client library.

Flattening rule: numeric and bool leaves (nested dicts dotted into the
metric name) become gauges; a **list** leaf exports its *length* as a
``<name>_total`` count gauge (the elements themselves have no stable gauge
identity — e.g. ``injection_steps`` becomes ``hyca_injection_steps_total``
instead of silently vanishing from the artifact); ``None`` and string
leaves are skipped entirely — they have no gauge representation.  Distinct
summary paths that sanitize to the same metric name (``a.b`` and ``a_b``
both become ``a_b``) are deduped with a deterministic ``_2``/``_3`` suffix
in flatten order — never two conflicting samples under one name.

Latency *distributions* (TTFT, detection, repair) export as Prometheus
histograms (:func:`histogram_text`): cumulative ``_bucket{le="..."}``
counts plus ``_sum``/``_count``, step-domain buckets — enough for a
dashboard to plot percentiles without the raw event log.
"""
from __future__ import annotations

import os
import re

# step-domain latency buckets (powers of two): TTFT/detect/repair latencies
# at serving scale land between one step and a few hundred
DEFAULT_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0)

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _name(raw: str) -> str:
    """Sanitize to the exposition grammar ``[a-zA-Z_][a-zA-Z0-9_]*``: invalid
    characters become ``_`` and a leading digit gets a ``_`` prefix (metric
    and label names must not start with a digit)."""
    out = _NAME_RE.sub("_", raw)
    return "_" + out if out[:1].isdigit() else out


def _metric_name(prefix: str, *parts: str) -> str:
    return _name("_".join([prefix, *parts]))


def _escape_label_value(v) -> str:
    """Escape a label value per the text exposition format: backslash first
    (so the other escapes aren't double-escaped), then double-quote and
    newline.  An arch name like ``qwen"1.5\\b`` round-trips instead of
    emitting an unparseable sample line."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _flatten(d: dict, parts: tuple[str, ...] = ()) -> list[tuple[tuple[str, ...], float]]:
    out: list[tuple[tuple[str, ...], float]] = []
    for k, v in d.items():
        p = parts + (str(k),)
        if isinstance(v, dict):
            out.extend(_flatten(v, p))
        elif isinstance(v, bool):
            out.append((p, float(v)))
        elif isinstance(v, (int, float)):
            out.append((p, float(v)))
        elif isinstance(v, (list, tuple)):
            # lists have no per-element gauge identity; export the count so
            # the leaf stays visible in .prom (module docstring rule)
            out.append((p + ("total",), float(len(v))))
        # None / strings have no gauge representation — skipped
    return out


def prometheus_text(metrics: dict, *, prefix: str = "hyca", labels: dict | None = None) -> str:
    """Flatten a (possibly nested) summary dict into Prometheus text format.

    Numeric leaves become gauges named ``{prefix}_{dotted_path}``; list
    leaves become ``{name}_total`` count gauges; None and strings are
    skipped (they are not gauges).  ``labels`` are attached to every sample
    (e.g. ``{"arch": "qwen1.5-0.5b"}``) with values escaped per the
    exposition format (backslash, double-quote, newline).
    """
    label_str = _label_str(labels)
    lines = []
    seen: dict[str, int] = {}
    for parts, value in _flatten(metrics):
        name = _metric_name(prefix, *parts)
        # collision dedupe: distinct paths sanitizing to one name would emit
        # duplicate TYPE headers and conflicting samples; suffix later
        # occurrences deterministically (flatten order is dict order)
        seen[name] = n = seen.get(name, 0) + 1
        if n > 1:
            name = f"{name}_{n}"
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name}{label_str} {value:g}")
    return "\n".join(lines) + ("\n" if lines else "")


def _label_str(labels: dict | None, extra: dict | None = None) -> str:
    merged = dict(labels or {})
    merged.update(extra or {})
    if not merged:
        return ""
    inner = ",".join(
        f'{_name(k)}="{_escape_label_value(v)}"' for k, v in sorted(merged.items())
    )
    return "{" + inner + "}"


def histogram_text(name: str, values, *, prefix: str = "hyca",
                   buckets=DEFAULT_BUCKETS, labels: dict | None = None) -> str:
    """One Prometheus histogram from a list of observations: cumulative
    ``{name}_bucket{le="..."}`` counts (``+Inf`` bucket included), plus
    ``{name}_sum`` and ``{name}_count``.  An empty observation list still
    emits the full (all-zero) histogram — absence of latencies is a
    statement, not a missing scrape."""
    full = _metric_name(prefix, name)
    vals = [float(v) for v in values]
    lines = [f"# TYPE {full} histogram"]
    for b in buckets:
        n = sum(1 for v in vals if v <= b)
        lines.append(f'{full}_bucket{_label_str(labels, {"le": f"{b:g}"})} {n}')
    lines.append(f'{full}_bucket{_label_str(labels, {"le": "+Inf"})} {len(vals)}')
    lines.append(f"{full}_sum{_label_str(labels)} {sum(vals):g}")
    lines.append(f"{full}_count{_label_str(labels)} {len(vals)}")
    return "\n".join(lines) + "\n"


def histograms_text(hists: dict[str, list], *, prefix: str = "hyca",
                    buckets=DEFAULT_BUCKETS, labels: dict | None = None) -> str:
    """Concatenate :func:`histogram_text` for every named observation list
    (e.g. ``ServingMetrics.latency_lists()``)."""
    return "".join(
        histogram_text(name, vals, prefix=prefix, buckets=buckets, labels=labels)
        for name, vals in sorted(hists.items())
    )


def write_metrics_out(path: str, summary: dict, log=None, *,
                      prefix: str = "hyca", labels: dict | None = None,
                      histograms: dict[str, list] | None = None) -> tuple[str, str]:
    """Write the ``--metrics-out`` artifact pair: the event log as JSONL at
    ``path`` (empty file when no log) and the summary as Prometheus text at
    ``path + ".prom"`` — gauges plus, when ``histograms`` maps metric names
    to raw observation lists, latency histograms.  Parent directories are
    created.  Returns the two paths."""
    from repro_torch.obs.fallbacks import fallback_summary

    fallbacks = fallback_summary()
    if fallbacks and "site_fallback_total" not in summary:
        summary = {**summary, "site_fallback_total": fallbacks}
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    if log is not None:
        log.to_jsonl(path)
    else:
        with open(path, "w") as f:
            f.write("")
    prom_path = path + ".prom"
    with open(prom_path, "w") as f:
        f.write(prometheus_text(summary, prefix=prefix, labels=labels))
        if histograms:
            f.write(histograms_text(histograms, prefix=prefix, labels=labels))
    return path, prom_path
