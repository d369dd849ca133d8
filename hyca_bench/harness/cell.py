"""One run of one cell: build, warm up, measure, read the metrics, check.

The driver is the mix's ``kind`` (``drivers/<kind>.py``).  Every metric,
end-to-end or per-layer, is read by its reader in ``metrics/`` from the
run's record: the driver's record of the window (``window_s``, ``tokens``,
``model_flops``, ``profile`` (:func:`harness.trace.reduce`),
``profiled_calls``, the ``counts`` calls the traced block ran, and the
kind's own keys: chat ``n_slots``, ``steps``, ``ttft_s``, ``itl_s``;
prefill ``batches``) with ``kind``, ``model`` (the configuration's sizes),
``counts`` (the family's module of ``counts/``) and ``setup_s``.
"""
from __future__ import annotations

import gc

import torch

from hyca_bench.harness import check, env, spec as spec_mod, trace


def build(spec: spec_mod.Spec, workload: str, seed: int, device: torch.device, tracing: bool):
    """(cell, config, mix, the kind's driver module, its driver built and
    warmed up)."""
    cell = spec.cell(workload)
    cfg = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    kind = spec_mod.module("drivers", mix["kind"])
    return cell, cfg, mix, kind, kind.Driver(cfg, mix, seed, device, tracing)


def read(metrics: list[dict], rec: dict) -> dict:
    out = {}
    for entry in metrics:
        value = spec_mod.reader(entry["name"])(rec, entry["name"])
        if value is not None:
            out[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    return out


def free_device(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(spec: spec_mod.Spec, workload: str, seed: int, seconds: float, tracing: bool,
        device: torch.device) -> dict:
    """The result object of one run (the last line's keys), with the
    numbers compared under ``checks``, last."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)  # the context, before its peak is reset
        torch.cuda.reset_peak_memory_stats(device)
    cell, cfg, mix, kind, drv = build(spec, workload, seed, device, tracing)
    setup_s = env.seconds_since_start()
    res = drv.run(seconds)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    unrepaired = drv.unrepaired_faults()
    rec = dict(res, kind=mix["kind"], model=cfg["model"], counts=spec_mod.module("counts", cfg["family"]),
               setup_s=setup_s)
    metrics = read(spec.per_layer(workload) if tracing else spec.end_to_end(workload), rec)
    drv.free()
    del drv
    free_device(device)
    numbers = kind.compare(cfg, mix, seed, device, res) or {}
    numbers["unrepaired_faults"] = unrepaired
    checks, correct = check.judge(numbers, spec.limits(workload))
    attempted, failed, samples = kind.tally(res)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev}
    if tracing and res["profile"]:
        dev["busy_s"] = res["profile"]["busy_s"]
        dev["window_s"] = res["profile"]["window_s"]
        out["breakdown"] = trace.breakdown(res["profile"])
        samples["ft_launches"] = trace.launches(rec)
    out["samples"] = samples
    out["checks"] = checks
    return out
