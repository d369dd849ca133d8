"""Measured plan search for the ``ft_matmul`` kernel, with a persisted cache.

The kernels' launch plan (:class:`~repro_torch.kernels.ft_matmul.FTPlan`)
is a fixed rule, :func:`~repro_torch.kernels.ft_matmul.ft_plan`, of the
shape, ``w``'s dtype and layout.  This module times every plan the kernels
take for one shape (:func:`~repro_torch.kernels.ft_matmul.plan_candidates`:
the strip layouts at each cluster split, the K-fast layout at its single
plan) and keeps the fastest in a JSON cache keyed
``"{m}x{n}x{k}:{dtype}:{layout}:cuda"`` (``dtype`` is ``w``'s):

    {
      "4x2816x1024:bfloat16:n_fast:cuda": {"plan": {"layout": "n_fast", "split": 4, "bn": 64},
                                            "ms": 0.0061, "candidates": {"1": 0.0083, ...}},
      ...
    }

The cache is ``$REPRO_AUTOTUNE_DIR/ft_matmul.json``, else
``build/repro_torch/autotune/ft_matmul.json`` at the repository root.  It
is never the reference's Pallas cache (``experiments/autotune/``), whose
TPU entries the port does not read.

Only a context built with ``fused_block="auto"``
(:func:`~repro_torch.core.ftcontext.build_ftcontext`) reads the cache; the
default context and every served path keep ``ft_plan``.  A split changes the
order of the K sum, so a tuned plan's float output is not bitwise
``ft_plan``'s.

Each candidate is timed on the card: a run of calls captured as one CUDA
graph (the served step is one), replayed between CUDA events, the min over
repeats of the mean a call, the weights cycled past the L2 cache as the
served step reads them.  Timed call by call from the host, a decode-shaped
call measures the host's launch work (~45 µs on an H100's host against a
few µs of kernel), not the plan.  The fault masks cannot change the time
(the mux is branch-free), so the search runs fault-free.  It runs on the card only:
the plain twin the CPU computes has no plan.

    python -m repro_torch.kernels.autotune M N K [--dtype bfloat16] [--layout n_fast]
"""
from __future__ import annotations

import argparse
import json
import math
import os
from pathlib import Path
from typing import Callable

import torch

from repro_torch.kernels.ft_matmul import FTPlan, ft_matmul, ft_plan, plan_candidates, w_layout

_CACHE: dict[str, dict] | None = None
_CACHE_PATH: str | None = None
DEFAULT_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch" / "autotune"


def cache_path() -> str:
    """``$REPRO_AUTOTUNE_DIR/ft_matmul.json``, else
    ``build/repro_torch/autotune/ft_matmul.json`` at the repository root."""
    base = os.environ.get("REPRO_AUTOTUNE_DIR")
    return os.path.join(str(DEFAULT_DIR) if base is None else base, "ft_matmul.json")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def key(m: int, n: int, k: int, dtype: torch.dtype, layout: str) -> str:
    return f"{m}x{n}x{k}:{_dtype_name(dtype)}:{layout}:cuda"


def _plan_of_entry(entry) -> FTPlan | None:
    p = entry.get("plan") if isinstance(entry, dict) else None
    if not isinstance(p, dict):
        return None
    try:
        plan = FTPlan(str(p["layout"]), int(p["split"]), int(p["bn"]))
        return plan if plan in plan_candidates(plan.layout) else None
    except (KeyError, TypeError, ValueError):
        return None


def load_cache(path: str | None = None, *, reload: bool = False) -> dict[str, dict]:
    """Load (and memoise) the cache.  A missing or corrupt file loads as
    empty, and an entry whose plan no kernel takes is dropped: an absent
    cache never breaks a context build."""
    global _CACHE, _CACHE_PATH
    path = path or cache_path()
    if _CACHE is not None and _CACHE_PATH == path and not reload:
        return _CACHE
    cache: dict[str, dict] = {}
    try:
        with open(path) as f:
            raw = json.load(f)
        if isinstance(raw, dict):
            cache = {k: e for k, e in raw.items() if _plan_of_entry(e) is not None}
    except (OSError, ValueError):
        pass
    _CACHE, _CACHE_PATH = cache, path
    return cache


def save_cache(cache: dict[str, dict], path: str | None = None) -> str:
    global _CACHE, _CACHE_PATH
    path = path or cache_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(cache, f, indent=1, sort_keys=True)
        f.write("\n")
    _CACHE, _CACHE_PATH = dict(cache), path
    return path


def reset_cache() -> None:
    """Drop the in-memory cache (a test repoints ``REPRO_AUTOTUNE_DIR``)."""
    global _CACHE, _CACHE_PATH
    _CACHE, _CACHE_PATH = None, None


def resolve_plan(m: int, n: int, k: int, dtype: torch.dtype, layout: str) -> FTPlan:
    """The ``fused_block="auto"`` lookup: the cache's plan for this shape,
    else the fixed rule ``ft_plan``."""
    plan = _plan_of_entry(load_cache().get(key(m, n, k, dtype, layout)))
    if plan is not None and plan.layout == layout:
        return plan
    return ft_plan(1, m, n, k, dtype, layout)


def search(candidates, time_fn: Callable[[FTPlan], float]) -> tuple[FTPlan, float, dict]:
    """``(best plan, its ms, {split: ms})`` over ``candidates``, each timed
    once by ``time_fn``; the first of equal times wins."""
    best, best_ms, times = None, math.inf, {}
    for plan in candidates:
        ms = float(time_fn(plan))
        times[str(plan.split)] = ms
        if ms < best_ms:
            best, best_ms = plan, ms
    return best, best_ms, times


def operands(m: int, n: int, k: int, dtype: torch.dtype, layout: str, device, *, copies: int = 1,
             seed: int = 0) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """``x (m, k)`` and ``copies`` weights ``(k, n)`` of ``dtype`` in
    ``layout``: row-major (``n_fast``), a table's transposed view
    (``k_fast``), or a row-major matrix whose row pitch is one element
    longer than ``n`` (``scalar``)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=device).to(dtype)
    ws = []
    for _ in range(copies):
        if layout == "k_fast":
            w = (torch.randn((n, k), generator=g, device=device) * 0.02).to(dtype).T
        elif layout == "scalar":
            w = (torch.randn((k, n + 1), generator=g, device=device) * 0.02).to(dtype)[:, :n]
        else:
            w = (torch.randn((k, n), generator=g, device=device) * 0.02).to(dtype)
        if w_layout(w) != layout:
            raise ValueError(f"a ({k}, {n}) {dtype} weight cannot take the {layout!r} layout")
        ws.append(w)
    return x, ws


def _graph_timer(m: int, n: int, k: int, dtype: torch.dtype, layout: str, device, *, repeats: int,
                 steps: int, l2_bytes: int) -> Callable[[FTPlan], float]:
    """A timer of one call under a plan, on the device's clock: ``steps``
    calls, cycling through enough weight copies that each call reads its
    weight from device memory, captured as one CUDA graph (the served step
    is one too, so the host's launch work stays out, as it does there) and
    replayed between CUDA events; the min over ``repeats`` replays.  Each
    replay's launches count on ``ft_matmul.launches``, the capture's not."""
    elt = torch.empty((), dtype=dtype).element_size()
    copies = max(1, min(64, math.ceil(2 * l2_bytes / (k * n * elt))))
    x, ws = operands(m, n, k, dtype, layout, device, copies=copies)
    keep = torch.full((32, 32), -1, dtype=torch.int32, device=device)
    zero = torch.zeros((32, 32), dtype=torch.int32, device=device)

    def time_fn(plan: FTPlan) -> float:
        def run():
            for i in range(steps):
                ft_matmul(x, ws[i % len(ws)], keep, zero, out_dtype=dtype, plan=plan)

        run()  # warm-up, outside the graph
        torch.cuda.synchronize(device)
        before = ft_matmul.launches
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            run()
        ft_matmul.launches = before  # a capture launches nothing
        best = math.inf
        for _ in range(repeats):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            ft_matmul.launches += steps
            best = min(best, start.elapsed_time(end) / steps)
        del graph
        return best

    return time_fn


def autotune_plan(m: int, n: int, k: int, *, dtype: torch.dtype = torch.bfloat16, layout: str = "n_fast",
                  device="cuda", repeats: int = 5, steps: int = 20, persist: bool = True,
                  time_fn: Callable[[FTPlan], float] | None = None) -> tuple[FTPlan, float, dict]:
    """Measured search over the plans of one ``(m, n, k)`` shape with ``w``
    of ``dtype`` in ``layout``; records the winner in the cache (and saves
    it with ``persist``).  Returns ``(plan, ms, {split: ms})``.  Times the
    CUDA kernel, so it raises without a card; ``time_fn`` replaces the timer
    (a test's stub)."""
    if time_fn is None:
        dev = torch.device(device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            raise RuntimeError(
                f"autotune_plan times the CUDA kernel ft_matmul and needs the card (device={device!r}, "
                f"CUDA available: {torch.cuda.is_available()}); the plain twin on the CPU has no plan")
        from repro_torch.launch.hw import L2_BYTES

        time_fn = _graph_timer(m, n, k, dtype, layout, dev, repeats=repeats, steps=steps, l2_bytes=L2_BYTES)
    best, best_ms, times = search(plan_candidates(layout), time_fn)
    cache = dict(load_cache())
    cache[key(m, n, k, dtype, layout)] = {"plan": {"layout": best.layout, "split": best.split, "bn": best.bn},
                                          "ms": best_ms, "candidates": times}
    if persist:
        save_cache(cache)
    else:
        global _CACHE
        _CACHE = cache
    return best, best_ms, times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="measured plan search of ft_matmul at one shape, on the card")
    ap.add_argument("m", type=int)
    ap.add_argument("n", type=int)
    ap.add_argument("k", type=int)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--layout", default="n_fast", choices=["n_fast", "k_fast", "scalar"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    dtype = getattr(torch, args.dtype)
    plan, ms, times = autotune_plan(args.m, args.n, args.k, dtype=dtype, layout=args.layout,
                                    steps=args.steps, repeats=args.repeats)
    rule = ft_plan(1, args.m, args.n, args.k, dtype, args.layout)
    print(f"[autotune] {key(args.m, args.n, args.k, dtype, args.layout)}: {plan} ({ms:.4f} ms); "
          f"ft_plan {rule} ({times[str(rule.split)]:.4f} ms); by split {times} -> {cache_path()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
