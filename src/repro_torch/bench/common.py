"""Shared twin utilities: result persistence + claim checks."""
from __future__ import annotations

import inspect
import json
import os
import time
from typing import Any, Callable

import torch

OUT_DIR = os.environ.get("REPRO_TORCH_BENCH_DIR", "experiments/bench_torch")


class Claims:
    """Collects named claim validations for a twin."""

    def __init__(self, name: str):
        self.name = name
        self.items: list[dict] = []

    def check(self, claim: str, ok: bool, detail: str = "") -> bool:
        self.items.append({"claim": claim, "ok": bool(ok), "detail": detail})
        status = "PASS" if ok else "FAIL"
        print(f"    [{status}] {claim}" + (f" — {detail}" if detail else ""))
        return bool(ok)

    @property
    def all_ok(self) -> bool:
        return all(i["ok"] for i in self.items)


def device_name(device) -> str:
    """The name of the device a twin ran on: a card's own name, or ``cpu``."""
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def sync(device) -> None:
    """Wait for the device's queued work, so a host clock reads it."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def save_result(name: str, payload: dict) -> str:
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, f"{name}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, default=float)
    return path


def run_module(name: str, fn: Callable[..., dict], quick: bool, device: str) -> dict[str, Any]:
    """Run one twin (passing ``device`` to the twins that touch tensors),
    time it on the host clock and save its result."""
    print(f"[bench] {name}")
    kw = {"device": device} if "device" in inspect.signature(fn).parameters else {}
    t0 = time.perf_counter()
    out = fn(quick, **kw)
    out["elapsed_s"] = round(time.perf_counter() - t0, 2)
    save_result(name, out)
    ok = out.get("all_ok", True)
    print(f"[bench] {name}: {'OK' if ok else 'CLAIM FAILURES'} ({out['elapsed_s']}s)")
    return out
