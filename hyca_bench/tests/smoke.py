"""The smoke-size benchmark of ``tests/data``: two configurations at
CPU sizes, the chat and prefill mixes at CPU sizes, their limits.

A smoke run's window is a few seconds of host time; with many test
processes on the machine, torch's default of one thread a core in each
would leave a window only a few steps, so a run here keeps to
:data:`THREADS`."""
from __future__ import annotations

import contextlib
from pathlib import Path

import torch

from hyca_bench import control
from hyca_bench.harness import cell
from hyca_bench.harness.spec import Spec

DATA = Path(__file__).resolve().parent / "data"
CPU = torch.device("cpu")
THREADS = 1


def spec() -> Spec:
    return Spec(DATA / "BENCHMARK.json", DATA)


@contextlib.contextmanager
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def run(workload: str, seed: int = 2**31 + 7, seconds: float = 2.0, tracing: bool = False) -> dict:
    with few_threads():
        return cell.run(spec(), workload, seed, seconds, tracing, CPU)


def readings(workload: str, seed: int, seconds: float = 2.0) -> dict:
    """The program's and the control's numbers on one smoke window."""
    with few_threads():
        return control.readings(spec(), workload, seed, seconds, CPU)
