#!/usr/bin/env python3
"""Readings that set a cell's limits: for each seed, one run of the cell's
timed path (a window of ``--seconds``), then on the same sample the numbers
the check can compare for the program and for the control, the reference
in the nearest precision below the configuration's bf16 (held in float8
e4m3 wherever the port holds bf16), each with ``correct`` as the check
(:func:`hyca_bench.harness.check.judge`) decides it against the cell's
limits.  The benchmark's own runs never run this.  Prints one JSON line a
seed.

    python3 hyca_bench/control.py --workload <cell> --seconds 20 --seeds 11 12 13
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hyca_bench.harness import env  # noqa: E402

env.prepare()

import torch  # noqa: E402

from hyca_bench.harness import cell, check  # noqa: E402
from hyca_bench.harness.spec import Spec  # noqa: E402


def readings(spec: Spec, workload: str, seed: int, seconds: float, device: torch.device) -> dict:
    """The program's and the control's numbers on one window's sample,
    each judged against the cell's limits as a run judges the program."""
    _, cfg, mix, kind, drv = cell.build(spec, workload, seed, device, False)
    res = drv.run(seconds)
    unrepaired = drv.unrepaired_faults()
    drv.free()
    del drv
    cell.free_device(device)
    limits = spec.limits(workload)
    out = {"workload": workload, "seed": seed, "seconds": res["window_s"]}
    # the control is the reference itself, which feeds no faulty PE
    for side, quant, faults in (("program", None, unrepaired), ("control_fp8", "fp8", 0)):
        numbers = kind.compare(cfg, mix, seed, device, res, quant=quant) or {}
        numbers["unrepaired_faults"] = faults
        _, correct = check.judge(numbers, limits)
        out[side] = dict(numbers, correct=correct)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    spec = Spec()
    for seed in args.seeds:
        print(json.dumps(readings(spec, args.workload, seed, args.seconds, torch.device("cuda", 0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
