#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the CUDA device(s) of this machine.

    python3 hyca_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as its last line on standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (``--trace 0``: the cell's
end-to-end metrics; ``--trace 1``: its per-layer metrics), ``device``,
traced ``breakdown``, ``samples`` (what the window held); last,
``checks``: each number compared with its limit, which also end standard
error.  Exits non-zero, printing no result, without CUDA or with fewer
cards than the cell asks for, and when JAX or the JAX package was loaded.
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

from hyca_bench.harness import cell  # noqa: E402
from hyca_bench.harness.spec import Spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = Spec()
    chips = spec.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); this machine has {n}", file=sys.stderr)
        return 2
    return report(cell.run(spec, args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0)))


def report(out: dict) -> int:
    """Print a run's result, or refuse it where JAX or the JAX package is
    loaded in this process; the exit code."""
    found = env.forbidden_modules()
    if found:
        print(f"the run loaded JAX or the JAX package: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
