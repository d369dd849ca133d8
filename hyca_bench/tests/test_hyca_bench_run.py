"""End to end on the CPU at smoke size: the run's last line, and the
command's refusal without a card."""
import json
import os
import subprocess
import sys

import pytest

from hyca_bench.harness.spec import ROOT
from hyca_bench.tests import smoke

ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")


def run_smoke(workload, tracing):
    """A smoke run in a fresh process, printed by run.py's own ``report``."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from hyca_bench import run\n"
            "from hyca_bench.tests import smoke\n"
            "sys.exit(run.report(smoke.run(%r, seed=2**31 + 99, seconds=2.0, tracing=%r)))\n"
            ) % (str(ROOT), workload, tracing)
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, env=ENV)


@pytest.mark.parametrize("workload,tracing", [("granite.chat", False), ("granite.chat", True),
                                              ("deepseek.prefill", False), ("deepseek.prefill", True)])
def test_last_line_is_well_formed(workload, tracing):
    out = run_smoke(workload, tracing)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if tracing else []) + ["samples", "checks"]
    assert list(line) == keys
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    spec = smoke.spec()
    want = spec.per_layer(workload) if tracing else spec.end_to_end(workload)
    assert set(line["metrics"]) <= {m["name"] for m in want}
    if not tracing:
        assert set(line["metrics"]) == {m["name"] for m in want}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    if tracing:
        assert {"busy_s", "window_s"} <= set(line["device"]) and line["device"]["window_s"] > 0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    tail = out.stderr.strip().splitlines()[-len(line["checks"]):]
    for (name, c), said in zip(line["checks"].items(), tail):
        assert said.startswith(f"check {name}: ") and c["value"] <= c["limit"]


def test_command_refuses_without_a_card():
    """The command exits non-zero and prints no result where CUDA is missing."""
    out = subprocess.run([sys.executable, str(ROOT / "hyca_bench" / "run.py"), "--workload", "granite-moe-3b.chat",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, env=dict(ENV, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""
