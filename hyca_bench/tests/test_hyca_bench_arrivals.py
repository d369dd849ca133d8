"""The arrival processes of the served mixes, and the chat driver's use of
one it finds by name."""
import json

from hyca_bench.harness import spec
from hyca_bench.harness.spec import BENCH_DIR
from hyca_bench.tests import smoke


def test_closed_loop_sends_a_request_per_completion():
    mix = json.loads((BENCH_DIR / "traffic" / "chat.json").read_text())
    arr = spec.module("arrivals", mix["arrival"]["process"]).Arrivals(mix["arrival"], 2**31 + 5)
    assert arr.due(10.0, 0) == [10.0] * mix["arrival"]["clients"]
    assert arr.due(11.5, 0) == []
    assert arr.due(12.0, 3) == [12.0] * 3


def test_the_chat_driver_takes_the_process_the_mix_names():
    """A closed loop of the smoke mix keeps every slot busy: each step's
    counted calls are those of all its slots."""
    out = smoke.run("granite.chat", seed=2**31 + 21, seconds=1.0, tracing=True)
    assert out["correct"] and out["metrics"]["slot_occupancy.serve"]["value"] == 100.0
    found, calls = out["samples"]["ft_launches"]["ft_matmul"]
    assert calls > 0 and found == 0   # no device trace on the CPU
