"""DeepSeek-V3 at its published widths, cut to 3 dense + 2 MoE layers, on
the card: the protected server's prefill and its captured decode step
against the plain float32 reference.

Imports torch, the port and the benchmark only (the card's machine has no
JAX):

    PYTHONPATH=src python -m pytest -q -m cuda hyca_bench/tests/test_hyca_bench_mla_moe_cuda.py

Without a card it skips.  The program runs in bf16 against a float32
reference, so its logits differ by rounding and by the few picks that
rounding moves across a routing tie.  Each check holds the program to half
the error of the control (the same reference with every bf16 tensor held in
float8 e4m3, one precision lower): a lower precision than the
configuration's fails it.
"""
import json

import numpy as np
import pytest
import torch

from hyca_bench.harness import port
from hyca_bench.harness.inputs import float_weights
from hyca_bench.harness.spec import BENCH_DIR
from hyca_bench.bridges import mla_moe as bridge
from hyca_bench.reference import mla_moe as ref

SEED = 2**31 + 1234
SLOTS, PROMPT, NEW = 4, 8, 9   # 16 decode steps: 8 prompt tokens fed, then 8 generated


def rms_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1)).mean())


@pytest.mark.cuda
def test_full_width_prefill_and_captured_decode_against_the_reference():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    cfg = json.loads((BENCH_DIR / "configs" / "deepseek-v3-ep32.json").read_text())
    cfg["model"]["num_hidden_layers"] = 5
    m = cfg["model"]
    v = m["vocab_size"]
    server, faults = port.build_server(cfg, SEED, dev, SLOTS, 64)
    assert len(faults) == 16 and port.unrepaired_faults(server) == 0
    gen = np.random.default_rng(SEED)
    prompts = [gen.integers(0, v, size=PROMPT).astype(np.int32) for _ in range(SLOTS)]

    # prefill through make_prefill on the server's protected context
    batch = torch.from_numpy(np.stack(prompts).astype(np.int64)).to(dev)
    last = port.prefill_step(server)(server.bundle.work, {"tokens": batch})[:, -1, :v].float()

    # decode: every slot fed its prompt a token a step, then its own tokens
    for p in prompts:
        server.submit(p, NEW)
    rows: dict[int, list[torch.Tensor]] = {r: [] for r in range(SLOTS)}
    slot_of, done = {}, {}
    for _ in range(PROMPT + NEW - 1):   # every request is in its slot for all of them
        completed = server.step()
        slot_of.update({s.request.rid: s.index for s in server.scheduler.slots if s.request is not None})
        done.update({c.rid: c for c in completed})
        for rid, i in slot_of.items():
            rows[rid].append(server.decode.logits[i, 0, :v].float().clone())
    assert server.decode.captures == 1 and server.decode.replays == PROMPT + NEW - 2
    assert sorted(done) == list(range(SLOTS)) and all(len(c.tokens) == NEW for c in done.values())
    served = [torch.stack(rows[r]) for r in range(SLOTS)]
    seqs = [torch.from_numpy(np.concatenate([prompts[r], done[r].tokens[:-1]]).astype(np.int64)).to(dev)
            for r in range(SLOTS)]
    server = None
    torch.cuda.empty_cache()

    ref.exact_matmuls()
    w = float_weights(bridge, m, SEED, dev)
    exact_last = ref.prefill_last(m, w, [batch])[0]
    low_last = ref.prefill_last(m, w, [batch], quant="fp8")[0]
    exact = torch.cat(ref.teacher_forced(m, w, seqs, [0] * SLOTS))
    low = torch.cat(ref.teacher_forced(m, w, seqs, [0] * SLOTS, quant="fp8"))
    got = torch.cat(served)
    numbers = {"prefill": (rms_err(last, exact_last), rms_err(low_last, exact_last)),
               "decode": (rms_err(got, exact), rms_err(low, exact))}
    print(numbers)
    for name, (program, control) in numbers.items():
        assert program < control / 2, (name, program, control)
