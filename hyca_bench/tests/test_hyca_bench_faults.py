"""``correct`` comes out false when the timed path is broken underneath:
the rest of a run driven at smoke size on the CPU.  One fault of each kind
the cells can have (the exchange between chips has no cell: every cell
takes one chip).  And the control, the reference in fp8, reads above the
program on the same sample and is judged not correct by the check."""
import pytest
import torch

from hyca_bench.tests import smoke

SEED = 2**31 + 4242


@pytest.fixture
def server_mod():
    from repro_torch.serving import server
    return server


def test_unbroken_runs_are_correct():
    for w in ("granite.chat", "deepseek.chat", "granite.prefill", "deepseek.prefill"):
        assert smoke.run(w, SEED)["correct"], w


@pytest.mark.parametrize("workload", ["granite.chat", "deepseek.chat"])
def test_served_token_altered_where_produced(workload, server_mod, monkeypatch):
    body = server_mod.CapturedStep._body

    def altered(self):
        body(self)
        self.sampled.add_(1).remainder_(self.bundle.lm.vocab)

    monkeypatch.setattr(server_mod.CapturedStep, "_body", altered)
    assert not smoke.run(workload, SEED)["correct"]


@pytest.mark.parametrize("workload", ["granite.chat", "deepseek.chat"])
def test_step_leaves_its_state_unchanged(workload, monkeypatch):
    """The decode step never writes its K/V rows into the cache."""
    from repro_torch.models import attention

    monkeypatch.setattr(attention, "_write_rows", lambda *a, **k: None)
    assert not smoke.run(workload, SEED)["correct"]


@pytest.mark.parametrize("workload", ["granite.chat", "deepseek.chat"])
def test_half_the_slots_left_out(workload, server_mod, monkeypatch):
    """The step's second half of slots takes the mean logits of the first."""
    body = server_mod.CapturedStep._body

    def half(self):
        body(self)
        n = self.logits.shape[0] // 2
        self.logits[n:] = self.logits[:n].float().mean(0).to(self.logits.dtype)
        self.sampled.copy_(self.logits[:, -1].argmax(-1))

    monkeypatch.setattr(server_mod.CapturedStep, "_body", half)
    assert not smoke.run(workload, SEED)["correct"]


@pytest.fixture
def serve_mod():
    from repro_torch.launch import serve
    return serve


@pytest.mark.parametrize("workload", ["granite.prefill", "deepseek.prefill"])
def test_half_the_batch_left_out(workload, serve_mod, monkeypatch):
    """The prefill runs the first half of the rows; the rest get their mean."""
    fwd = serve_mod.forward

    def half(params, cfg, batch, **kw):
        n = batch["tokens"].shape[0] // 2
        logits, aux = fwd(params, cfg, {"tokens": batch["tokens"][:n]}, **kw)
        rest = logits.float().mean(0, keepdim=True).expand(batch["tokens"].shape[0] - n, *logits.shape[1:])
        return torch.cat([logits, rest.to(logits.dtype)]), aux

    monkeypatch.setattr(serve_mod, "forward", half)
    assert not smoke.run(workload, SEED)["correct"]


@pytest.mark.parametrize("workload", ["granite.prefill", "deepseek.prefill"])
def test_answer_altered_where_produced(workload, serve_mod, monkeypatch):
    fwd = serve_mod.forward

    def altered(*a, **kw):
        logits, aux = fwd(*a, **kw)
        logits[0] = -logits[0]
        return logits, aux

    monkeypatch.setattr(serve_mod, "forward", altered)
    assert not smoke.run(workload, SEED)["correct"]


@pytest.mark.parametrize("workload", ["granite.chat", "granite.prefill"])
def test_control_reads_above_the_program(workload):
    name = next(k for k in smoke.spec().limits(workload) if k != "unrepaired_faults")
    for seed in (SEED, SEED + 1, SEED + 2):
        r = smoke.readings(workload, seed)
        got = [r[k] if isinstance(r[k], float) else r[k][name] for k in ("program", "control_fp8")]
        assert got[1] > got[0], r


@pytest.mark.parametrize("workload", ["granite.chat", "deepseek.chat", "granite.prefill", "deepseek.prefill"])
def test_control_is_not_correct(workload):
    """Through the check's own judgement: the program is correct and the
    control, in the program's place on the same sample, is not."""
    r = smoke.readings(workload, SEED)
    assert r["program"]["correct"] and not r["control_fp8"]["correct"], r


@pytest.mark.cuda
def test_a_cell_on_the_card():
    """One short run of the granite chat cell on the card is correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from hyca_bench.harness import cell
    from hyca_bench.harness.spec import Spec

    out = cell.run(Spec(), "granite-moe-3b.chat", 2**31 + 17, 5.0, False, torch.device("cuda", 0))
    assert out["correct"], out["checks"]
