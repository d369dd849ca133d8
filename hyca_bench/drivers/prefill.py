"""The prefill driver: offline batch scoring through the port's
``launch/serve.py::make_prefill`` with the protected context of a server
that holds the cell's fault map.  Batches run back to back; each ends in a
host sync, after which its last-position logits are kept for the check.

The check: a sample drawn from the seed of the batches of the window;
``rms_err_mean`` is the mean over their rows of |program - reference| over
|reference| (2-norms over the vocabulary), ``logit_err`` the largest over
the rows of max |program - reference| over max |reference|; the control
(``quant``) stands in with its own last-position logits."""
from __future__ import annotations

import time

import torch

from hyca_bench.harness import check, port, spec, trace
from hyca_bench.harness.inputs import PrefillTraffic

PROFILED_BATCHES = 2  # the traced block, from 40% of the window on
CHECK_BATCHES = 3


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device, tracing: bool):
        self.cfg, self.mix, self.seed, self.device, self.tracing = cfg, mix, seed, device, tracing
        self.counts = spec.module("counts", cfg["family"])
        # the server's cache is never used: one slot of 16 positions
        self.server, self.faults = port.build_server(cfg, seed, device, 1, 16)
        self.prefill = port.prefill_step(self.server)
        self.traffic = PrefillTraffic(mix, seed, cfg["model"]["vocab_size"])
        self._warm_up()
        if tracing:
            trace.warm_up_profiler(device)

    def _call(self, tokens) -> torch.Tensor:
        with trace.span("prefill"):
            return self.prefill(self.server.bundle.work, {"tokens": tokens})

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _warm_up(self) -> None:
        """One batch of each shape the mix sends, on ids that are not timed."""
        for s in self.mix["seq_lens"]:
            b = self.mix["tokens_per_batch"] // s
            self._call(torch.zeros((b, s), dtype=torch.long, device=self.device))
        self._sync()

    def run(self, seconds: float) -> dict:
        kept: dict[int, torch.Tensor] = {}
        batches: list[tuple[int, int]] = []
        prof: dict = {}
        ctx, profile_from, traced_done = None, None, not self.tracing
        t0 = time.perf_counter()
        t = t0
        j = 0
        while True:
            if not traced_done and ctx is None and t - t0 >= 0.4 * seconds:
                ctx = trace.traced(self.device, prof)
                ctx.__enter__()
                profile_from = j
            tokens = torch.from_numpy(self.traffic.batch(j)).to(self.device)
            kept[j] = self._call(tokens)[:, -1]
            self._sync()
            t = time.perf_counter()
            batches.append(tuple(tokens.shape))
            j += 1
            if ctx is not None and j - profile_from == PROFILED_BATCHES:
                ctx.__exit__(None, None, None)
                ctx, traced_done = None, True
            if t - t0 >= seconds and traced_done:
                break
        m = self.cfg["model"]
        profiled = batches[profile_from:profile_from + PROFILED_BATCHES] if prof else []
        return {
            "window_s": t - t0, "batches": batches, "logits": kept,
            "tokens": sum(b * s for b, s in batches),
            "model_flops": sum(self.counts.prefill_flops(m, b, s) for b, s in batches),
            "profile": prof or None,
            "profiled_calls": [c for b, s in profiled for c in self.counts.calls(m, b * s, b)],
        }

    def unrepaired_faults(self) -> int:
        return port.unrepaired_faults(self.server)

    def free(self) -> None:
        self.server = self.prefill = None


def prefill_stats(got: list[torch.Tensor], exact: list[torch.Tensor]) -> dict[str, float]:
    g, r = torch.cat(got), torch.cat(exact)
    rel_max = (g - r).abs().max(-1).values / r.abs().max(-1).values
    rel_rms = (g - r).norm(dim=-1) / r.norm(dim=-1)
    return {"rms_err_mean": float(rel_rms.mean()), "logit_err": float(rel_max.max())}


def compare(cfg: dict, mix: dict, seed: int, device, res: dict, quant: str | None = None) -> dict | None:
    ref = check.reference(cfg)
    m = cfg["model"]
    picked = check.sample(len(res["batches"]), seed, CHECK_BATCHES)
    if not picked:
        return None
    traffic = PrefillTraffic(mix, seed, m["vocab_size"])
    batches = [torch.from_numpy(traffic.batch(j)).to(device) for j in picked]
    weights = check.weights(cfg, seed, device)
    exact = ref.prefill_last(m, weights, batches)
    if quant is None:
        got = [res["logits"][j][:, : m["vocab_size"]].float() for j in picked]
    else:
        got = ref.prefill_last(m, weights, batches, quant=quant)
    return prefill_stats(got, exact)


def tally(res: dict) -> tuple[int, int, dict]:
    """Batches run in the window (none fails but by the check), and what
    the window held."""
    return len(res["batches"]), 0, {"batches": len(res["batches"]), "window_s": res["window_s"]}
