"""The chat driver: the port's protected server (``FaultTolerantServer``)
driven through ``submit`` / ``step`` on the host clock, by the arrival
process the mix names (``arrivals/<process>.py``).

Requests are sent at the step boundary at or after they are due.  Every
step stamps each request that got a token in it with the host time after
the step (the step ends in its own host sync).  A request's time to first
token runs from when it was due.

The check: a sample drawn from the seed of the requests the window
finished, the longest among them; the reference runs once over each prompt
with its served tokens.  ``served_gap`` is the widest gap by which a served
(greedy) token's logit lies below the reference's best, ``served_gap_mean``
the mean gap over the served tokens; the control (``quant``) stands in with
the token it puts first at each served position."""
from __future__ import annotations

import time

import numpy as np
import torch

from hyca_bench.harness import check, port, spec, trace
from hyca_bench.harness.inputs import ChatTraffic

PROFILED_STEPS = 24     # the traced block, from 40% of the window on
WARM_UP_STEPS = 4
CHECK_REQUESTS = 8
IDLE_POLL_S = 0.0005    # the host's wait for the next request while no slot is busy


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device, tracing: bool):
        self.cfg, self.mix, self.seed, self.device, self.tracing = cfg, mix, seed, device, tracing
        self.counts = spec.module("counts", cfg["family"])
        self.arrivals = spec.module("arrivals", mix["arrival"]["process"]).Arrivals(mix["arrival"], seed)
        self.server, self.faults = port.build_server(cfg, seed, device, mix["n_slots"], mix["smax"])
        self.traffic = ChatTraffic(mix, seed, cfg["model"]["vocab_size"])
        self.scan_s: list[float] = []
        if tracing:
            srv = self.server
            trace.wrap(srv.manager, "scan_step", "scan_step", self.scan_s)
            trace.wrap(srv.scheduler, "admit", "scheduler.admit")
            trace.wrap(srv.scheduler, "commit", "scheduler.commit")
            trace.wrap(srv.bundle, "step_fn", "step_fn")
        self._warm_up()
        if tracing:
            trace.warm_up_profiler(device)

    def _warm_up(self) -> None:
        """The graph's capture and a few steps at the cell's one decode
        shape (every slot busy), on requests that are not timed."""
        srv = self.server
        for i in range(srv.cfg.n_slots):
            srv.submit(np.full(2, i % 7, np.int32), WARM_UP_STEPS)
        while srv.scheduler.active or srv.queue.depth():
            srv.step()
        self.scan_s.clear()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, seconds: float) -> dict:
        srv, traffic, m = self.server, self.traffic, self.cfg["model"]
        due: dict[int, float] = {}
        prompts: dict[int, np.ndarray] = {}
        stamps: dict[int, list[float]] = {}
        finished: dict[int, object] = {}
        steps: list[dict] = []
        pending: list[float] = []
        sent = 0

        def send(now: float, completed: int) -> None:
            nonlocal sent
            pending.extend(self.arrivals.due(now, completed))
            pending.sort()
            while pending and pending[0] <= now:
                prompt, n_out = traffic.request(sent)
                rid = srv.submit(prompt, n_out)
                due[rid], prompts[rid], stamps[rid] = pending.pop(0), prompt, []
                sent += 1

        prof: dict = {}
        ctx = None
        profiled_calls: list[dict] = []
        traced_done = not self.tracing
        t0 = time.perf_counter()
        send(t0, 0)
        while True:
            if not (srv.scheduler.active or srv.queue.depth()):
                time.sleep(IDLE_POLL_S)
                t = time.perf_counter()
                send(t, 0)
                if t - t0 >= seconds and traced_done:
                    break
                continue
            if not traced_done and ctx is None and time.perf_counter() - t0 >= 0.4 * seconds:
                ctx = trace.traced(self.device, prof)
                ctx.__enter__()
                n_profiled = 0
            done = srv.step()
            t = time.perf_counter()
            first, ctx_sum, active = 0, 0, 0
            for s in srv.scheduler.slots:
                req = s.request
                if req is None:
                    continue
                n = len(s.generated)
                if n > len(stamps[req.rid]):
                    stamps[req.rid].append(t)
                    first += n == 1
                active += 1
                ctx_sum += s.pos if not n else req.prompt_len + n - 1
            for c in done:
                if len(c.tokens) > len(stamps[c.rid]):
                    stamps[c.rid].append(t)
                    first += len(c.tokens) == 1
                active += 1
                ctx_sum += c.prompt_len + len(c.tokens) - 1
                finished[c.rid] = c
            send(t, len(done))
            rec = srv.metrics.steps[-1]
            steps.append({"t": t, "active": rec.active_slots, "tokens": rec.tokens_generated,
                          "prompt_fed": rec.active_slots - (rec.tokens_generated - first),
                          "ctx_sum": ctx_sum, "counted": active,
                          "scan_s": self.scan_s[-1] if self.scan_s else None})
            if ctx is not None:
                # the step's calls over the rows of its own busy slots
                profiled_calls += self.counts.calls(m, active, active)
                n_profiled += 1
                if n_profiled == PROFILED_STEPS:
                    ctx.__exit__(None, None, None)
                    ctx, traced_done = None, True
            if t - t0 >= seconds and traced_done:
                break
        window_s = t - t0
        ttft = [s[0] - due[r] for r, s in stamps.items() if s]
        itl = [b - a for s in stamps.values() for a, b in zip(s, s[1:])]
        n_tokens = sum(len(s) for s in stamps.values())
        return {
            "window_s": window_s, "sent": sent, "finished": finished, "prompts": prompts,
            "steps": steps, "ttft_s": ttft, "itl_s": itl, "tokens": n_tokens, "n_slots": srv.cfg.n_slots,
            "model_flops": sum(self.counts.decode_flops(m, s["counted"], s["ctx_sum"]) for s in steps),
            "profile": prof or None, "profiled_calls": profiled_calls if prof else [],
        }

    def unrepaired_faults(self) -> int:
        return port.unrepaired_faults(self.server)

    def free(self) -> None:
        """Drop the program's state (server, bundle, cache, graph)."""
        self.server = None


def sample_requests(finished: dict, seed: int, n: int = CHECK_REQUESTS) -> list:
    """The longest finished request and n - 1 others drawn from the seed."""
    ok = sorted((c for c in finished.values() if c.ok), key=lambda c: c.rid)
    if len(ok) <= n:
        return ok
    longest = max(ok, key=lambda c: (c.prompt_len + len(c.tokens), -c.rid))
    rest = [c for c in ok if c is not longest]
    return [longest] + [rest[i] for i in check.sample(len(rest), seed, n - 1)]


def compare(cfg: dict, mix: dict, seed: int, device, res: dict, quant: str | None = None) -> dict | None:
    ref = check.reference(cfg)
    sample = sample_requests(res["finished"], seed)
    if not sample:
        return None
    seqs = [torch.from_numpy(np.concatenate([res["prompts"][c.rid], c.tokens[:-1]]).astype(np.int64)).to(device)
            for c in sample]
    starts = [c.prompt_len - 1 for c in sample]
    weights = check.weights(cfg, seed, device)
    exact = ref.teacher_forced(cfg["model"], weights, seqs, starts)
    if quant is None:
        picked = [torch.from_numpy(c.tokens.astype(np.int64)).to(device) for c in sample]
    else:
        picked = [lg.argmax(-1) for lg in ref.teacher_forced(cfg["model"], weights, seqs, starts, quant=quant)]
    gaps = torch.cat([lg.max(-1).values - lg.gather(-1, tok[:, None])[:, 0] for lg, tok in zip(exact, picked)])
    return {"served_gap": float(gaps.max()), "served_gap_mean": float(gaps.mean())}


def tally(res: dict) -> tuple[int, int, dict]:
    """Requests sent and failed in the window, and what the window held."""
    failed = sum(not c.ok for c in res["finished"].values())
    return res["sent"], failed, {"steps": len(res["steps"]), "ttft": len(res["ttft_s"]), "itl": len(res["itl_s"]),
                                 "finished": len(res["finished"]), "window_s": res["window_s"]}
