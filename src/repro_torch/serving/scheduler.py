"""Continuous batching: iteration-level scheduling over fixed decode slots.

Every server step runs ONE batched decode over all ``n_slots`` cache slots.
Each slot independently advances its own request through two phases:

  * PREFILL — the slot feeds its next prompt token each step (token-level
    chunked prefill: the prompt streams through the same decode path that
    generation uses, one token per step, against the slot's own KV cache).
    The logits of the *last* prompt token yield the first generated token,
    so TTFT is measured at that step.
  * DECODE — the slot feeds its previously generated token and appends the
    newly sampled one.

When a request finishes (budget, EOS, or SLA expiry) its slot frees and a
queued request is admitted on the *next* step — freed capacity is never idle
for more than one step.

Admission honours ``effective_slots``, the fault manager's degraded-capacity
signal: when confirmed faults exceed DPPU capacity the array loses its
rightmost columns and serving throughput shrinks; the scheduler reflects that
by capping how many slots may be active simultaneously.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serving.queue import CompletedRequest, Request, RequestQueue

PREFILL = "prefill"
DECODE = "decode"


@dataclasses.dataclass
class Slot:
    index: int
    request: Request | None = None
    phase: str = DECODE
    pos: int = 0                        # prompt tokens fed so far
    generated: list[int] = dataclasses.field(default_factory=list)
    admitted_step: int | None = None
    first_token_step: int | None = None

    @property
    def free(self) -> bool:
        return self.request is None

    def reset(self) -> None:
        self.request = None
        self.phase = DECODE
        self.pos = 0
        self.generated = []
        self.admitted_step = None
        self.first_token_step = None


class ContinuousBatchingScheduler:
    def __init__(self, n_slots: int, smax: int):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.n_slots = n_slots
        self.smax = smax
        self.slots = [Slot(i) for i in range(n_slots)]
        self.effective_slots = n_slots
        self.last_step_tokens = 0  # generated tokens appended by the last commit
        # optional EventLog (the server wires its own): admission,
        # prefill->decode transitions, and completions become request.* events
        # that correlate by rid into per-request lifecycles
        self.log = None

    # ------------------------------------------------------------------ #
    # capacity + admission
    # ------------------------------------------------------------------ #
    def set_effective_slots(self, n: int) -> None:
        self.effective_slots = int(np.clip(n, 0, self.n_slots))

    @property
    def active(self) -> int:
        return sum(not s.free for s in self.slots)

    def admit(self, queue: RequestQueue, step: int) -> tuple[list[Slot], list[CompletedRequest]]:
        """Fill free slots from the queue up to the effective capacity.
        Returns (admitted slots — their caches must be reset, rejections)."""
        admitted: list[Slot] = []
        rejected: list[CompletedRequest] = []
        for slot in self.slots:
            if self.active >= self.effective_slots:
                break
            if not slot.free:
                continue
            req = queue.pop_ready(step)
            while req is not None and req.min_steps_to_finish() + 1 > self.smax:
                # cannot fit in the KV cache; reject rather than overflow
                rejected.append(self._rejected(req, step))
                req = queue.pop_ready(step)
            if req is None:
                break
            slot.reset()
            slot.request = req
            slot.phase = PREFILL
            slot.admitted_step = step
            admitted.append(slot)
            if self.log is not None:
                self.log.emit("request.admit", step=step,
                              rid=req.rid, slot=slot.index)
        return admitted, rejected

    def _rejected(self, req: Request, step: int) -> CompletedRequest:
        if self.log is not None:
            self.log.emit("request.complete", step=step,
                          rid=req.rid, reason="dropped", tokens=0)
        return CompletedRequest(
            rid=req.rid, tokens=np.zeros(0, np.int32), prompt_len=req.prompt_len,
            arrival_step=req.arrival_step, admitted_step=None,
            first_token_step=None, finish_step=step, reason="dropped",
            deadline_step=req.deadline_step,
        )

    # ------------------------------------------------------------------ #
    # one batched step
    # ------------------------------------------------------------------ #
    def plan_feed(self) -> np.ndarray:
        """(n_slots, 1) int32 token to feed each slot this step."""
        feed = np.zeros((self.n_slots, 1), np.int32)
        for s in self.slots:
            if s.free:
                continue
            if s.phase == PREFILL:
                feed[s.index, 0] = s.request.prompt[s.pos]
            else:
                feed[s.index, 0] = s.generated[-1]
        return feed

    def commit(self, sampled: np.ndarray, step: int) -> list[CompletedRequest]:
        """Advance every active slot given this step's sampled tokens.
        Returns completions; their slots are already freed."""
        sampled = np.asarray(sampled).reshape(-1)
        done: list[CompletedRequest] = []
        self.last_step_tokens = 0
        for s in self.slots:
            if s.free:
                continue
            req = s.request
            if s.phase == PREFILL:
                s.pos += 1
                if s.pos < req.prompt_len:
                    if req.deadline_step is not None and step >= req.deadline_step:
                        done.append(self._finish(s, step, "expired"))
                    continue
                s.phase = DECODE
                s.first_token_step = step
                if self.log is not None:
                    self.log.emit("request.first_token", step=step, rid=req.rid)
            tok = int(sampled[s.index])
            s.generated.append(tok)
            self.last_step_tokens += 1
            if req.eos_id is not None and tok == req.eos_id:
                done.append(self._finish(s, step, "eos"))
            elif len(s.generated) >= req.max_new_tokens:
                done.append(self._finish(s, step, "done"))
            elif req.deadline_step is not None and step >= req.deadline_step:
                done.append(self._finish(s, step, "expired"))
        return done

    def _finish(self, s: Slot, step: int, reason: str) -> CompletedRequest:
        req = s.request
        if self.log is not None:
            self.log.emit("request.complete", step=step,
                          rid=req.rid, reason=reason, tokens=len(s.generated))
        out = CompletedRequest(
            rid=req.rid,
            tokens=np.asarray(s.generated, np.int32),
            prompt_len=req.prompt_len,
            arrival_step=req.arrival_step,
            admitted_step=s.admitted_step,
            first_token_step=s.first_token_step,
            finish_step=step,
            reason=reason,
            deadline_step=req.deadline_step,
        )
        s.reset()
        return out

    def drain(self, step: int) -> list[CompletedRequest]:
        """Force-finish everything still in flight (server shutdown)."""
        return [self._finish(s, step, "expired") for s in self.slots if not s.free]
