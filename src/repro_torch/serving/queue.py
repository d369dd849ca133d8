"""Request queue for the fault-aware serving runtime.

Requests carry a prompt, a generation budget and an optional SLA deadline
(absolute step index by which the request must *finish*).  The queue is FIFO;
requests whose deadline can no longer be met are dropped at admission time
(cheaper than admitting work that is already dead) and surfaced through
``drained_expired`` so the metrics layer can count them against goodput.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (P,) int32 prompt tokens
    max_new_tokens: int
    arrival_step: int = 0
    deadline_step: int | None = None   # absolute step; None = no SLA
    eos_id: int | None = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens < 1")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)

    def min_steps_to_finish(self) -> int:
        """Lower bound on steps from admission to completion (prefill is one
        prompt token per step, then one generated token per step; the first
        generated token rides the final prefill step)."""
        return self.prompt_len + self.max_new_tokens - 1


@dataclasses.dataclass
class CompletedRequest:
    rid: int
    tokens: np.ndarray                 # generated tokens (may be empty)
    prompt_len: int
    arrival_step: int
    admitted_step: int | None
    first_token_step: int | None       # TTFT = first_token_step - arrival_step
    finish_step: int
    reason: str                        # "done" | "eos" | "expired" | "dropped"
    deadline_step: int | None = None   # the request's SLA deadline, if any

    @property
    def ok(self) -> bool:
        return self.reason in ("done", "eos")

    @property
    def slo_met(self) -> bool | None:
        """True/False for requests that carried an SLA deadline (finished
        successfully by the deadline, or not); None without one."""
        if self.deadline_step is None:
            return None
        return self.ok and self.finish_step <= self.deadline_step


class RequestQueue:
    """FIFO with SLA-aware admission."""

    def __init__(self):
        self._q: deque[Request] = deque()
        self._expired: list[Request] = []
        # optional EventLog (the server wires its own): request lifecycle
        # events correlate by rid
        self.log = None

    def submit(self, req: Request) -> None:
        self._q.append(req)
        if self.log is not None:
            self.log.emit(
                "request.enqueue", step=req.arrival_step,
                rid=req.rid, prompt_len=req.prompt_len,
            )

    def depth(self) -> int:
        return len(self._q)

    def __len__(self) -> int:
        return len(self._q)

    def pop_ready(self, step: int) -> Request | None:
        """Next request that can still meet its deadline if admitted now;
        unmeetable requests are dropped into the expired list.  A request
        admitted at ``step`` finishes no earlier than step
        ``step + min_steps_to_finish() - 1`` (the first prompt token is fed
        at the admission step itself)."""
        while self._q:
            req = self._q.popleft()
            if req.deadline_step is not None and step + req.min_steps_to_finish() - 1 > req.deadline_step:
                self._expired.append(req)
                if self.log is not None:
                    self.log.emit("request.complete", step=step,
                                  rid=req.rid, reason="expired", tokens=0)
                continue
            return req
        return None

    def drain_all(self) -> list[Request]:
        """Remove and return everything still queued (server shutdown)."""
        out = list(self._q)
        self._q.clear()
        return out

    def drained_expired(self) -> list[Request]:
        """Requests dropped for unmeetable deadlines since the last call."""
        out, self._expired = self._expired, []
        return out
