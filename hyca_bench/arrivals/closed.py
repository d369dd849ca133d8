"""A closed loop: ``clients`` clients, each sending its next request as
soon as its last one completes, due at that moment; every client's first
request is due at the window's start.  No think time."""
from __future__ import annotations


class Arrivals:
    def __init__(self, params: dict, seed: int):
        self.clients = params["clients"]
        self.started = False

    def due(self, now: float, completed: int) -> list[float]:
        """The due times of the requests to send at host time ``now``, after
        ``completed`` requests completed since the last call (the first
        call is the window's start)."""
        if not self.started:
            self.started = True
            return [now] * self.clients
        return [now] * completed
