"""Router counters of an expert layer that holds a share of the experts
(``MoEConfig.experts_held``): every pick the router made, the picks that
landed on the held experts, and the held picks dropped past an expert's
capacity.  Each MoE call adds its three counts on the device, in place, to
one int64 tensor a device: no sync in the step, and a captured step adds
them on every replay.  :func:`totals` reads them (one sync).  Layers that
hold every expert count nothing.
"""
from __future__ import annotations

import torch

FIELDS = ("picks", "held_picks", "held_dropped")

_TALLY: dict[torch.device, torch.Tensor] = {}


def _key(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def add(picks: torch.Tensor, held: torch.Tensor, dropped: torch.Tensor) -> None:
    """Add one call's counts (0-dim int64 tensors on one device)."""
    t = _TALLY.get(picks.device)
    if t is None:
        t = _TALLY[picks.device] = torch.zeros(len(FIELDS), dtype=torch.int64, device=picks.device)
    t.add_(torch.stack([picks, held, dropped]))


def totals(device) -> dict[str, int] | None:
    """{field: count} on ``device`` since the last :func:`reset`; None
    where no share layer ran there."""
    t = _TALLY.get(_key(device))
    return None if t is None else dict(zip(FIELDS, (int(v) for v in t.tolist())))


def reset(device) -> None:
    """Zero ``device``'s counts in place (a captured step keeps adding to
    the same tensor)."""
    t = _TALLY.get(_key(device))
    if t is not None:
        t.zero_()
