"""Device-side FT counters: exact fault, recompute and dispatch accounting.

A :class:`Counters` is one int32 tensor on the device (named views of its
entries), carried by a server or an FTContext (``ftc.with_counters``).  Every
count of a step depends only on (fault state, plan, array geometry, output
shapes), never on the activations.  So the step's call profile, the *ledger*,
is recorded once per (model, shapes) by :func:`trace_site_calls`, and one
step's increment (:func:`step_increment`) is computed from the live state and
plan once per swap of either.  Applying it is one tensor add a step: inside
a captured decode step it is one graph node, and nothing is read back until
:meth:`Counters.to_host`.

The port's decode step walks its layers in a Python loop, so one recorded
call of the step sees every matmul of every layer: the ledger needs no scan
multiplicities.  The recording runs the step on the ``meta`` device (shapes
only, no memory, no compute) with a stand-in context that notes each call.

Counts are int32 and wrap as the reference's do; fold them to host ints
(``to_host``) before long-horizon aggregation.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.core.engine import HyCAConfig, RepairPlan, _pe_multiplicity, protected_view_stats

# element-count fields, accumulated from protected_view_stats
STAT_FIELDS = (
    "total_elems",
    "fault_elems",
    "recomputed_elems",
    "corrupted_elems",
    "pruned_elems",
    "fault_col_elems",
)
CALL_FIELDS = ("steps", "protected_calls", "plain_calls")


@dataclasses.dataclass(frozen=True)
class SiteCall:
    """One ledger entry: a protected-or-plain matmul call site with its
    flattened output shape and calls per step (expert batch included)."""

    site: str
    m: int              # flattened leading dim of the output view
    n: int              # output channels
    count: int          # calls per step with this (site, shape)
    dispatch: str       # resolved dispatch: plain | twopass | fused
    protected: bool     # routed through the fault-aware engine path


def _default_sites() -> tuple[str, ...]:
    from repro_torch.core.ftcontext import SITES  # deferred: ftcontext imports this module

    return SITES


class Counters:
    """The counters: one int32 tensor, laid out as :data:`CALL_FIELDS`, then
    :data:`STAT_FIELDS`, then one call count per site.  Each name reads as a
    0-d view (``c.steps``, ``c.site_calls["ffn"]``)."""

    def __init__(self, values: torch.Tensor, sites: tuple[str, ...]):
        self.values = values
        self.sites = tuple(sites)

    @staticmethod
    def fields(sites: tuple[str, ...]) -> tuple[str, ...]:
        return CALL_FIELDS + STAT_FIELDS + tuple(f"site:{s}" for s in sites)

    @classmethod
    def zero(cls, sites: tuple[str, ...] | None = None, *, device="cpu") -> "Counters":
        sites = _default_sites() if sites is None else tuple(sites)
        return cls(torch.zeros(len(cls.fields(sites)), dtype=torch.int32, device=device), sites)

    def __getattr__(self, name: str) -> torch.Tensor:
        fields = CALL_FIELDS + STAT_FIELDS
        if name in fields:
            return self.values[fields.index(name)]
        raise AttributeError(name)

    @property
    def site_calls(self) -> dict[str, torch.Tensor]:
        base = len(CALL_FIELDS + STAT_FIELDS)
        return {s: self.values[base + i] for i, s in enumerate(self.sites)}

    def to_host(self) -> dict:
        """Fold to a plain host dict: ints plus derived fractions.  The only
        device-to-host read of the counters."""
        v = dict(zip(self.fields(self.sites), self.values.cpu().tolist()))
        d = {f: v[f] for f in CALL_FIELDS}
        d["site_calls"] = {s: v[f"site:{s}"] for s in sorted(self.sites)}
        for f in STAT_FIELDS:
            d[f] = v[f]
        total = d["total_elems"]
        for f in ("fault_elems", "recomputed_elems", "corrupted_elems", "pruned_elems"):
            d[f.replace("_elems", "_fraction")] = d[f] / total if total else 0.0
        return d


# --------------------------------------------------------------------------- #
# ledger discovery
# --------------------------------------------------------------------------- #
class _LedgerRecorder:
    """Stand-in context for one recorded call of a step: the protection
    decisions of ``ftc`` (``active``, ``protects``, ``n_protected_layers``),
    plain matmuls in place of the fault path, and one row per call."""

    def __init__(self, ftc):
        self.ftc = ftc
        self.rows: list[SiteCall] = []

    @property
    def active(self) -> bool:
        return self.ftc.active

    def protects(self, site: str) -> bool:
        return self.ftc.protects(site)

    def n_protected_layers(self, n_layers: int) -> int:
        return self.ftc.n_protected_layers(n_layers)

    def _note(self, site: str, m: int, n: int, count: int) -> None:
        protected = self.ftc.protects(site) and self.ftc.dispatch != "plain"
        self.rows.append(SiteCall(site, int(m), int(n), int(count),
                                  self.ftc.dispatch if protected else "plain", protected))

    def matmul(self, x: torch.Tensor, w: torch.Tensor, *, site: str) -> torch.Tensor:
        from repro_torch.core.ftcontext import plain_matmul

        self._note(site, math.prod(x.shape[:-1]), w.shape[-1], 1)
        return plain_matmul(x, w)

    def einsum(self, spec: str, x: torch.Tensor, w: torch.Tensor, *, site: str) -> torch.Tensor:
        from repro_torch.core.ftcontext import EINSUM_SPECS

        if spec not in EINSUM_SPECS:
            raise ValueError(f"FTContext.einsum supports {EINSUM_SPECS} only, got {spec!r}")
        # (b, e, c, d): each of the e experts is one (b·c, n) execution
        self._note(site, x.shape[0] * x.shape[2], w.shape[-1], x.shape[1])
        return torch.einsum(spec, x, w)


def trace_site_calls(fn: Callable, ftc, *args, **kwargs) -> tuple[SiteCall, ...]:
    """The static call ledger of ``fn(ftc, *args, **kwargs)``.

    Calls ``fn`` once with a stand-in for ``ftc`` that records every
    ``matmul``/``einsum`` as a (site, shape, dispatch) row and computes plain
    matmuls; pass ``meta`` tensors to record shapes only.  Identical rows are
    merged with summed counts and sorted, so a 24-layer stack contributes one
    entry per distinct (site, shape)."""
    rec = _LedgerRecorder(ftc)
    fn(rec, *args, **kwargs)
    merged: dict[tuple, int] = {}
    for c in rec.rows:
        key = (c.site, c.m, c.n, c.dispatch, c.protected)
        merged[key] = merged.get(key, 0) + c.count
    return tuple(
        SiteCall(site=k[0], m=k[1], n=k[2], count=v, dispatch=k[3], protected=k[4])
        for k, v in sorted(merged.items(), key=lambda kv: kv[0])
    )


# --------------------------------------------------------------------------- #
# accumulation
# --------------------------------------------------------------------------- #
def _plan_for(plan, site: str) -> RepairPlan | None:
    if plan is None or isinstance(plan, RepairPlan):
        return plan
    return plan.get(site)


def step_increment(ledger: tuple, state, plan, hyca: HyCAConfig, sites: tuple[str, ...],
                   *, device=None) -> torch.Tensor:
    """One step's increment of the counters, laid out as
    :meth:`Counters.fields`: every ledger entry's element-exact engine stats
    from the live (state, plan), times its calls per step, in int32 (the
    reference's wrapping sums, mod 2**32).  Device ops only, no host read."""
    device = state.device if device is None and state is not None else device
    fields = Counters.fields(sites)
    calls = np.zeros(len(fields), np.int64)
    calls[0] = 1
    stats = []
    for call in ledger:
        if call.site in sites:
            calls[fields.index(f"site:{call.site}")] += call.count
        if call.protected:
            calls[1] += call.count
            s = protected_view_stats(state, hyca, _plan_for(plan, call.site), call.m, call.n)
            stats.append(torch.stack([s[f] for f in STAT_FIELDS]).long() * call.count)
        else:
            calls[2] += call.count
            calls[len(CALL_FIELDS)] += call.m * call.n * call.count
    inc = torch.from_numpy(calls).to(device)
    if stats:
        base = len(CALL_FIELDS)
        inc[base:base + len(STAT_FIELDS)] += torch.stack(stats).sum(dim=0)
    return inc.to(torch.int32)


def ledger_stats(ledger: tuple, counters: Counters, state, plan, hyca: HyCAConfig) -> Counters:
    """One step's accumulation: ``counters`` plus :func:`step_increment`, as
    a new :class:`Counters`."""
    inc = step_increment(ledger, state, plan, hyca, counters.sites, device=counters.values.device)
    return Counters(counters.values + inc, counters.sites)


def elems_on_coords(ledger: tuple, coords, rows: int, cols: int) -> int:
    """Host: output elements per step mapped onto a PE coordinate set (e.g.
    the manager's repaired set, the DPPU's recompute volume a step)."""
    total = 0
    mask = np.zeros((rows, cols), bool)
    for r, c in coords:
        mask[r, c] = True
    for call in ledger:
        if call.protected:
            total += int((_pe_multiplicity(call.m, call.n, rows, cols) * mask).sum()) * call.count
    return total
