"""FTContext — the fault-aware execution layer.

One object carries the fault-tolerance story of a model call:

  * the :class:`~repro_torch.core.engine.FaultState` and the optional
    :class:`~repro_torch.core.engine.RepairPlan` (swapped in place per
    serving change of either with :meth:`FTContext.swap`);
  * the :class:`~repro_torch.core.engine.HyCAConfig` (array geometry, DPPU
    capacity, off/protected/unprotected mode);
  * a :class:`ProtectPolicy` naming which call *sites* run on the protected
    array and which leading fraction of the layer stack is protected;
  * the dispatch: ``plain`` (no fault machinery), ``twopass`` (the engine's
    corrupt + overwrite + prune) or ``fused`` (one pass through
    :func:`~repro_torch.kernels.ft_matmul.ft_matmul`, or
    :func:`~repro_torch.kernels.ft_matmul.ft_matmul_batched` for the MoE
    expert einsums: the CUDA kernel for CUDA tensors, its plain twin for CPU
    tensors).

Models route every weight matmul through ``ftc.matmul(x, w, site=...)``, and
the batched expert matmuls through ``ftc.einsum(spec, x, w, site=...)``;
``ftc=None`` is :func:`plain_matmul` (``torch.matmul`` with ``jnp.matmul``'s
promotion of mixed float operands) / ``torch.einsum``.

Invariant: with ``mode="protected"`` and #faults <= DPPU capacity, every
dispatch is bit-exact with ``mode="off"``.

Device counters ride beside the step: ``with_ledger`` attaches the static
call ledger (:func:`repro_torch.obs.counters.trace_site_calls`),
``with_counters`` a :class:`~repro_torch.obs.counters.Counters`, and
``accumulate`` folds one step's increment, which :meth:`FTContext.increment`
holds in a tensor that a swap rewrites in place.

``abft_matmul`` adds the ABFT checksum lanes (``ProtectPolicy.abft``)
beside the data matmul.  Not in this slice (it raises
``NotImplementedError``): kernel-block autotuning.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.core.engine import (
    FaultState,
    HyCAConfig,
    RepairPlan,
    abft_checksums,
    fault_mask_grids,
    fault_meta_grid,
    hyca_matmul,
    validate_fault_state,
    validate_repair_plan,
)
from repro_torch.kernels.ft_matmul import ft_matmul, ft_matmul_batched
from repro_torch.obs.fallbacks import record_site_fallback

SITES = (
    "attn.qkv",   # Q/K/V projections
    "attn.out",   # attention output projection
    "ffn",        # dense FFN up/gate/down
    "moe.router", # MoE router logits
    "moe.expert", # batched per-expert matmuls
    "ssm.in",     # SSM/RWKV input-side projections
    "ssm.out",    # SSM/RWKV output projections
    "head",       # LM head
    "mm.proj",    # multimodal projector
)

DISPATCHES = ("plain", "twopass", "fused")

# Batched-weight einsum patterns FTContext.einsum understands (the MoE
# expert matmuls, activation-major and weight-transposed).
EINSUM_SPECS = ("becd,edf->becf", "becf,efd->becd")


@dataclasses.dataclass(frozen=True)
class ProtectPolicy:
    """Per-site / per-layer protection policy.

    ``sites``: which call sites run on the protected array (``None`` = all of
    :data:`SITES`).  ``layer_fraction``: leading fraction of the layer stack
    that runs protected; the remaining layers use plain matmuls.  ``abft``:
    :meth:`FTContext.abft_matmul` carries the ABFT checksum lanes.
    """

    sites: frozenset[str] | None = None
    layer_fraction: float = 1.0
    abft: bool = False

    def __post_init__(self):
        if self.sites is not None:
            unknown = set(self.sites) - set(SITES)
            if unknown:
                raise ValueError(f"unknown protection sites {sorted(unknown)}; known: {SITES}")
        if not 0.0 <= self.layer_fraction <= 1.0:
            raise ValueError(f"layer_fraction must be in [0, 1], got {self.layer_fraction}")

    def covers(self, site: str) -> bool:
        if site not in SITES:
            raise ValueError(f"unknown site {site!r}; known: {SITES}")
        return self.sites is None or site in self.sites

    def n_protected_layers(self, n_layers: int) -> int:
        return min(n_layers, int(math.ceil(self.layer_fraction * n_layers)))


def _as_2d(x: torch.Tensor) -> tuple[torch.Tensor, tuple[int, ...]]:
    lead = tuple(x.shape[:-1])
    return x.reshape(-1, x.shape[-1]), lead


@dataclasses.dataclass
class FTContext:
    """Fault-aware execution context.  Build with :func:`build_ftcontext`,
    which validates the fault table against the array geometry."""

    state: FaultState | None
    hyca: HyCAConfig
    policy: ProtectPolicy = dataclasses.field(default_factory=ProtectPolicy)
    dispatch: str = "twopass"
    # one RepairPlan for all sites, or {site: RepairPlan}
    plan: object = None
    # obs: a Counters, and the static call ledger accumulate() folds over
    counters: object = None
    ledger: tuple | None = None
    # per-plan AND/OR mask pairs of the fused epilogue, computed once per
    # context, not once per matmul, and one step's counter increment; both
    # are rewritten in place by :meth:`swap`
    _grids: list = dataclasses.field(default_factory=list, init=False, repr=False, compare=False)
    _increment: object = dataclasses.field(default=None, init=False, repr=False, compare=False)

    @property
    def mode(self) -> str:
        return self.hyca.mode

    @property
    def active(self) -> bool:
        """Does any matmul route through the fault-aware path at all?"""
        return self.state is not None and self.hyca.mode != "off"

    def protects(self, site: str) -> bool:
        return self.active and self.policy.covers(site)

    def n_protected_layers(self, n_layers: int) -> int:
        if not self.active:
            return 0
        return self.policy.n_protected_layers(n_layers)

    def with_state(self, state: FaultState | None) -> "FTContext":
        """Same context, new fault table, new mask grids."""
        return dataclasses.replace(self, state=state)

    def with_plan(self, plan) -> "FTContext":
        """Same context, new repair plan, new mask grids."""
        return dataclasses.replace(self, plan=plan)

    def swap(self, *, state: FaultState | None = None, plan=None) -> None:
        """This context, in place, with a new fault table and/or a new repair
        plan (``None``: keep the current one): the per-step serving update.

        The mask grids are a function of (state, plan).  Every held AND/OR
        pair is rebuilt now, eagerly, and copied into the pair's own tensors;
        a pair held for the outgoing plan (or, for a plan dict, that site's
        outgoing plan) is rebuilt for the incoming one and then held for it.
        The counter increment is rewritten the same way.  So code that holds
        these tensors (a captured CUDA graph reads fixed addresses) sees the
        new state and plan.  A new plan is validated first; a swap keeps the
        plan's structure (one plan, or a dict with the same sites)."""
        moved = {}
        if plan is not None and plan is not self.plan:
            old, new = self.plan, plan
            if isinstance(old, dict) != isinstance(new, dict) or (
                    isinstance(new, dict) and old.keys() != new.keys()):
                raise ValueError("a plan swap keeps the plan's structure: one RepairPlan, "
                                 "or a dict with the same sites")
            for p in (new.values() if isinstance(new, dict) else (new,)):
                validate_repair_plan(p, self.hyca.rows, self.hyca.cols)
            pairs = ((old[k], new[k]) for k in new) if isinstance(new, dict) else ((old, new),)
            moved = {id(o): n for o, n in pairs}
            self.plan = plan
        if state is not None:
            self.state = state
        for entry in self._grids:
            p = entry[0] = moved.get(id(entry[0]), entry[0])
            new_and, new_or = fault_mask_grids(fault_meta_grid(self.state, self.hyca, p))
            entry[1][0].copy_(new_and)
            entry[1][1].copy_(new_or)
        if self._increment is not None:
            self._increment.copy_(self._step_increment())

    def with_counters(self, counters) -> "FTContext":
        """Same context, new :class:`~repro_torch.obs.counters.Counters`."""
        return dataclasses.replace(self, counters=counters)

    def with_ledger(self, ledger) -> "FTContext":
        """Attach the static call ledger (:func:`~repro_torch.obs.counters.trace_site_calls`)
        that ``accumulate`` folds the counters over."""
        return dataclasses.replace(self, ledger=tuple(ledger))

    def _step_increment(self) -> torch.Tensor:
        from repro_torch.obs.counters import step_increment  # deferred: obs imports engine

        sites = SITES if self.counters is None else self.counters.sites
        return step_increment(self.ledger, self.state, self.plan, self.hyca, sites)

    def increment(self) -> torch.Tensor:
        """One step's counter increment under the current (state, plan,
        ledger), laid out as :meth:`Counters.fields` over :data:`SITES`.
        Built on the first call; the same tensor afterwards, rewritten in
        place by :meth:`swap`."""
        if self.ledger is None:
            raise ValueError("the counters need a call ledger; use with_ledger(trace_site_calls(...))")
        if self._increment is None:
            self._increment = self._step_increment()
        return self._increment

    def accumulate(self):
        """One step's accumulation: ``counters`` plus :meth:`increment`, as a
        new Counters.  Per-call stats depend only on (state, plan, geometry,
        shape), so folding the static ledger once per step is exact and
        leaves the decode step untouched."""
        if self.counters is None:
            raise ValueError("accumulate() needs counters; use with_counters(Counters.zero())")
        from repro_torch.obs.counters import Counters

        return Counters(self.counters.values + self.increment().to(self.counters.values.device),
                        self.counters.sites)

    def _plan_for(self, site: str) -> RepairPlan | None:
        if self.plan is None or isinstance(self.plan, RepairPlan):
            return self.plan
        return self.plan.get(site)

    # ------------------------------------------------------------------ #
    # op dispatch
    # ------------------------------------------------------------------ #
    def matmul(self, x: torch.Tensor, w: torch.Tensor, *, site: str) -> torch.Tensor:
        """``x @ w`` with ``x: (..., K)`` and ``w: (K, N)``, routed through the
        protected virtual array when the policy covers ``site``.  The result
        has ``x``'s dtype; an unprotected site's has the operands' promoted
        dtype, as ``jnp.matmul``'s."""
        if not self.protects(site):
            return plain_matmul(x, w)
        plan = self._plan_for(site)
        if self.dispatch == "plain":
            out = plain_matmul(x, w)
        elif self.dispatch == "twopass":
            out = hyca_matmul(x, w, self.state, cfg=self.hyca, plan=plan)
        elif self.dispatch == "fused":
            out = self._fused(x, w, plan, site=site)
        else:
            raise ValueError(f"unknown dispatch {self.dispatch!r}; known: {DISPATCHES}")
        return out.to(x.dtype)

    def abft_matmul(self, x: torch.Tensor, w: torch.Tensor, *, site: str,
                    wc: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor | None]:
        """:meth:`matmul` plus the ABFT checksum lanes carried through the
        array (``policy.abft``).  Returns ``(out, chk_row, chk_col)``.

        ``out`` is the very call :meth:`matmul` makes (under ``fused``, one
        ``ft_matmul`` launch); the lanes are computed beside it
        (:func:`~repro_torch.core.engine.abft_checksums`), so turning them on
        moves no output bit.  Both lanes are ``None`` when the policy does
        not cover the site or ``policy.abft`` is off; ``chk_col`` also needs
        ``wc``, the encode-time weight checksum
        (:func:`~repro_torch.core.engine.abft_encode`).  The lanes are
        corrupted element-granularly; under ``plain`` they see no fault
        state, because the data path sees none.  Syndromes and thresholds
        are :func:`repro_torch.transient.abft.abft_check`'s."""
        out = self.matmul(x, w, site=site)
        if not (self.protects(site) and self.policy.abft):
            return out, None, None
        state = None if self.dispatch == "plain" else self.state
        chk_row, chk_col = abft_checksums(x, w, state, cfg=self.hyca, plan=self._plan_for(site), wc=wc)
        return out, chk_row, chk_col

    def einsum(self, spec: str, x: torch.Tensor, w: torch.Tensor, *, site: str) -> torch.Tensor:
        """Batched-weight einsum through the protected array: the MoE expert
        matmuls of :data:`EINSUM_SPECS`, ``x (b, e, c, d)`` against ``w (e, d,
        n)``.  Each expert's matmul is one virtual-array execution over its
        ``(b·c, d)`` rows.  Under ``dispatch="fused"`` all experts go through
        one :func:`ft_matmul_batched` launch; ``twopass`` runs the engine per
        expert.  The spec is validated first, on every dispatch path.  The
        result has ``x``'s dtype."""
        if spec not in EINSUM_SPECS:
            raise ValueError(
                f"FTContext.einsum supports the expert-matmul patterns "
                f"{EINSUM_SPECS} only, got {spec!r}"
            )
        if not self.protects(site) or self.dispatch == "plain":
            return torch.einsum(spec, x, w)
        plan = self._plan_for(site)
        if self.dispatch == "fused":
            return self._fused_einsum(x, w, plan, site=site).to(x.dtype)
        return self._einsum_twopass(x, w, plan).to(x.dtype)

    def _einsum_twopass(self, x: torch.Tensor, w: torch.Tensor, plan: RepairPlan | None) -> torch.Tensor:
        b, e, c, d = x.shape
        xe = x.transpose(0, 1).reshape(e, b * c, d)
        out = torch.stack([hyca_matmul(xe[i], w[i], self.state, cfg=self.hyca, plan=plan)
                           for i in range(e)])
        return out.reshape(e, b, c, -1).transpose(0, 1)

    # ------------------------------------------------------------------ #
    # fused dispatch
    # ------------------------------------------------------------------ #
    def mask_grids(self, plan: RepairPlan | None) -> tuple[torch.Tensor, torch.Tensor]:
        """The (rows, cols) int32 AND/OR pair for ``plan`` under the current
        state: ``fault_meta_grid`` lowered by ``fault_mask_grids``.  Built on
        the first call for ``plan``; the same tensors afterwards."""
        for p, grids in self._grids:
            if p is plan:
                return grids
        grids = fault_mask_grids(fault_meta_grid(self.state, self.hyca, plan))
        self._grids.append([plan, grids])
        return grids

    def _fused(self, x: torch.Tensor, w: torch.Tensor, plan: RepairPlan | None = None,
               *, site: str = "?") -> torch.Tensor:
        if not x.dtype.is_floating_point or not w.dtype.is_floating_point:
            # the kernel accumulates f32; integer datapaths keep the engine's
            # exact int32 stuck-at semantics through the two-pass path
            record_site_fallback(site, "int-dtype-kernel")
            return hyca_matmul(x, w, self.state, cfg=self.hyca, plan=plan)
        x2, lead = _as_2d(x)
        and_grid, or_grid = self.mask_grids(plan)
        out = ft_matmul(x2, w, and_grid, or_grid, out_dtype=_store_dtype(x))
        return out.reshape(*lead, w.shape[-1])

    def _fused_einsum(self, x: torch.Tensor, w: torch.Tensor, plan: RepairPlan | None,
                      *, site: str) -> torch.Tensor:
        if not x.dtype.is_floating_point or not w.dtype.is_floating_point:
            record_site_fallback(site, "int-dtype-kernel")
            return self._einsum_twopass(x, w, plan)
        b, e, c, d = x.shape
        # (b, e, c, d) -> (e, b·c, d): a strided view when b·c rows have one
        # stride (c == 1 at decode), else a copy; the kernel reads strides
        xe = x.transpose(0, 1).reshape(e, b * c, d)
        and_grid, or_grid = self.mask_grids(plan)
        out = ft_matmul_batched(xe, w, and_grid, or_grid, out_dtype=_store_dtype(x))
        return out.reshape(e, b, c, -1).transpose(0, 1)


def _store_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype the fused kernels store for an ``x`` of this dtype: bf16
    operands get the kernel's own bf16 store (so the caller's ``.to(x.dtype)``
    launches nothing), every other dtype float32."""
    return torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32


def build_ftcontext(
    state: FaultState | None,
    hyca: HyCAConfig,
    *,
    policy: ProtectPolicy | None = None,
    dispatch: str = "twopass",
    plan=None,
    fused_block=None,
    autotune_shapes=None,
) -> FTContext:
    """Build an :class:`FTContext`.  The fused dispatch needs no backend
    choice here: :func:`~repro_torch.kernels.ft_matmul.ft_matmul` launches the
    CUDA kernel for CUDA tensors and its plain twin for CPU tensors.  The
    fault table and plan are validated against the array geometry now.

    ``fused_block``: ``None`` or ``"auto"`` (the reference's default); both
    take the kernels' fixed launch plan, the rule
    :func:`~repro_torch.kernels.ft_matmul.ft_plan` of shape, dtype and
    layout.  The port has no block autotuning, so an explicit block and
    ``autotune_shapes`` raise."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"unknown dispatch {dispatch!r}; known: {DISPATCHES}")
    if fused_block not in (None, "auto") or autotune_shapes:
        raise NotImplementedError(
            f"fused_block={fused_block!r}, autotune_shapes={autotune_shapes!r}: the port's kernels "
            "take no block; their launch plan is the fixed rule kernels/ft_matmul.py::ft_plan "
            "(pass fused_block=None or 'auto')"
        )
    policy = policy or ProtectPolicy()
    if state is not None:
        validate_fault_state(state, hyca.rows, hyca.cols)
    if plan is not None:
        for p in (plan.values() if isinstance(plan, dict) else (plan,)):
            validate_repair_plan(p, hyca.rows, hyca.cols)
    return FTContext(state=state, hyca=hyca, policy=policy, dispatch=dispatch, plan=plan)


def plain_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with ``jnp.matmul``'s promotion: float operands of two
    dtypes are both cast to the promoted one first (f32 x bf16 -> f32),
    where ``torch.matmul`` raises.  Operands of one dtype go straight to
    ``torch.matmul``."""
    if x.dtype != w.dtype and x.dtype.is_floating_point and w.dtype.is_floating_point:
        dt = torch.promote_types(x.dtype, w.dtype)
        return torch.matmul(x.to(dt), w.to(dt))
    return torch.matmul(x, w)


def site_matmul(ftc: FTContext | None, site: str) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """:func:`plain_matmul` when no context is threaded, else the
    context's dispatcher bound to one call site."""
    if ftc is None:
        return plain_matmul
    return lambda x, w: ftc.matmul(x, w, site=site)
