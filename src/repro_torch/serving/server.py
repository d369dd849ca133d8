"""Fault-tolerant continuous-batching inference server.

The step loop wires the scheduler and fault manager around one decode:

    every step:
      1. hardware wearout      — the injector may grow the fault map;
      2. one scan step         — the fault manager probes one row-block of
                                 PEs (``scan_block`` rows × all columns) on
                                 the CUDA probe kernel;
      3. capacity update       — confirmed faults beyond DPPU capacity shrink
                                 the surviving column prefix, and with it the
                                 number of decode slots admission may fill;
      4. admission             — freed slots take queued requests (their KV
                                 cache slots are zeroed in place);
      5. batched decode        — ONE decode_step over all slots; every weight
                                 matmul of the protected layer fraction runs
                                 through the FTContext dispatcher (under
                                 ``dispatch="fused"``, the CUDA ``ft_matmul``
                                 kernel), corrupted by whatever faults the
                                 runtime has not yet confirmed;
      6. commit                — prefill slots advance a prompt token, decode
                                 slots append the sampled token.

Mode is a *data* difference: all three modes run the same step, fed
different fault views — ``off`` an empty fault state, ``protected`` the truth
minus confirmed faults, ``unprotected`` the full truth.  With every fault
confirmed and #faults <= capacity, ``protected`` serves tokens bit-exact with
``off`` because both run the same kernels on the same data.

The step syncs the host once, to read the sampled tokens.

Not in this slice (they raise ``NotImplementedError``): ``repair`` modes
other than ``"none"``, device ``counters``, the telemetry ``series`` and the
``abft`` canary.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.engine import FaultState, HyCAConfig, empty_fault_state, identity_plan
from repro_torch.core.ftcontext import FTContext, ProtectPolicy, build_ftcontext
from repro_torch.core.redundancy import DPPUConfig
from repro_torch.models.lm import (
    LMConfig, Params, cast_params, decode_step, init_cache, init_params, tree_map,
)
from repro_torch.obs.events import EventLog
from repro_torch.serving.fault_manager import FaultInjector, FaultManager, FaultManagerConfig
from repro_torch.serving.metrics import ServingMetrics, StepRecord
from repro_torch.serving.queue import CompletedRequest, Request, RequestQueue
from repro_torch.serving.scheduler import ContinuousBatchingScheduler


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    arch: str = "qwen1.5-0.5b"
    n_slots: int = 4
    smax: int = 96                 # KV capacity per slot
    mode: str = "protected"        # off | protected | unprotected
    rows: int = 8                  # virtual PE array (serving-scale)
    cols: int = 8
    dppu_size: int = 4             # DPPU capacity ~= repairable faults
    protect_fraction: float = 1.0  # fraction of main-stack layers on the array
    dispatch: str = "twopass"      # plain | twopass | fused (FTContext dispatch)
    scan_block: int = 1            # PE-grid rows probed per scan step
    confirm_hits: int = 2
    bist: bool = True              # power-on: confirm the factory fault map
    boot_scan: bool = False        # probe-based power-on sweep instead
    fault_rate: float = 0.0        # Poisson new faults per step (wearout)
    repair: str = "none"           # none | remap | retrain (the latter two: repair slice)
    counters: bool = False         # device counters: observability slice
    series: bool = False           # telemetry ring: observability slice
    abft: bool = False             # ABFT canary: transients slice
    seed: int = 0
    device: str = "cuda"           # where params, cache and kernels live

    def hyca(self) -> HyCAConfig:
        # mode is fixed "unprotected": the *fault state fed per step* encodes
        # off/protected/unprotected, so all modes share one step
        return HyCAConfig(
            rows=self.rows, cols=self.cols,
            dppu=DPPUConfig(size=self.dppu_size, group_size=min(8, self.dppu_size)),
            mode="unprotected",
        )


def resolve_device(device: str) -> torch.device:
    """``device`` as a torch.device; asking for CUDA where there is none
    raises — the server never falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            f"pass device='cpu' to run the plain versions on the CPU"
        )
    return dev


# --------------------------------------------------------------------------- #
# model pieces (shareable across servers)
# --------------------------------------------------------------------------- #
class ModelBundle:
    """Params + step/reset for one (arch, n_slots, smax, hyca) shape.

    ``params``: optional f32 master params in this package's layout (e.g.
    :func:`~repro_torch.models.lm.params_from_numpy` of the JAX params);
    default random from a ``torch.Generator`` seeded with ``cfg.seed``.
    The ``lm.dtype`` working copies the step reads are made here, once."""

    def __init__(self, cfg: ServerConfig, lm: LMConfig | None = None, params: Params | None = None):
        if cfg.counters or cfg.series or cfg.abft:
            raise NotImplementedError(
                "counters and series come with the observability slice, abft with the transients slice"
            )
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.lm = lm or get_smoke_config(cfg.arch)
        self.hyca = cfg.hyca()
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
            params = init_params(gen, self.lm)
        self.params = tree_map(lambda a: a.to(self.device), params)
        self.work = cast_params(self.params, self.lm.dtype)
        self.max_faults = cfg.rows * cfg.cols
        self.empty_state = empty_fault_state(self.max_faults, device=self.device)
        # every step carries a plan (identity until the repair slice lands)
        self.identity_plan = identity_plan(cfg.rows, cfg.cols, device=self.device)
        # one FTContext per bundle; the per-step fault table is swapped in
        # with with_state
        self.ftc = build_ftcontext(
            self.empty_state, self.hyca,
            policy=ProtectPolicy(layer_fraction=cfg.protect_fraction),
            dispatch=cfg.dispatch,
            plan=self.identity_plan,
        )
        # (fault table, plan, context) of the last step: the server hands in
        # the same FaultState object until the injector or the confirmed set
        # changes, so the context, and the AND/OR grids it caches, are built
        # once per fault-state swap rather than once per step
        self._step_ftc: tuple[FaultState, object, FTContext] | None = None

    def step_fn(self, params: Params, cache: Params, tok: torch.Tensor,
                fstate: FaultState, plan) -> tuple[torch.Tensor, Params]:
        last = self._step_ftc
        if last is None or last[0] is not fstate or last[1] is not plan:
            last = (fstate, plan, self.ftc.with_state(fstate).with_plan(plan))
            self._step_ftc = last
        return decode_step(params, self.lm, cache, {"token": tok}, ftc=last[2])

    def reset_fn(self, cache: Params, slot: int) -> Params:
        """Zero one slot of every layer's KV cache, every part of it (the
        main stack's and the first-k dense blocks'), in place."""
        for part in cache.values():
            for layer in part:
                for t in layer.values():
                    t[slot] = 0
        return cache

    def fresh_cache(self) -> Params:
        return init_cache(self.lm, self.cfg.n_slots, self.cfg.smax, device=self.device)


# --------------------------------------------------------------------------- #
# the server
# --------------------------------------------------------------------------- #
class FaultTolerantServer:
    def __init__(self, cfg: ServerConfig, *, bundle: ModelBundle | None = None,
                 injector: FaultInjector | None = None):
        if cfg.mode not in ("off", "protected", "unprotected"):
            raise ValueError(f"unknown mode {cfg.mode!r}")
        if cfg.repair not in ("none", "remap", "retrain"):
            raise ValueError(f"unknown repair mode {cfg.repair!r}")
        if cfg.repair != "none":
            raise NotImplementedError(f"repair={cfg.repair!r} comes with the repair slice")
        self.cfg = cfg
        self.bundle = bundle or ModelBundle(cfg)
        self.lm = self.bundle.lm
        self.device = self.bundle.device
        self.cache = self.bundle.fresh_cache()
        self.params = self.bundle.work
        self.plan = self.bundle.identity_plan
        # one event log per server, shared with the injector and the manager;
        # step() stamps the cursor
        self.log = EventLog()
        self.injector = injector or FaultInjector(cfg.rows, cfg.cols, seed=cfg.seed + 1)
        self.injector.log = self.log
        self.manager = FaultManager(
            self.bundle.hyca, self.injector,
            FaultManagerConfig(confirm_hits=cfg.confirm_hits, scan_block=cfg.scan_block),
            device=self.device,
        )
        self.manager.log = self.log
        self.log.emit(
            "server.start", mode=cfg.mode, rows=cfg.rows, cols=cfg.cols,
            dppu=cfg.dppu_size, dispatch=cfg.dispatch, arch=self.lm.name,
        )
        self.queue = RequestQueue()
        self.scheduler = ContinuousBatchingScheduler(cfg.n_slots, cfg.smax)
        self.queue.log = self.log
        self.scheduler.log = self.log
        self.metrics = ServingMetrics(
            cfg.n_slots, cfg.rows, cfg.cols,
            steps_per_sweep=self.manager.steps_per_sweep,
            log=self.log,
        )
        self.step_idx = 0
        self._next_rid = 0
        self._fstate_key: tuple[int, int, int] | None = None
        self._fstate = self.bundle.empty_state
        if cfg.mode == "protected":
            if cfg.bist:
                self.manager.bist()
            elif cfg.boot_scan:
                self.manager.boot_scan()

    # ------------------------------------------------------------------ #
    def submit(self, prompt, max_new_tokens: int, *, deadline_step: int | None = None,
               eos_id: int | None = None, arrival_step: int | None = None) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.queue.submit(Request(
            rid=rid, prompt=np.asarray(prompt, np.int32),
            max_new_tokens=max_new_tokens,
            arrival_step=self.step_idx if arrival_step is None else arrival_step,
            deadline_step=deadline_step, eos_id=eos_id,
        ))
        return rid

    @property
    def retired(self) -> bool:
        """Degraded to zero surviving columns — the replica cannot serve."""
        return self.cfg.mode == "protected" and self.manager.surviving_cols == 0

    def _current_fstate(self) -> FaultState:
        if self.cfg.mode == "off":
            return self.bundle.empty_state
        key = (self.injector.version, self.manager.n_confirmed, self.manager.n_remapped)
        if key != self._fstate_key:
            if self.cfg.mode != "protected":
                exclude = frozenset()
            else:
                # repaired faults are DPPU-recomputed and retired faults are
                # disconnected with their column region — both clean.  The
                # bundle's HyCAConfig is mode="unprotected", so DPPU repair is
                # modelled by this exclusion alone.
                exclude = self.manager.repaired_coords() | self.manager.retired_coords()
            self._fstate = self.injector.fault_state(
                exclude=exclude, max_faults=self.bundle.max_faults, device=self.device,
            )
            self._fstate_key = key
        return self._fstate

    def _effective_slots(self) -> int:
        if self.cfg.mode != "protected":
            return self.cfg.n_slots
        frac = self.manager.capacity_fraction
        if frac >= 1.0:
            return self.cfg.n_slots
        if self.manager.surviving_cols == 0:
            return 0
        return max(1, int(np.floor(self.cfg.n_slots * frac)))

    # ------------------------------------------------------------------ #
    def step(self) -> list[CompletedRequest]:
        cfg = self.cfg
        step = self.step_idx
        self.log.step = step
        completed: list[CompletedRequest] = []

        # 1. hardware wearout
        if cfg.mode != "off" and cfg.fault_rate > 0:
            self.injector.step(cfg.fault_rate)

        # 2. one batched row-block scan step per decode step
        scan_ok: bool | None = None
        if cfg.mode == "protected":
            scan_ok, _ = self.manager.scan_step()

        # 3. degraded capacity -> admission limit
        eff = self._effective_slots()
        self.scheduler.set_effective_slots(eff)

        # 4. admission into freed slots (reset their KV cache slots)
        admitted, rejected = self.scheduler.admit(self.queue, step)
        completed.extend(rejected)
        for req in self.queue.drained_expired():
            completed.append(CompletedRequest(
                rid=req.rid, tokens=np.zeros(0, np.int32), prompt_len=req.prompt_len,
                arrival_step=req.arrival_step, admitted_step=None,
                first_token_step=None, finish_step=step, reason="expired",
                deadline_step=req.deadline_step,
            ))
        for slot in admitted:
            self.cache = self.bundle.reset_fn(self.cache, slot.index)

        # 5. one batched decode over all slots
        feed = torch.from_numpy(self.scheduler.plan_feed()).to(self.device)
        logits, self.cache = self.bundle.step_fn(
            self.params, self.cache, feed, self._current_fstate(), self.plan,
        )
        # the step's one host sync
        sampled = logits[:, -1, :].argmax(dim=-1).to(torch.int32).cpu().numpy()

        # 6. advance requests
        n_active = self.scheduler.active
        done = self.scheduler.commit(sampled, step)
        completed.extend(done)
        n_decode_tokens = self.scheduler.last_step_tokens

        self.metrics.record_step(StepRecord(
            step=step,
            active_slots=n_active,
            effective_slots=eff,
            queue_depth=self.queue.depth(),
            tokens_generated=int(n_decode_tokens),
            confirmed_faults=self.manager.n_confirmed,
            true_faults=self.injector.n_faults,
            surviving_cols=self.manager.surviving_cols,
            scan_ok=scan_ok,
            completed=len(completed),
            remapped=self.manager.n_remapped,
            quality_fraction=self.manager.quality_fraction,
        ), completed)
        self.step_idx += 1
        return completed

    # ------------------------------------------------------------------ #
    def run(self, trace: list[dict] | None = None, *, max_steps: int = 256,
            drain: bool = True, on_step=None) -> dict:
        """Drive the server over a request trace.

        ``trace``: list of {"step", "prompt", "max_new_tokens", ...} dicts;
        requests are submitted when the loop reaches their arrival step.
        Runs until the trace is exhausted and all work is done (or
        ``max_steps``).  ``on_step(server)`` runs at the top of every loop
        iteration (e.g. to inject faults mid-run).  Returns the metrics
        summary."""
        trace = sorted(trace or [], key=lambda t: t.get("step", 0))
        ti = 0
        while self.step_idx < max_steps:
            self.log.step = self.step_idx
            if on_step is not None:
                on_step(self)
            while ti < len(trace) and trace[ti].get("step", 0) <= self.step_idx:
                t = trace[ti]
                self.submit(
                    t["prompt"], t["max_new_tokens"],
                    deadline_step=t.get("deadline_step"), eos_id=t.get("eos_id"),
                )
                ti += 1
            self.step()
            no_work = ti >= len(trace) and self.queue.depth() == 0 and self.scheduler.active == 0
            if no_work or (self.retired and self.scheduler.active == 0):
                break
        if drain:
            self.metrics.completions.extend(self.scheduler.drain(self.step_idx))
            # never-admitted requests count as failures, not silence
            for req in self.queue.drain_all():
                self.log.emit("request.complete", step=self.step_idx,
                              rid=req.rid, reason="dropped", tokens=0)
                self.metrics.completions.append(CompletedRequest(
                    rid=req.rid, tokens=np.zeros(0, np.int32), prompt_len=req.prompt_len,
                    arrival_step=req.arrival_step, admitted_step=None,
                    first_token_step=None, finish_step=self.step_idx, reason="dropped",
                    deadline_step=req.deadline_step,
                ))
        self.metrics.finish()
        return self.metrics.summary()

    def completions_by_rid(self) -> dict[int, np.ndarray]:
        return {c.rid: c.tokens for c in self.metrics.completions if c.ok}
