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
      5. batched decode        — ONE decode_step over all slots and its greedy
                                 argmax; every weight matmul of the protected
                                 layer fraction runs through the FTContext
                                 dispatcher (under ``dispatch="fused"``, the
                                 CUDA ``ft_matmul`` kernel), corrupted by
                                 whatever faults the runtime has not yet
                                 confirmed;
      6. commit                — prefill slots advance a prompt token, decode
                                 slots append the sampled token.

Mode is a *data* difference: all three modes run the same step, fed
different fault views — ``off`` an empty fault state, ``protected`` the truth
minus confirmed faults, ``unprotected`` the full truth.  With every fault
confirmed and #faults <= capacity, ``protected`` serves tokens bit-exact with
``off`` because both run the same kernels on the same data.

Step 5 is one CUDA graph replay on a card (:class:`CapturedStep`, the
counterpart of the reference's ``jax.jit(_step, donate_argnums=(1,))``).
Each server captures its own step, over its own KV cache, once, on its first
step; a fault-state swap, a submit, a slot reset or the mode never
recaptures, because the graph reads fixed buffers that these update in
place.  Under ``dispatch="fused"`` and ``"plain"`` the step is captured;
``"twopass"`` always runs eagerly, since its engine validates the fault
table on the host on every call, which a graph cannot hold.  On the CPU the
same step runs eagerly through the same buffers.

The decode syncs the host once, to read the sampled tokens (a protected
step's scan reads its flags and hit counters before it).

Past DPPU capacity, ``ServerConfig.repair="remap"`` turns over-capacity
confirmed faults REMAPPED: they stay in the served fault state while the
active RepairPlan prunes salience-chosen channels onto them.  The repair
hook swaps the plan into the bundle's context in place, like a fault state,
so the captured step serves it without a recapture.  ``counters`` adds one
device add a step (one graph node) of an increment rewritten per swap;
``series`` records one telemetry row a step with one asynchronous copy.

``abft`` adds the fault manager's ABFT canary to every scan step: host
numpy beside the probe, outside the captured graph, so it never recaptures
and moves no served bit.

``repair="retrain"`` adds a budgeted fine-tune of this server's f32 master
params to the remap hook (:func:`repro_torch.repair.retrain.retrain`, the
faulty array and the new plan in its forward).  The retrained params are
this server's own: its working copies are made from them, and its step
recaptures once over them (:meth:`CapturedStep.swap_params`), since the
captured graph read the bundle's shared copies at fixed addresses.  Every
other server on the bundle goes on serving the bundle's params.

The f32 masters live in host memory, for every bundle; the card holds the
working copies the step reads (:class:`ModelBundle`).  Their readers take
them where they need them: the remap salience reads them on the host, the
retrain hook copies them to the card for the fine-tune and keeps the
repaired masters on the host.
"""
from __future__ import annotations

import dataclasses
import gc
import os
import time
import weakref

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.engine import FaultState, HyCAConfig, empty_fault_state, identity_plan
from repro_torch.core.ftcontext import ProtectPolicy, build_ftcontext
from repro_torch.core.redundancy import DPPUConfig
from repro_torch.kernels.ft_matmul import COUNTERS, ft_matmul, ft_matmul_batched
from repro_torch.models.lm import (
    LMConfig, Params, cast_params, decode_step, init_cache, init_params, tree_map,
)
from repro_torch.obs.counters import Counters, trace_site_calls
from repro_torch.obs.events import EventLog
from repro_torch.obs.phases import PhaseClock
from repro_torch.obs.series import SeriesBuffer, record_step
from repro_torch.repair.plan import remap_plan
from repro_torch.repair.remap import weight_salience
from repro_torch.repair.retrain import RetrainConfig, retrain
from repro_torch.serving.fault_manager import FaultInjector, FaultManager, FaultManagerConfig
from repro_torch.serving.metrics import ServingMetrics, StepRecord
from repro_torch.serving.queue import CompletedRequest, Request, RequestQueue
from repro_torch.serving.scheduler import ContinuousBatchingScheduler
from repro_torch.tree import pick, tree_leaves


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
    # model-side remediation past DPPU capacity:
    #   none    — overflow faults RETIRE columns (throughput cliff)
    #   remap   — overflow columns are REMAPPED: a salience-chosen pruned
    #             residue class lands on them; the server keeps full slots
    #   retrain — remap plus a budgeted fault-aware fine-tune of this
    #             server's params
    repair: str = "none"
    retrain_steps: int = 4         # fine-tune budget when repair == "retrain"
    max_remap_fraction: float = 0.5
    counters: bool = False         # device counters, one add a step
    series: bool = False           # one telemetry row a step into a device ring
    series_capacity: int = 4096    # ring depth: the last N steps are resident
    abft: bool = False             # ABFT canary on every scan step (host, beside the probe)
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


HOST = torch.device("cpu")  # where every bundle's f32 masters live

# AdamW's fine-tune holds the f32 params, their gradients and both moments
RETRAIN_BYTES_PER_PARAM = 16


def device_bytes(device: torch.device) -> int:
    """The memory of ``device``: the card's, or the host's physical memory."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def check_retrain_fits(cfg: "ServerConfig", lm: LMConfig, device: torch.device) -> None:
    """Refuse ``repair="retrain"`` where the fine-tune cannot fit on
    ``device``: AdamW over the f32 masters needs
    :data:`RETRAIN_BYTES_PER_PARAM` bytes a param before any activation
    (deepseek-moe-16b at full width: 262 GB).  The count is taken on
    ``meta``, so the check allocates nothing."""
    if cfg.repair != "retrain" or cfg.retrain_steps <= 0:
        return
    need, have = RETRAIN_BYTES_PER_PARAM * lm.n_params(), device_bytes(device)
    if need > have:
        raise ValueError(
            f"{lm.name}: repair='retrain' fine-tunes the f32 masters with AdamW on {device}, "
            f"{need:,} bytes of params, gradients and moments against the device's {have:,}"
        )


def _host_and_work(dtype):
    """:func:`init_params`'s ``block_fn`` of a bundle: each leaf of a piece
    as it is drawn on the device becomes the pair (its f32 copy on the host,
    its ``dtype`` working copy on the device), as :func:`cast_params` makes
    it."""
    def one(a):
        return a.to(HOST), (a.to(dtype) if a.is_floating_point() else a)

    return lambda piece: tree_map(one, piece)


# the dispatches whose step a CUDA graph can hold, and the kernel wrappers a
# decode step launches
GRAPH_DISPATCHES = ("plain", "fused")
STEP_KERNELS = (ft_matmul, ft_matmul_batched)


_WARM_UP_STREAMS: dict[int, torch.cuda.Stream] = {}


def warm_up_stream(device: torch.device) -> torch.cuda.Stream:
    """The one side stream of ``device`` on which every capture runs its
    warm-up.  PyTorch keeps a cuBLAS workspace for each stream that has run
    a cuBLAS call, until the process ends, so a new stream for each capture
    would leave one workspace behind for each captured step."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _WARM_UP_STREAMS:
        _WARM_UP_STREAMS[idx] = torch.cuda.Stream(idx)
    return _WARM_UP_STREAMS[idx]


def graph_holds(device: torch.device, dispatch: str) -> bool:
    """Can a CUDA graph hold the decode step?  On a card, under the
    ``plain`` and ``fused`` dispatches.  Never under ``twopass``: its engine
    validates the fault table on the host on every call (a device-to-host
    read), which a capture cannot contain.  A fixed rule of the dispatch."""
    return device.type == "cuda" and dispatch in GRAPH_DISPATCHES


class CapturedStep:
    """One server's decode step, ``decode_step`` and the greedy argmax over
    one KV cache, through static buffers: ``tokens`` (n_slots, 1) in,
    ``logits`` (n_slots, 1, padded vocab) and ``sampled`` (n_slots,) int32
    out.

    With ``capture`` (by default wherever :func:`graph_holds`), the first
    call runs the step eagerly on a side stream, which is the warm-up, then
    captures it as one CUDA graph; every later call replays the graph.  The graph reads fixed addresses: the
    working params (the bundle's, until :meth:`swap_params`), this cache
    (advanced in place), the static buffers and the bundle's mask grids
    (rewritten in place by a fault-state swap).  A failed capture raises.  Without ``capture`` the same call runs the step
    eagerly through the same buffers; that is how the CPU runs it, and the
    comparison a captured step is held to.

    A replay calls no kernel wrapper, so it adds the launches each wrapper of
    :data:`STEP_KERNELS` counted while the step was captured to its
    counters (``launches``, ``tile_launches``: ``ft_matmul.COUNTERS``); the
    capture itself launches nothing and counts nothing.
    The counters keep counting the kernels launched on the card.

    A call runs in the host phase ``capture`` (the first call of a captured
    step) or ``replay`` of ``phases``, the clock of the server that owns the
    step (:mod:`repro_torch.obs.phases`); the captured body holds no span."""

    def __init__(self, bundle: "ModelBundle", cache: Params, *, capture: bool | None = None):
        dev, dispatch = bundle.device, bundle.cfg.dispatch
        if capture is None:
            capture = graph_holds(dev, dispatch)
        elif capture and not graph_holds(dev, dispatch):
            raise ValueError(f"a CUDA graph holds the step on a card under dispatch {GRAPH_DISPATCHES}, "
                             f"not on {dev} under {dispatch!r}")
        self.bundle, self.cache, self.capture = bundle, cache, capture
        self.params = bundle.work  # the working params the step reads
        n = bundle.cfg.n_slots
        self.tokens = torch.zeros((n, 1), dtype=torch.int32, device=dev)
        self.logits = torch.zeros((n, 1, bundle.lm.padded_vocab), dtype=bundle.lm.dtype, device=dev)
        self.sampled = torch.zeros((n,), dtype=torch.int32, device=dev)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.captures = self.replays = 0
        self.capture_s: float | None = None     # wall time of the capture
        self.pool_bytes: int | None = None      # device memory the capture reserved
        self.deltas: dict = {}                  # (wrapper, counter) -> launches a replay makes
        # the server's counters (Counters.values), when it keeps them: each
        # step adds the context's increment, one node of the graph
        self.counters: torch.Tensor | None = None
        # the host phase clock the call is timed on: the owning server's
        self.phases = PhaseClock()

    def swap_params(self, params: Params) -> None:
        """Read ``params`` (working copies in ``lm.dtype``) from the next
        call on.  A captured graph read the old ones at fixed addresses, so
        it is dropped and the next call warms up and captures again."""
        self.params = params
        self.graph = None

    def _body(self) -> None:
        b = self.bundle
        logits, _ = decode_step(self.params, b.lm, self.cache, {"token": self.tokens}, ftc=b.ftc)
        self.logits.copy_(logits)
        self.sampled.copy_(logits[:, -1, :].argmax(dim=-1))
        if self.counters is not None:
            self.counters.add_(b.ftc.increment())

    def __call__(self) -> None:
        if not self.capture:
            with self.phases.span("replay"):
                self._body()
        elif self.graph is None:
            with self.phases.span("capture"):
                self._warm_up_and_capture()
        else:
            with self.phases.span("replay"):
                self.graph.replay()
            self.replays += 1
            for (kernel, counter), n in self.deltas.items():
                setattr(kernel, counter, getattr(kernel, counter) + n)

    def _warm_up_and_capture(self) -> None:
        dev = self.bundle.device
        main = torch.cuda.current_stream(dev)
        side = warm_up_stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._body()  # this step's own work, run eagerly: the warm-up
        main.wait_stream(side)
        # torch.cuda.graph collects and empties the cache before it captures:
        # do it first, so the reserved bytes after the capture are its pool
        torch.cuda.synchronize(dev)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        counted = {(k, c): getattr(k, c) for k in STEP_KERNELS for c in COUNTERS}
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._body()
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.deltas = {(k, c): getattr(k, c) - n for (k, c), n in counted.items()}
        for (k, c), n in counted.items():
            setattr(k, c, n)
        self.graph = graph
        self.captures += 1


# --------------------------------------------------------------------------- #
# model pieces (shareable across servers)
# --------------------------------------------------------------------------- #
class ModelBundle:
    """Params + step/reset for one (arch, n_slots, smax, hyca) shape.

    ``params``: optional f32 master params in this package's layout (e.g.
    :func:`~repro_torch.models.lm.params_from_numpy` of the JAX params);
    default random from a ``torch.Generator`` of the device seeded with
    ``cfg.seed``, each piece handed on as it is drawn.  The masters
    (``params``) live in host memory; the ``lm.dtype`` working copies the
    step reads (``work``) are cast on the device, once.  So the card never
    holds the f32 tree: at most the working copies and one piece in f32
    (deepseek-moe-16b at full width: 32.75 GB and an MoE layer's 2.35 GB,
    where both copies would take 98.3 GB).

    The bundle holds one FTContext, whose fault table and repair plan are
    swapped in place, and one :class:`CapturedStep` per KV cache: each
    server owns its cache and its step, so servers of every mode and plan
    share one bundle, and each captures once."""

    def __init__(self, cfg: ServerConfig, lm: LMConfig | None = None, params: Params | None = None):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.lm = lm or get_smoke_config(cfg.arch)
        self.hyca = cfg.hyca()
        check_retrain_fits(cfg, self.lm, self.device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
            pairs = init_params(gen, self.lm, block_fn=_host_and_work(self.lm.dtype))
            self.params, self.work = pick(pairs, 0), pick(pairs, 1)
        else:
            self.params = tree_map(lambda a: a.to(HOST), params)
            self.work = cast_params(params, self.lm.dtype, device=self.device)
        self.max_faults = cfg.rows * cfg.cols
        self.empty_state = empty_fault_state(self.max_faults, device=self.device)
        # every step carries a plan: the identity until a repair hook swaps
        # in a remap plan
        self.identity_plan = identity_plan(cfg.rows, cfg.cols, device=self.device)
        self._salience: np.ndarray | None = None
        # one FTContext per bundle; the per-step fault table and plan are
        # swapped in place with swap, and the fused dispatch's AND/OR pair,
        # built here, keeps its tensors for the bundle's life
        self.ftc = build_ftcontext(
            self.empty_state, self.hyca,
            policy=ProtectPolicy(layer_fraction=cfg.protect_fraction),
            dispatch=cfg.dispatch,
            plan=self.identity_plan,
        )
        if cfg.dispatch == "fused":
            self.ftc.mask_grids(self.identity_plan)
        # a step swaps its fault table and plan into the context when they
        # are not the ones there; the server hands in the same objects until
        # the injector, the confirmed set or the plan changes, so the grids
        # are rebuilt once per swap rather than once per step
        self.swaps = 0
        self._steps = weakref.WeakValueDictionary()  # id(cache) -> CapturedStep

    @property
    def master_bytes(self) -> int:
        """Host bytes of the f32 masters."""
        return sum(a.numel() * a.element_size() for a in tree_leaves(self.params))

    @property
    def salience(self) -> np.ndarray:
        """Weight-norm salience per PE residue class of the f32 master params,
        the remap planner's importance signal.  Computed on the first repair:
        servers that never remap never pay the host sweep of the params."""
        if self._salience is None:
            self._salience = weight_salience(self.params, self.cfg.cols)
        return self._salience

    @property
    def ledger(self) -> tuple:
        """The decode step's static call ledger, recorded on the first call
        from one step on the ``meta`` device (shapes only) and attached to
        the context, whose counter increment folds it."""
        if self.ftc.ledger is None:
            def meta(a):
                return torch.empty_like(a, device="meta")

            n = self.cfg.n_slots
            self.ftc.ledger = trace_site_calls(
                lambda c, p, ch, t: decode_step(p, self.lm, ch, {"token": t}, ftc=c),
                self.ftc, tree_map(meta, self.work),
                init_cache(self.lm, n, self.cfg.smax, device="meta"),
                torch.zeros((n, 1), dtype=torch.int32, device="meta"),
            )
        return self.ftc.ledger

    def captured_step(self, cache: Params, *, capture: bool | None = None) -> CapturedStep:
        """The decode step over ``cache`` (:class:`CapturedStep`), made on
        the first call for that cache.  The caller keeps it alive (a server
        holds its own); the bundle keeps only a weak reference."""
        step = self._steps.get(id(cache))
        if step is None or step.cache is not cache:
            step = CapturedStep(self, cache, capture=capture)
            self._steps[id(cache)] = step
        return step

    def step_fn(self, params: Params, cache: Params, tok: torch.Tensor,
                fstate: FaultState, plan) -> tuple[torch.Tensor, Params]:
        """One decode step of ``cache``'s server: swap ``fstate`` and
        ``plan`` into the context if either changed, copy ``tok`` (n_slots,
        1) into the step's token buffer and run the step.  Returns (its
        logits buffer, ``cache`` updated in place); its sampled tokens are in
        ``captured_step(cache).sampled``."""
        step = self.captured_step(cache)
        if params is not step.params:
            raise ValueError("the step reads its own working params (CapturedStep.params: the bundle's "
                             "ModelBundle.work, or those a retrain repair swapped in)")
        with step.phases.span("feed"):
            if fstate is not self.ftc.state or plan is not self.ftc.plan:
                self.ftc.swap(state=fstate, plan=plan)
                self.swaps += 1
            step.tokens.copy_(tok)
        step()
        return step.logits, cache

    def reset_fn(self, cache: Params, slot: int) -> Params:
        """Zero one slot of the cache, every part of it, in place: each
        layer's KV cache (the main stack's and the first-k dense blocks'),
        and the encdec encoder output ``enc`` (B, enc_len, d) on its batch
        axis, as the reference's ``_reset`` does."""
        for part in cache.values():
            if isinstance(part, torch.Tensor):
                part[slot] = 0
                continue
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
    """``capture`` chooses how the decode step runs (:class:`CapturedStep`):
    None captures it as a CUDA graph wherever that can hold it (a card,
    dispatch ``fused`` or ``plain``) and runs it eagerly elsewhere; False
    runs it eagerly, the comparison the graph is held to."""

    def __init__(self, cfg: ServerConfig, *, bundle: ModelBundle | None = None,
                 injector: FaultInjector | None = None, capture: bool | None = None):
        if cfg.mode not in ("off", "protected", "unprotected"):
            raise ValueError(f"unknown mode {cfg.mode!r}")
        if cfg.repair not in ("none", "remap", "retrain"):
            raise ValueError(f"unknown repair mode {cfg.repair!r}")
        self.cfg = cfg
        if bundle is not None:
            check_retrain_fits(cfg, bundle.lm, bundle.device)
        self.bundle = bundle or ModelBundle(cfg)
        self.lm = self.bundle.lm
        self.device = self.bundle.device
        self.cache = self.bundle.fresh_cache()
        self.decode = self.bundle.captured_step(self.cache, capture=capture)
        # this server's view of the params: the f32 masters and the working
        # copies the step reads, the bundle's until a retrain repair swaps
        # in this server's own
        self.master_params = self.bundle.params
        self.params = self.bundle.work
        self.retrain_reports: list[dict] = []
        self.plan = self.bundle.identity_plan
        self._repair_key: tuple[int, int] | None = None
        # one event log per server, shared with the injector and the manager;
        # step() stamps the cursor
        self.log = EventLog()
        self.counters = None
        if cfg.counters:
            self.bundle.ledger  # recorded once per bundle, before the first step
            self.counters = Counters.zero(device=self.device)
            self.decode.counters = self.counters.values
        self.series = None
        self._n_scan_steps = 0
        if cfg.series:
            i32, f32 = torch.int32, torch.float32
            self.series = SeriesBuffer.create(cfg.series_capacity, {
                "tokens": ((), i32), "queue_depth": ((), i32),
                "active": ((), i32), "confirmed": ((), i32),
                "effective_slots": ((), i32), "true_faults": ((), i32),
                "surviving_cols": ((), i32),
                "scan_coverage": ((), f32), "capacity_fraction": ((), f32),
                "quality_fraction": ((), f32),
            }, device=self.device)
        self.injector = injector or FaultInjector(cfg.rows, cfg.cols, seed=cfg.seed + 1)
        self.injector.log = self.log
        self.manager = FaultManager(
            self.bundle.hyca, self.injector,
            FaultManagerConfig(
                confirm_hits=cfg.confirm_hits, scan_block=cfg.scan_block,
                remap=cfg.repair != "none", max_remap_fraction=cfg.max_remap_fraction,
                abft=cfg.abft,
            ),
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
        # the step's host phases are timed on this server's clock
        self.decode.phases = self.metrics.phases
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
        with self.metrics.phases.span("submit"):
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
    # the repair hook
    # ------------------------------------------------------------------ #
    def apply_repair(self, *, plan=None, params: Params | None = None) -> None:
        """Swap a repair plan and/or repaired f32 master params into the
        running server.  The next step swaps a plan into the bundle's context
        in place, with no recapture; params, wherever they are, become this
        server's own working copies, cast on its device, which its step
        recaptures over once, and its masters, kept on the host."""
        if plan is not None:
            self.plan = plan
        if params is not None:
            self.params = cast_params(params, self.lm.dtype, device=self.device)
            self.master_params = tree_map(lambda a: a.to(HOST), params)
            self.decode.swap_params(self.params)

    def _maybe_repair(self) -> None:
        if self.cfg.repair == "none" or self.cfg.mode != "protected":
            return
        key = (self.manager.n_confirmed, self.manager.n_remapped)
        if self.manager.n_remapped == 0 or key == self._repair_key:
            return
        self._repair_key = key
        # plan only the columns the manager REMAPPED: the overflow past the
        # max_remap_fraction budget is RETIRED (discarded with its region),
        # and pruning victims there would double-charge the quality
        plan = remap_plan(
            self.manager.confirmed_state, self.bundle.hyca, self.bundle.salience,
            broken_cols=self.manager.remapped_cols,
        )
        params = None
        if self.cfg.repair == "retrain" and self.cfg.retrain_steps > 0:
            t0 = time.perf_counter()
            # the fine-tune runs on the server's device: the host masters go there for it
            params, report = retrain(
                tree_map(lambda a: a.to(self.device), self.master_params), self.lm,
                hyca=self.bundle.hyca,
                state=self.manager.confirmed_state,
                plan=plan,
                rc=RetrainConfig(steps=self.cfg.retrain_steps, seq_len=min(32, self.cfg.smax),
                                 seed=self.cfg.seed),
            )
            # the report's losses were read on the host: the fine-tune has ended
            self.retrain_reports.append(dict(report, step=self.step_idx, seconds=time.perf_counter() - t0))
        self.apply_repair(plan=plan, params=params)
        self.log.emit(
            "repair.plan",
            step=self.step_idx,
            mode=self.cfg.repair,
            n_remapped=self.manager.n_remapped,
            remapped_cols=sorted(self.manager.remapped_cols),
            quality_fraction=self.manager.quality_fraction,
            retrained=params is not None,
        )

    @property
    def repair_events(self) -> list[dict]:
        """Repair-hook applications, as dicts (a view over the event log)."""
        return [dict(e.data, step=e.step) for e in self.log.of_kind("repair.plan")]

    def counters_host(self) -> dict | None:
        """Host-folded device counters (None when ``cfg.counters`` is off)."""
        return None if self.counters is None else self.counters.to_host()

    def series_host(self) -> dict | None:
        """Resident rows of the telemetry ring as host arrays, oldest first
        (None when ``cfg.series`` is off); ``series_start_step()`` gives the
        step of row 0."""
        if self.series is None:
            return None
        return self.series.harvest(start=self.series_start_step())

    def series_start_step(self) -> int:
        return 0 if self.series is None else max(0, self.series.written - self.series.capacity)

    # ------------------------------------------------------------------ #
    def step(self) -> list[CompletedRequest]:
        """One step of the loop (module docstring), each part of it timed in
        its host phase of ``metrics.phases`` (:mod:`repro_torch.obs.phases`)."""
        phases = self.metrics.phases
        with phases.span("step"):
            return self._step(phases)

    def _step(self, phases: PhaseClock) -> list[CompletedRequest]:
        cfg = self.cfg
        step = self.step_idx
        self.log.step = step
        completed: list[CompletedRequest] = []

        with phases.span("scan"):
            # 1. hardware wearout
            if cfg.mode != "off" and cfg.fault_rate > 0:
                self.injector.step(cfg.fault_rate)

            # 2. one batched row-block scan step per decode step
            scan_ok: bool | None = None
            if cfg.mode == "protected":
                scan_ok, _ = self.manager.scan_step()

        with phases.span("repair"):
            # 2b. the repair hook: newly REMAPPED faults rebuild the plan,
            # which this step swaps into the context
            self._maybe_repair()

            # 3. degraded capacity -> admission limit
            eff = self._effective_slots()
            self.scheduler.set_effective_slots(eff)

        with phases.span("admit"):
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

        # 5. one batched decode over all slots, and its greedy argmax
        with phases.span("feed"):
            feed = torch.from_numpy(self.scheduler.plan_feed())
            fstate = self._current_fstate()
        _, self.cache = self.bundle.step_fn(self.params, self.cache, feed, fstate, self.plan)
        with phases.span("sync"):
            # the step's one host sync
            sampled = self.decode.sampled.cpu().numpy()

        with phases.span("commit"):
            # 6. advance requests
            n_active = self.scheduler.active
            done = self.scheduler.commit(sampled, step)
            completed.extend(done)
            n_decode_tokens = self.scheduler.last_step_tokens

        with phases.span("record"):
            self._record(step, n_active, eff, int(n_decode_tokens), scan_ok, completed)
        self.step_idx += 1
        return completed

    def _record(self, step: int, n_active: int, eff: int, n_decode_tokens: int, scan_ok: bool | None,
                completed: list[CompletedRequest]) -> None:
        """The step's :class:`StepRecord` and, with ``series``, its row."""
        self.metrics.record_step(StepRecord(
            step=step,
            active_slots=n_active,
            effective_slots=eff,
            queue_depth=self.queue.depth(),
            tokens_generated=n_decode_tokens,
            confirmed_faults=self.manager.n_confirmed,
            true_faults=self.injector.n_faults,
            surviving_cols=self.manager.surviving_cols,
            scan_ok=scan_ok,
            completed=len(completed),
            remapped=self.manager.n_remapped,
            quality_fraction=self.manager.quality_fraction,
        ), completed)
        if scan_ok is not None:
            self._n_scan_steps += 1
        if self.series is not None:
            # every value is already on the host (the StepRecord uses them):
            # one asynchronous copy of the row, no sync
            record_step(self.series, {
                "tokens": n_decode_tokens,
                "queue_depth": self.queue.depth(),
                "active": n_active,
                "confirmed": self.manager.n_confirmed,
                "effective_slots": eff,
                "true_faults": self.injector.n_faults,
                "surviving_cols": self.manager.surviving_cols,
                "scan_coverage": min(1.0, self._n_scan_steps / max(self.metrics.steps_per_sweep, 1)),
                "capacity_fraction": float(self.manager.capacity_fraction),
                "quality_fraction": float(self.manager.quality_fraction),
            })

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
        return self.metrics.summary(counters=self.counters_host())

    def completions_by_rid(self) -> dict[int, np.ndarray]:
        return {c.rid: c.tokens for c in self.metrics.completions if c.ok}
