"""Op statistics of an eager trace: FLOPs, bytes, collective bytes, op counts.

The reference parses the compiled HLO text (its name is kept here so a
reader finds the counterpart).  The port has no HLO: :class:`OpTrace`, a
``TorchDispatchMode``, records every aten op a step runs, ``meta`` tensors
included, so a full-width step is counted without storage:

  * FLOPs with ``torch.utils.flop_counter``'s formulas (matmuls,
    convolutions, attention kernels; elementwise ops count 0, as there);
  * bytes as the ``nbytes`` of the op's tensor inputs plus its outputs.  A
    view (``view``, ``transpose``, ``detach``, ``_unsafe_view``, …) moves
    nothing and counts 0.  A gather (``index``, ``embedding``, …) reads only
    the rows it returns: it counts its output twice and its indices.  An
    in-place indexed write (``index_put_``, ``scatter_``, …) writes only as
    many bytes as it reads: it counts its tensor inputs but ``self`` twice.
    This is an *unfused* eager count: what the port's eager and captured
    steps really move, each op reading its inputs from and writing its
    outputs to device memory.  It is larger than XLA's post-fusion "bytes
    accessed", which keeps fused intermediates on chip;
  * every ``_c10d_functional`` / ``c10d_functional`` collective, with its
    result bytes and group size, which :func:`collective_stats` turns into
    ring wire bytes per device with the reference's factors.

On DTensors the trace counts what one device does, as the reference's
compiled SPMD module does.  It lets DTensor dispatch an op first (it returns
``NotImplemented`` for it, as ``CommDebugMode`` does), so it records the ops
DTensor runs on the local shards: FLOPs and bytes of each device's part,
and every collective, those a redistribution issues inside an op's own
dispatch included.  DTensor's own bookkeeping is left out: the sharding
propagation's global-shape runs on ``FakeTensor``s, and the index
arithmetic on tensors of another device than the local shards' (on the
``meta`` mesh of the dry run, host tensors).
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)
# the functional collectives' op names -> the reference's kinds
_C10D_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_C10D_NAMESPACES = ("_c10d_functional", "c10d_functional")


# wire bytes per device for a ring implementation, as a multiple of the
# RESULT size (g = group size):  AR moves 2·(g-1)/g · size,  AG (g-1)/g of the
# result, RS (g-1)/g of the (larger) input ≈ (g-1)·result, A2A (g-1)/g,
# permute exactly the result.
def _wire_factor(kind: str, g: int) -> float:
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g
    if kind == "all-gather":
        return (g - 1) / g
    if kind == "reduce-scatter":
        return float(g - 1)
    if kind == "all-to-all":
        return (g - 1) / g
    if kind == "collective-permute":
        return 1.0
    return 1.0


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One op of a trace: ``name`` is the aten overload (``aten.mm.default``),
    ``op`` its packet's name (``mm``); ``collective`` the reference's kind of
    a collective (None for any other op) and ``group_size`` its group."""
    name: str
    op: str
    flops: int
    bytes: int
    collective: str | None = None
    group_size: int | None = None


# ops that alias their input without the schema saying so
_NO_COPY = ("_unsafe_view", "alias", "lift_fresh", "wait_tensor", "_wrap_tensor_autograd")
# gathers: they read the rows they return
_GATHERS = ("index", "index_select", "gather", "embedding", "take")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _moved(func, args, kwargs, ins: list[torch.Tensor], outs: list[torch.Tensor]) -> int:
    """The bytes an op moves (see the module's docstring); ``ins`` and
    ``outs`` are its tensor inputs and outputs."""
    name = func._overloadpacket.__name__
    if func.is_view or name in _NO_COPY:
        return 0
    out_bytes = sum(_nbytes(t) for t in outs)
    if name in _GATHERS:
        idx = sum(_nbytes(t) for t in _tensors((args[1:], kwargs)) if not t.is_floating_point())
        return 2 * out_bytes + idx
    if name.endswith("_") and (name.startswith(("index_put", "scatter", "index_copy", "index_add", "_index_put"))):
        return 2 * sum(_nbytes(t) for t in _tensors((args[1:], kwargs)))
    return sum(_nbytes(t) for t in ins) + out_bytes


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of an op's arguments or outputs (nested tuples, lists and
    dicts), in order; a hand-rolled walk, it runs for every op traced."""
    found: list[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            found.append(x)
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)

    walk(tree)
    return found


def _group_size(func, args, kwargs) -> int | None:
    """The group size a functional collective names, or that of the process
    group it names."""
    vals = {a.name: (args[i] if i < len(args) else kwargs.get(a.name))
            for i, a in enumerate(func._schema.arguments)}
    if vals.get("group_size") is not None:
        return int(vals["group_size"])
    if vals.get("group_name") is not None:
        from torch.distributed.distributed_c10d import _resolve_process_group

        return _resolve_process_group(vals["group_name"]).size()
    return None


@functools.cache
def _dtensor_class():
    if not torch.distributed.is_available():
        return None
    from torch.distributed.tensor import DTensor

    return DTensor


class OpTrace(TorchDispatchMode):
    """Records every aten op run under it as an :class:`OpRecord`; on
    DTensors, every op one device runs (see the module's docstring)."""

    def __init__(self):
        super().__init__()
        self.records: list[OpRecord] = []
        self._local_device: torch.device | None = None  # the local shards' device, once a DTensor is seen

    def _bookkeeping(self, tensors: list[torch.Tensor]) -> bool:
        if any(isinstance(t, FakeTensor) for t in tensors):
            return True
        dev = self._local_device
        return dev is not None and bool(tensors) and all(t.device != dev for t in tensors)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        dt = _dtensor_class()
        if dt is not None and any(issubclass(t, dt) for t in types):
            if self._local_device is None:
                self._local_device = next(a for a in _tensors((args, kwargs))
                                          if isinstance(a, dt))._local_tensor.device
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if self._bookkeeping(ins + outs):
            return out
        packet = func._overloadpacket
        formula = flop_registry.get(packet)
        flops = int(formula(*args, **kwargs, out_val=out)) if formula is not None else 0
        moved = _moved(func, args, kwargs, ins, outs)
        kind = group = None
        if func.namespace in _C10D_NAMESPACES and packet.__name__ in _C10D_KINDS:
            kind = _C10D_KINDS[packet.__name__]
            group = _group_size(func, args, kwargs)
            moved = sum(_nbytes(t) for t in outs)  # the result's bytes
        self.records.append(OpRecord(str(func), packet.__name__, flops, moved, kind, group))
        return out

    @property
    def flops(self) -> int:
        return sum(r.flops for r in self.records)

    @property
    def bytes(self) -> int:
        return sum(r.bytes for r in self.records if r.collective is None)


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    result_bytes: dict     # per kind, result-shape bytes (per device)
    wire_bytes: dict       # per kind, ring wire bytes (per device)

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())

    @property
    def total_result_bytes(self) -> int:
        return sum(self.result_bytes.values())


def _records(trace) -> list[OpRecord]:
    return trace.records if isinstance(trace, OpTrace) else list(trace)


def collective_stats(trace, n_devices: int) -> CollectiveStats:
    """Counts, result bytes and ring wire bytes per collective kind of an
    :class:`OpTrace` (or its records); a record without a group size takes
    ``n_devices``, as an HLO collective without replica groups does."""
    counts = {k: 0 for k in _COLLECTIVES}
    rbytes = {k: 0 for k in _COLLECTIVES}
    wbytes = {k: 0.0 for k in _COLLECTIVES}
    for r in _records(trace):
        if r.collective is None:
            continue
        g = n_devices if r.group_size is None else r.group_size
        counts[r.collective] += 1
        rbytes[r.collective] += r.bytes
        wbytes[r.collective] += r.bytes * _wire_factor(r.collective, g)
    return CollectiveStats(counts, rbytes, wbytes)


# the reference's histogram keys -> the aten ops each counts
_HIST_OPS = {
    "fusion": (),
    "dot": ("mm", "bmm", "addmm", "baddbmm"),
    "convolution": ("convolution", "_convolution", "convolution_backward"),
    "scatter": ("scatter*", "index_put*"),
    "gather": ("gather", "index", "embedding"),
    "transpose": ("transpose", "permute"),
    "reshape": ("view", "reshape", "_unsafe_view"),
    "copy": ("copy_", "clone", "_to_copy"),
}


def _matches(op: str, pats: tuple[str, ...]) -> bool:
    return any(op.startswith(p[:-1]) if p.endswith("*") else op == p for p in pats)


def dot_flops(trace) -> int:
    """The FLOPs of a trace's matmuls (the histogram's ``dot`` ops)."""
    return sum(r.flops for r in _records(trace) if _matches(r.op, _HIST_OPS["dot"]))


def op_histogram(trace, ops: tuple[str, ...] = tuple(_HIST_OPS)) -> dict:
    """Counts of the reference's op classes in a trace.  ``fusion`` is
    always 0: eager PyTorch fuses nothing, every op is its own launch."""
    recs = _records(trace)
    return {o: sum(_matches(r.op, _HIST_OPS[o]) for r in recs) for o in ops}
