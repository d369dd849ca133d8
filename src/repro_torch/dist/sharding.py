"""Logical-axis sharding: rules, divisibility fallback, structural specs.

Model code names *logical* axes (``shard(x, "batch", "seq", "embed")``) and
the resolver maps them onto the current mesh, dropping mesh axes that do not
divide the dimension, so small smoke shapes and odd vocab sizes never fail.

Three rule profiles select the parallelism style:

  * ``DEFAULT_RULES`` (tp) — Megatron tensor parallel: batch over the data
    axes, vocab/mlp/head axes over ``model``;
  * ``DP_RULES``      (dp) — pure data parallel: batch over every mesh axis,
    params replicated;
  * ``EP_RULES``      (ep) — expert parallel: experts over ``model``, batch
    over the data axes.

A spec is a tuple in the layout of JAX's ``PartitionSpec``: one entry per
leading tensor dim, each ``None``, a mesh-axis name, or a tuple of axis
names (a one-name tuple is written as the name); missing trailing entries
replicate.  :func:`resolve_spec` drops trailing ``None`` entries, the
structural specs keep one entry a dim, as the reference's do.
The functions read only a mesh's axis names and sizes, so they take the
port's abstract :class:`~repro_torch.launch.mesh.MeshSpec` (``axis_names``,
``shape``), a ``torch.distributed.DeviceMesh`` (``mesh_dim_names``,
``shape``) or a :class:`~repro_torch.launch.mesh.BoundMesh` (a spec bound to
the device mesh its DTensors live on).  :func:`named` turns a spec into
DTensor placements, :func:`distribute` lays a tree out as DTensors and
:func:`redistribute` moves one to other specs.  Inside the models,
:func:`shard` constrains an activation, :func:`einsum` contracts shards
and :func:`copy_into` writes a state in place; on plain tensors each does
exactly what the served step always did.

Param specs (:func:`param_specs`) follow the Megatron layout from leaf
names: col-parallel by default (output dim over ``model``), row-parallel for
the contraction-side projections (``wo``/``down``), vocab-dim for embedding
tables, expert-dim for MoE expert stacks; a non-divisible preferred dim
falls back to the other matmul dim, then to replication.
:func:`zero1_specs` also spreads the largest still-replicated dim over the
data axes (ZeRO-1 optimizer-state sharding).  Cache specs
(:func:`cache_specs`) shard KV heads over ``model`` when they divide it,
else the KV length (flash-decoding layout).

Layer stacks.  The port keeps a layer stack as a list of per-layer dicts
(:mod:`repro_torch.tree`) and a cache as per-layer lists, where the
reference stacks each leaf on a leading layer axis and its rules index that
stacked leaf (the expert axis is ``nd - 3`` of ``(L, E, d, f)``, a KV cache
is ``(L, B, S, H, D)``).  So every list in a param or cache tree is read as
a layer stack: each leaf's spec is computed on the stacked shape
``(n_layers, *leaf.shape)``, and every layer's tensor carries that same
spec, whose first entry is the layer axis.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Callable, Iterable

import torch

Spec = tuple

# --------------------------------------------------------------------------- #
# rule profiles + contexts
# --------------------------------------------------------------------------- #
# logical axis -> ordered mesh-axis candidates (combined; trailing axes are
# dropped until the dimension is divisible)
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),
    "embed": (),
    "vocab": ("model",),
    "mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "expert": ("model",),
}

DP_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data", "model"),
    "seq": (),
    "embed": (),
    "vocab": (),
    "mlp": (),
    "heads": (),
    "kv_heads": (),
    "expert": (),
}

EP_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),
    "embed": (),
    "vocab": (),
    "mlp": (),
    "heads": (),
    "kv_heads": (),
    "expert": ("model",),
}

PROFILE_RULES = {"tp": DEFAULT_RULES, "dp": DP_RULES, "ep": EP_RULES}

_RULES: contextvars.ContextVar[dict] = contextvars.ContextVar("rules", default=DEFAULT_RULES)
_MESH: contextvars.ContextVar[Any] = contextvars.ContextVar("mesh", default=None)


def current_rules() -> dict[str, tuple[str, ...]]:
    return _RULES.get()


@contextlib.contextmanager
def use_rules(rules: dict[str, tuple[str, ...]]):
    tok = _RULES.set(rules)
    try:
        yield rules
    finally:
        _RULES.reset(tok)


def current_mesh():
    return _MESH.get()


@contextlib.contextmanager
def use_mesh(mesh):
    """``mesh`` is the current mesh inside.  On a ``DeviceMesh`` (or a
    :class:`~repro_torch.launch.mesh.BoundMesh`) the models
    run on DTensors, and every plain tensor they make (positions, masks,
    RoPE tables, ``-1e30`` fills) is read as replicated over it
    (``implicit_replication``)."""
    tok = _MESH.set(mesh)
    try:
        if _is_device_mesh(mesh):
            from torch.distributed.tensor.experimental import implicit_replication

            with implicit_replication():
                yield mesh
        else:
            yield mesh
    finally:
        _MESH.reset(tok)


def _is_device_mesh(mesh) -> bool:
    if mesh is None or not torch.distributed.is_available():
        return False
    from torch.distributed.device_mesh import DeviceMesh

    return isinstance(device_mesh(mesh), DeviceMesh)


# --------------------------------------------------------------------------- #
# resolver
# --------------------------------------------------------------------------- #
def axis_names(mesh) -> tuple[str, ...]:
    """The mesh's axis names: a ``MeshSpec``'s ``axis_names`` or a
    ``DeviceMesh``'s ``mesh_dim_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(mesh.axis_names if names is None else names)


def axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(axis_names(mesh), (int(s) for s in mesh.shape)))


def _prod(sizes: dict[str, int], axes: Iterable[str]) -> int:
    return int(math.prod(sizes[a] for a in axes))


def _spec(entries: list) -> Spec:
    """PartitionSpec layout: a one-axis tuple is written as the axis name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)


def resolve_spec(logical: list[str | None], dims: tuple[int, ...], mesh,
                 rules: dict[str, tuple[str, ...]] | None = None) -> Spec:
    """Map logical axis names onto mesh axes with divisibility fallback.

    Trailing candidate axes are dropped until the combined size divides the
    dimension; a fully dropped entry replicates."""
    rules = current_rules() if rules is None else rules
    sizes = axis_sizes(mesh)
    entries: list[Any] = []
    for name, d in zip(logical, dims):
        if name is None:
            entries.append(None)
            continue
        cand = tuple(a for a in rules.get(name, ()) if a in sizes)
        while cand and d % _prod(sizes, cand) != 0:
            cand = cand[:-1]
        entries.append(cand if cand else None)
    while entries and entries[-1] is None:
        entries.pop()
    return _spec(entries)


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, major to minor."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(mesh, spec: Spec) -> tuple:
    """DTensor placements of one spec, one per dim of the device mesh:
    ``Shard(d)`` where the spec puts that mesh axis on tensor dim ``d``, else
    ``Replicate()``.  A tensor dim over several mesh axes is sharded over
    them in mesh-dim order, major to minor, which must be the order the spec
    names them in.  On a :class:`~repro_torch.launch.mesh.BoundMesh` a
    device dim stands for its ``dims`` group of axes, which a spec must name
    together."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    groups = getattr(mesh, "dims", None) or tuple((a,) for a in names)
    on = {}
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        if any(a not in names for a in axes):
            raise ValueError(f"spec {spec} names the axes {axes}; the mesh has {names}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: the axes of dim {d} are not in the mesh's order {names}")
        i = 0
        while i < len(axes):
            j = next(j for j, g in enumerate(groups) if axes[i] in g)
            if tuple(axes[i:i + len(groups[j])]) != groups[j]:
                raise ValueError(f"spec {spec}: the axes {axes} of dim {d} split the device mesh's dim {groups[j]}")
            on[j] = d
            i += len(groups[j])
    return tuple(Shard(on[j]) if j in on else Replicate() for j in range(len(groups)))


def device_mesh(mesh):
    """The ``DeviceMesh`` of a :class:`~repro_torch.launch.mesh.BoundMesh`,
    or ``mesh`` itself."""
    return getattr(mesh, "device_mesh", mesh)


def named(mesh, spec_tree: Any) -> Any:
    """Spec tree -> tree of DTensor placements (:func:`placements`), one
    tuple per leaf.  A layer stack's specs are the stacked leaf's, so their
    placements are those of the stacked tensor ``(n_layers, ...)``, dim 0
    the layer axis (ZeRO-1 puts the data axes there for some small leaves)."""
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [named(mesh, v) for v in spec_tree]
    return placements(mesh, spec_tree)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor.  A build without ``torch.distributed``
    makes none."""
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shard(x: torch.Tensor, *logical: str | None, dims: tuple[int, ...] | None = None) -> torch.Tensor:
    """Constrain ``x`` to the current mesh and rules; a no-op outside a mesh
    context and on a plain tensor, which has no placement to constrain (the
    served and captured steps run on plain tensors and launch nothing more).

    A DTensor is redistributed to the resolved placements over its own
    device mesh: the port's ``with_sharding_constraint``.  This is also what
    turns a ``Partial`` (a row-parallel product) into the collective that
    reduces it, so the points where the models call ``shard`` decide where
    the collectives fall, as the reference's constraints do for GSPMD.
    ``dims``: the sizes each logical axis is checked against, when they
    differ from ``x``'s (the heads of a flat ``(B, S, H * D)`` projection:
    ``dims=(B, S, H)`` keeps ``model`` on the last dim only if it divides
    ``H``, so the projection can be unflattened into heads)."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    if not hasattr(mesh, "device_mesh"):
        mesh = x.device_mesh
    spec = resolve_spec(list(logical), tuple(x.shape) if dims is None else tuple(dims), mesh, current_rules())
    return x.redistribute(x.device_mesh, placements(mesh, spec))


def distribute(tree: Any, spec_tree: Any, mesh, _stacked: bool = False) -> Any:
    """A tree of tensors as DTensors on ``mesh`` (a ``DeviceMesh`` or a
    :class:`~repro_torch.launch.mesh.BoundMesh`), each laid out by its spec
    (:func:`placements`).  A ``meta`` leaf becomes a DTensor
    of ``meta`` local shards, built without a collective (nothing is
    allocated, so the production meshes' full widths fit on any host); any
    other leaf is scattered by ``distribute_tensor``.

    A layer stack's leaf (a tensor of a list) takes its stacked spec without
    the first entry, the layer axis.  A spec that shards the layer axis
    (:func:`zero1_specs` on some small stacked leaves) cannot be held by a
    per-layer tensor and raises: distribute the stacked leaf instead
    (:func:`repro_torch.tree.stack_tree`)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    if isinstance(tree, dict):
        return {k: distribute(v, spec_tree[k], mesh, _stacked) for k, v in tree.items()}
    if isinstance(tree, list):
        return [distribute(v, sp, mesh, True) for v, sp in zip(tree, spec_tree)]
    spec = tuple(spec_tree)
    if _stacked:
        if spec and spec[0] is not None:
            raise ValueError(f"spec {spec} shards the layer axis of a stacked leaf; a per-layer tensor of "
                             f"{tuple(tree.shape)} cannot hold it")
        spec = spec[1:]
    pl = placements(mesh, spec)
    dm = device_mesh(mesh)
    if tree.device.type != "meta":
        return distribute_tensor(tree, dm, pl)
    local, _ = compute_local_shape_and_global_offset(tuple(tree.shape), dm, pl)
    return DTensor.from_local(torch.empty(local, dtype=tree.dtype, device="meta"), dm, pl, run_check=False,
                              shape=tree.shape, stride=tree.stride())


def redistribute(tree: Any, spec_tree: Any, mesh, _stacked: bool = False) -> Any:
    """Every DTensor of a tree redistributed to its spec's placements, a
    layer stack's leaf to its stacked spec without the layer axis (the rule
    of :func:`distribute`).  A ``Partial`` is reduced here: a reduce-scatter
    where the spec shards the dim, an all-reduce where it replicates."""
    if isinstance(tree, dict):
        return {k: redistribute(v, spec_tree[k], mesh, _stacked) for k, v in tree.items()}
    if isinstance(tree, list):
        return [redistribute(v, sp, mesh, True) for v, sp in zip(tree, spec_tree)]
    spec = tuple(spec_tree)[1:] if _stacked else tuple(spec_tree)
    return tree.redistribute(device_mesh(mesh), placements(mesh, spec))


def stacked_specs(spec_tree: Any) -> Any:
    """A spec tree in the reference's stacked layout
    (:func:`repro_torch.tree.stack_tree`): a layer stack's specs, the same
    for every layer, become one spec a stacked leaf."""
    if isinstance(spec_tree, dict):
        return {k: stacked_specs(v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return stacked_specs(spec_tree[0])
    return spec_tree


def einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum``; on DTensors, the einsum of each device's shards.

    DTensor's own einsum flattens the batch letters into one ``bmm`` dim and
    unflattens the result, which it cannot do where two sharded letters
    flatten into contiguous shards (one row a device on each, as at
    prefill_32k on the multi-pod mesh), and its rules differ between torch
    releases.  Here each mesh dim shards at most one letter: where the
    operands shard several, the one the largest operand shards is kept and
    the others are moved to it (an operand without it is read whole).  An
    operand holding a pending sum is multiplied as it is when the others are
    whole on that mesh dim, and reduced first otherwise.  A contracted
    sharded letter, or a pending operand, leaves a pending sum, which is
    reduced before the result is returned (an all-reduce).  Gradients flow
    back in the same placements, a read-whole operand's as a pending sum."""
    if not any(is_dtensor(o) for o in operands):
        return torch.einsum(eq, *operands)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    lhs, out_sub = eq.replace(" ", "").split("->")
    subs = lhs.split(",")
    mesh = next(o for o in operands if is_dtensor(o)).device_mesh
    if "." in eq or not all(is_dtensor(o) and o.device_mesh == mesh for o in operands):
        return torch.einsum(eq, *operands)

    def shardable(p) -> bool:
        return type(p) is Shard or p.is_replicate()

    def with_dim(o, m, p):
        return o.redistribute(mesh, [p if j == m else q for j, q in enumerate(o.placements)])

    ops = list(operands)
    for m in range(mesh.ndim):  # pending sums multiply only whole operands; odd placements are made whole
        pending = [i for i, o in enumerate(ops) if o.placements[m].is_partial()]
        sharded = [i for i, o in enumerate(ops) if not o.placements[m].is_replicate() and i not in pending]
        for i, o in enumerate(ops):
            p = o.placements[m]
            if (p.is_partial() and (len(pending) > 1 or sharded)) or not (shardable(p) or p.is_partial()):
                ops[i] = with_dim(o, m, Replicate())
    letters, pending = [], []
    for m in range(mesh.ndim):
        held = [(o.numel(), sub[o.placements[m].dim]) for o, sub in zip(ops, subs) if type(o.placements[m]) is Shard]
        letters.append(max(held)[1] if held else None)
        pending.append(any(o.placements[m].is_partial() for o in ops))
    locals_ = []
    for o, sub in zip(ops, subs):
        pl, grad = [], []
        for m, letter in enumerate(letters):
            if o.placements[m].is_partial():
                pl.append(Partial())
                grad.append(Replicate())
            elif letter is not None and letter in sub:
                pl.append(Shard(sub.index(letter)))
                grad.append(Shard(sub.index(letter)))
            else:
                pl.append(Replicate())
                grad.append(Partial() if letter is not None or pending[m] else Replicate())
        local = o.redistribute(mesh, pl).to_local(grad_placements=grad)
        locals_.append(_GradLayout.apply(local) if local.requires_grad else local)
    out = torch.einsum(eq, *locals_)
    out_pl = [Partial() if pending[m] or (letter is not None and letter not in out_sub) else
              Replicate() if letter is None else Shard(out_sub.index(letter)) for m, letter in enumerate(letters)]
    size = {c: n for o, sub in zip(operands, subs) for c, n in zip(sub, o.shape)}
    shape = torch.Size(size[c] for c in out_sub)
    res = DTensor.from_local(out, mesh, out_pl, run_check=False, shape=shape, stride=contiguous_strides(shape, out))
    if any(p.is_partial() for p in out_pl):
        res = res.redistribute(mesh, [Replicate() if p.is_partial() else p for p in out_pl])
    return res


class _GradLayout(torch.autograd.Function):
    """The identity, whose gradient is laid out as its input is.  A local
    shard's gradient is wrapped as a DTensor with the shard's own layout
    metadata (``to_local``'s backward), so one that came out of an einsum's
    backward in another layout is copied into the shard's."""

    @staticmethod
    def forward(ctx, x):
        ctx.layout = (x.shape, x.stride())
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        shape, stride = ctx.layout
        if g.stride() == stride:
            return g
        return torch.empty_strided(shape, stride, dtype=g.dtype, device=g.device).copy_(g)


class _GradPlacements(torch.autograd.Function):
    """The identity, whose gradient is redistributed to its input's
    placements before it flows on."""

    @staticmethod
    def forward(ctx, x):
        ctx.spec = (x.device_mesh, x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, pl = ctx.spec
        return g.redistribute(mesh, pl) if g.placements != pl else g


def grad_in_place(x: torch.Tensor) -> torch.Tensor:
    """``x``; on a DTensor that takes a gradient, the gradient that reaches
    the op which made ``x`` comes in ``x``'s own placements.  After a view
    that flattens dims (the heads into a row-parallel projection's input),
    the gradient otherwise arrives sharded on the flat dim, which the
    view's backward cannot split where the outer dim does not divide the
    mesh axis (24 heads on 16 devices)."""
    if is_dtensor(x) and x.requires_grad:
        return _GradPlacements.apply(x)
    return x


def contiguous_strides(shape, like: torch.Tensor | None = None) -> tuple[int, ...]:
    """The strides of a dense tensor of ``shape`` whose dims lie in memory in
    the order of ``like``'s (a local shard; row-major without it), computed
    without making a tensor: one made under a trace would count as work."""
    nd = len(shape)
    order = list(range(nd)) if like is None else sorted(range(nd), key=lambda d: (-like.stride(d), d))
    strides, n = [0] * nd, 1
    for d in reversed(order):
        strides[d] = n
        n *= max(int(shape[d]), 1)
    return tuple(strides)


def copy_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``, the in-place state update of a decode step; a
    DTensor ``src`` is first redistributed to ``dst``'s placements, since an
    in-place op cannot change its target's placements."""
    if is_dtensor(dst):
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.copy_(src)


# --------------------------------------------------------------------------- #
# walking a tree the reference's way: each list is a layer stack
# --------------------------------------------------------------------------- #
def map_leaf_specs(fn: Callable, tree, path: tuple = (), n_layers: int | None = None) -> Any:
    """``fn(path, shape) -> spec`` over a param or cache tree, read as the
    reference reads it: ``path`` is the key path (a layer stack's key kept,
    its index not) and ``shape`` a layer stack's leaf's stacked shape
    ``(n_layers, *leaf.shape)``.  Every layer of a stack gets that spec."""
    if isinstance(tree, dict):
        return {k: map_leaf_specs(fn, v, path + (str(k),), n_layers) for k, v in tree.items()}
    if isinstance(tree, list):
        if n_layers is not None:
            raise ValueError(f"{path}: a layer stack holds no nested list")
        return [map_leaf_specs(fn, lp, path, len(tree)) for lp in tree]
    shape = tuple(tree.shape)
    return fn(path, shape if n_layers is None else (n_layers, *shape))


# --------------------------------------------------------------------------- #
# structural param specs (Megatron layout from leaf names)
# --------------------------------------------------------------------------- #
_ROW_PARALLEL = {"wo", "down"}          # contraction dim over model
_EMBED_TABLES = {"embed", "lm_head"}    # vocab dim over model
_MOE_EXPERT = {"gate", "up", "down"}    # expert-stacked tensors under "moe"


def _full_rank(nd: int, dim: int, entry: Any) -> Spec:
    entries: list[Any] = [None] * nd
    entries[dim] = entry
    return _spec(entries)


def leaf_spec(path: tuple[str, ...], shape: tuple[int, ...], mesh) -> Spec:
    """Megatron TP spec for one param leaf (leading stacked axes unsharded).
    ``path``: the leaf's key names, as the reference's key path."""
    sizes = axis_sizes(mesh)
    nd = len(shape)
    if "model" not in sizes or nd < 2:
        return ()
    m = sizes["model"]
    names = list(path)
    name = names[-1]

    def first_divisible(dims: list[int]) -> Spec:
        for d in dims:
            if shape[d] % m == 0:
                return _full_rank(nd, d, "model")
        return ()

    if "moe" in names[:-1] and "shared" not in names and name in _MOE_EXPERT and nd >= 3:
        # expert-stacked (…, E, d, f): expert axis over model; shared-expert
        # FFNs fall through to the plain Megatron layout below
        expert = first_divisible([nd - 3])
        if expert != ():
            return expert
    if name in _EMBED_TABLES:
        return first_divisible([nd - 2, nd - 1])
    if name in _ROW_PARALLEL:
        return first_divisible([nd - 2, nd - 1])
    return first_divisible([nd - 1, nd - 2])  # col-parallel default


def _ep_leaf_spec(path: tuple[str, ...], shape: tuple[int, ...], mesh) -> Spec:
    sizes = axis_sizes(mesh)
    nd = len(shape)
    names = list(path)
    if "model" not in sizes or "moe" not in names[:-1] or names[-1] not in _MOE_EXPERT:
        return ()
    # expert-stacked tensors: shard the expert axis; shared-expert FFNs (and a
    # non-divisible expert count) fall back to the Megatron TP layout
    if "shared" not in names and nd >= 3 and shape[nd - 3] % sizes["model"] == 0:
        return _full_rank(nd, nd - 3, "model")
    return leaf_spec(path, shape, mesh)


def param_specs(params: Any, mesh, profile: str = "tp") -> Any:
    """Structural specs for a whole param tree (tensors, ``meta`` ones
    included) under a parallelism profile."""
    if profile == "dp":
        fn = lambda path, shape: ()  # noqa: E731
    elif profile == "ep":
        fn = lambda path, shape: _ep_leaf_spec(path, shape, mesh)  # noqa: E731
    elif profile == "tp":
        fn = lambda path, shape: leaf_spec(path, shape, mesh)  # noqa: E731
    else:
        raise ValueError(f"unknown profile {profile!r}; known: {tuple(PROFILE_RULES)}")
    return map_leaf_specs(fn, params)


def zero1_specs(params: Any, mesh, profile: str = "tp") -> Any:
    """Param layout + the largest replicated dim spread over the data axes
    (ZeRO-1: optimizer state sharded across data-parallel workers)."""
    sizes = axis_sizes(mesh)
    names = axis_names(mesh)
    data_axes = names if profile == "dp" else tuple(a for a in names if a != "model")
    dprod = _prod(sizes, data_axes)
    entry = tuple(data_axes) if len(data_axes) > 1 else (data_axes[0] if data_axes else None)

    def f(path, shape):
        nd = len(shape)
        base = () if profile == "dp" else leaf_spec(path, shape, mesh)
        entries = list(base) + [None] * (nd - len(base))
        if entry is None or dprod == 1:
            return _spec(entries)
        free = [i for i in range(nd) if entries[i] is None]
        for i in sorted(free, key=lambda i: -shape[i]):
            if shape[i] % dprod == 0:
                entries[i] = entry
                break
        return _spec(entries)

    return map_leaf_specs(f, params)


# --------------------------------------------------------------------------- #
# KV-cache specs
# --------------------------------------------------------------------------- #
def cache_leaf_spec(path: tuple[str, ...], shape: tuple[int, ...], mesh) -> Spec:
    """Spec for one cache leaf: batch over data axes; KV heads over ``model``
    when divisible, else KV length (flash-decoding layout).

    Stacked leaves are (n_layers, batch, ...); the encoder memory ("enc") is
    (batch, len, d)."""
    sizes = axis_sizes(mesh)
    nd = len(shape)
    names = list(path)
    entries: list[Any] = [None] * nd

    batch_dim = 0 if names[-1] == "enc" else (1 if nd >= 2 else 0)
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    cand = data_axes
    while cand and shape[batch_dim] % _prod(sizes, cand) != 0:
        cand = cand[:-1]
    if cand:
        entries[batch_dim] = tuple(cand) if len(data_axes) > 1 else cand[0]

    if "model" in sizes:
        m = sizes["model"]
        if nd >= 5:           # (L, B, S, H, D): heads then length
            dims = [3, 2]
        elif nd == 4:         # (L, B, S, C) latent / state: feature then length
            dims = [3, 2]
        elif names[-1] == "enc" and nd == 3:
            dims = [2]
        else:
            dims = []
        for d in dims:
            if d != batch_dim and shape[d] % m == 0:
                entries[d] = "model"
                break
    return _spec(entries)


def cache_specs(cache: Any, mesh) -> Any:
    return map_leaf_specs(lambda path, shape: cache_leaf_spec(path, shape, mesh), cache)


def local_bytes(tree: Any, spec_tree: Any, mesh) -> int:
    """Bytes one device holds of ``tree`` laid out by ``spec_tree``: each
    tensor's bytes over the product of the mesh axes its spec names (every
    spec divides its dims, so this is exact)."""
    sizes = axis_sizes(mesh)

    def walk(t, sp):
        if isinstance(t, dict):
            return sum(walk(t[k], sp[k]) for k in t)
        if isinstance(t, list):
            return sum(walk(a, b) for a, b in zip(t, sp))
        div = _prod(sizes, (a for e in sp for a in spec_axes(e)))
        return t.numel() * t.element_size() // div

    return walk(tree, spec_tree)
