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
``shape``) or a ``torch.distributed.DeviceMesh`` (``mesh_dim_names``,
``shape``).  :func:`named` turns a spec into DTensor placements.

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
    tok = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(tok)


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
    """DTensor placements of one spec, one per mesh dim: ``Shard(d)`` where
    the spec puts that mesh axis on tensor dim ``d``, else ``Replicate()``.
    A tensor dim over several mesh axes is sharded over them in mesh-dim
    order, major to minor, which must be the order the spec names them in."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    on = {}
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        if any(a not in names for a in axes):
            raise ValueError(f"spec {spec} names the axes {axes}; the mesh has {names}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: the axes of dim {d} are not in the mesh's order {names}")
        on.update((a, d) for a in axes)
    return tuple(Shard(on[a]) if a in on else Replicate() for a in names)


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


def shard(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """Constrain ``x`` to the current mesh and rules; a no-op outside a mesh
    context.  A DTensor is redistributed to the resolved placements over its
    own device mesh.  A plain tensor has no placement to constrain and is
    returned as it is: the models do not run on DTensors yet."""
    if current_mesh() is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    spec = resolve_spec(list(logical), tuple(x.shape), mesh, current_rules())
    return x.redistribute(mesh, placements(mesh, spec))


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
