"""Trees of tensors: the params, optimizer and train states (nested dicts
and lists).

The port keeps a layer stack (``blocks``, ``dense_blocks``, and the
encoder's ``layers`` one level below the top) as a list of per-layer dicts,
where the reference stacks each leaf on a leading layer axis.
:func:`stacked_leaves` and :func:`map_with_path` read a tree the
reference's way: leaves in its flattening order (dict keys sorted), each
leaf of a layer stack one leaf over all its layers, named by the
reference's key path.  What acts on a whole reference leaf (a checkpoint's
files, a top-k threshold, a layer range of a gradient mask) goes through
them.
"""
from __future__ import annotations

from typing import Callable

import torch

# the keys whose value is a layer stack: a list of per-layer dicts here, one
# array a leaf in the reference
STACKED = ("blocks", "dense_blocks", "layers")


def tree_map(fn, tree):
    """``fn`` over every tensor of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_map2(fn, *trees):
    """``fn`` over the matching tensors of trees of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map2(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, list):
        return [tree_map2(fn, *(t[i] for t in trees)) for i in range(len(first))]
    return fn(*trees)


def tree_leaves(tree) -> list[torch.Tensor]:
    """Every tensor of a tree, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def pick(tree, i: int):
    """The ``i``-th member of every tuple at a leaf of a tree."""
    if isinstance(tree, dict):
        return {k: pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [pick(v, i) for v in tree]
    return tree[i]


def stacked_leaves(tree, path: tuple = ()) -> list[tuple[tuple[str, ...], list[torch.Tensor], bool]]:
    """``[(path, tensors, stacked)]`` in the reference's leaf order: a layer
    stack's leaf is one entry holding that leaf of every layer, in layer
    order (``stacked``); any other tensor is an entry of one."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            v = tree[k]
            if k in STACKED and isinstance(v, list):
                layers = [stacked_leaves(lp, path + (k,)) for lp in v]
                out += [(p, [lay[j][1][0] for lay in layers], True) for j, (p, _, _) in enumerate(layers[0])]
            else:
                out += stacked_leaves(v, path + (str(k),))
        return out
    if isinstance(tree, list):
        return [e for i, v in enumerate(tree) for e in stacked_leaves(v, path + (str(i),))]
    return [(path, [tree], False)]


def map_with_path(fn: Callable, tree, path: tuple = (), layer: int | None = None):
    """A tree of the same structure, each tensor replaced by ``fn(path,
    layer, tensor)``: ``path`` is the reference's key path of its leaf and
    ``layer`` its index in a layer stack (None outside one)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k in STACKED and isinstance(v, list):
                out[k] = [map_with_path(fn, lp, path + (k,), i) for i, lp in enumerate(v)]
            else:
                out[k] = map_with_path(fn, v, path + (str(k),), layer)
        return out
    if isinstance(tree, list):
        return [map_with_path(fn, v, path + (str(i),), layer) for i, v in enumerate(tree)]
    return fn(path, layer, tree)


def stack_tree(tree):
    """The reference's layout of a tree: every list (a layer stack of
    per-layer trees of one structure) becomes one tree whose leaves are the
    layers' leaves stacked on a new leading axis."""
    if isinstance(tree, dict):
        return {k: stack_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return tree_map2(lambda *layers: torch.stack(layers), *tree)
    return tree


def unstack_tree(stacked, like):
    """The inverse of :func:`stack_tree`: ``like`` (a tree in the port's
    layout) gives the layer stacks' lengths; each layer is a view of the
    stacked leaves."""
    if isinstance(like, dict):
        return {k: unstack_tree(stacked[k], v) for k, v in like.items()}
    if isinstance(like, list):
        return [tree_map(lambda a, i=i: a[i], stacked) for i in range(len(like))]
    return stacked
