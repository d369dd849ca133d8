"""Checkpoint save and restore with atomic step directories, in the
reference's on-disk format.

  * a checkpoint is visible once its directory has been renamed from a
    ``.tmp-`` staging directory and its manifest hash verifies, so a killed
    writer never leaves a half checkpoint that restore would pick up;
  * one ``.npy`` file per leaf, named by the reference's key path joined by
    ``__``.  A layer stack (``blocks``, ``dense_blocks``, the encoder's
    ``layers``), a list of per-layer dicts here, is written as the
    reference's stacked leaves (one file per leaf, the layers on its
    leading axis) and split again on
    restore (:func:`repro_torch.tree.stacked_leaves`), so names, shapes,
    dtypes, digests and ``tree_hash`` are the reference's, and a checkpoint
    written by either package restores in the other;
  * the manifest records each leaf file's sha256 and ``restore`` verifies
    it before trusting the bytes: a tampered leaf is refused even when its
    shape still parses (manifests without digests get a structure check);
  * ``restore(..., device=)`` places the leaves on a device, where the
    reference takes shardings.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch.tree import map_with_path, stacked_leaves


def _leaf_name(path: tuple[str, ...]) -> str:
    return "__".join(path) or "leaf"


def _tree_hash(names_shapes: list[tuple[str, tuple, str]]) -> str:
    h = hashlib.sha256()
    for n, s, d in sorted(names_shapes):
        h.update(f"{n}:{s}:{d};".encode())
    return h.hexdigest()[:16]


def _host(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        raise TypeError("a bfloat16 leaf has no numpy dtype here; checkpoint the f32 masters")
    return t.detach().cpu().numpy()


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def save(ckpt_dir: str, step: int, tree: Any, extra: dict | None = None) -> str:
    """Atomically write ``tree`` under ``ckpt_dir/step_<step>``."""
    final = _step_dir(ckpt_dir, step)
    tmp = os.path.join(ckpt_dir, f".tmp-step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    names = []
    digests = {}
    for path, tensors, stacked in stacked_leaves(tree):
        arr = np.stack([_host(t) for t in tensors]) if stacked else _host(tensors[0])
        if not arr.flags.c_contiguous:  # a strided leaf: np.save would write it in Fortran order
            arr = arr.copy(order="C")
        name = _leaf_name(path)
        # serialise once in memory: the digest hashes the bytes that go to disk
        buf = io.BytesIO()
        np.save(buf, arr)
        data = buf.getvalue()
        digests[name] = hashlib.sha256(data).hexdigest()
        with open(os.path.join(tmp, name + ".npy"), "wb") as lf:
            lf.write(data)
        names.append((name, tuple(arr.shape), str(arr.dtype)))
    manifest = {
        "step": step,
        "leaves": [[n, list(s), d] for n, s, d in names],
        "tree_hash": _tree_hash(names),
        "leaf_sha256": digests,
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


def _verify(d: str) -> dict:
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    names = [(n, tuple(s), dt) for n, s, dt in manifest["leaves"]]
    if _tree_hash(names) != manifest["tree_hash"]:
        raise ValueError(f"manifest hash mismatch in {d}")
    return manifest


def _load_leaf(d: str, name: str, digests: dict) -> np.ndarray:
    # one read a leaf: the digest is checked on the buffer np.load parses
    with open(os.path.join(d, name + ".npy"), "rb") as lf:
        data = lf.read()
    expect = digests.get(name)
    if expect is not None and hashlib.sha256(data).hexdigest() != expect:
        raise ValueError(f"{name}: leaf content hash mismatch in {d} — the file "
                         "was modified after the checkpoint was published")
    return np.load(io.BytesIO(data))


def restore(ckpt_dir: str, step: int, like: Any, device=None) -> Any:
    """Load ``step`` into the structure of ``like`` (a tree of tensors).
    Each leaf goes to ``device``, or to the device of ``like``'s leaf."""
    d = _step_dir(ckpt_dir, step)
    manifest = _verify(d)
    digests = manifest.get("leaf_sha256", {})  # manifests without digests: {}
    loaded = {}
    for path, tensors, stacked in stacked_leaves(like):
        name = _leaf_name(path)
        arr = _load_leaf(d, name, digests)
        expect = ((len(tensors),) if stacked else ()) + tuple(tensors[0].shape)
        if tuple(arr.shape) != expect:
            raise ValueError(f"{name}: shape {arr.shape} != {expect}")
        loaded[path] = arr

    def place(path, layer, leaf):
        arr = loaded[path] if layer is None else loaded[path][layer]
        return torch.from_numpy(np.array(arr)).to(leaf.device if device is None else device)

    return map_with_path(place, like)


def corrupt_leaves(ckpt_dir: str, step: int) -> list[str]:
    """Digest-check every leaf of ``step`` without loading it: the names
    whose bytes no longer match the manifest's ``leaf_sha256`` (and any leaf
    file that is missing).  ``restore`` refuses at the first bad leaf; this
    scan names all of them, so a guarded restore can re-fetch exactly those.
    Manifests without digests return ``[]``."""
    d = _step_dir(ckpt_dir, step)
    manifest = _verify(d)
    bad = []
    for name, expect in sorted(manifest.get("leaf_sha256", {}).items()):
        fp = os.path.join(d, name + ".npy")
        if not os.path.exists(fp):
            bad.append(name)
            continue
        with open(fp, "rb") as lf:
            if hashlib.sha256(lf.read()).hexdigest() != expect:
                bad.append(name)
    return bad


def latest_step(ckpt_dir: str) -> int | None:
    """The newest step whose manifest verifies (partial or corrupt step
    directories are skipped)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for n in os.listdir(ckpt_dir):
        if n.startswith("step_"):
            try:
                _verify(os.path.join(ckpt_dir, n))
                steps.append(int(n[5:]))
            except (OSError, ValueError, KeyError):
                continue
    return max(steps) if steps else None


class CheckpointManager:
    """save-every-k + keep-last-n GC + resume helper."""

    def __init__(self, ckpt_dir: str, every: int = 100, keep: int = 3):
        self.dir = ckpt_dir
        self.every = every
        self.keep = keep
        os.makedirs(ckpt_dir, exist_ok=True)

    def maybe_save(self, step: int, tree: Any, extra: dict | None = None) -> str | None:
        if step % self.every:
            return None
        out = save(self.dir, step, tree, extra)
        self._gc()
        return out

    def _gc(self):
        steps = sorted(int(n[5:]) for n in os.listdir(self.dir) if n.startswith("step_"))
        for s in steps[: -self.keep]:
            shutil.rmtree(_step_dir(self.dir, s), ignore_errors=True)

    def resume(self, like: Any, device=None) -> tuple[int, Any] | None:
        s = latest_step(self.dir)
        if s is None:
            return None
        return s, restore(self.dir, s, like, device)
