"""Memory-fault model for the checkpoint/cache path.

Transient flips in *compute* state (repro_torch.transient.seu) wash out or get
caught in-band; flips in *stored* checkpoint bytes are forever — every
restart replays them — unless the store's integrity layer catches them.
The store gives each leaf a sha256 content digest in the manifest; this
module exercises that end to end:

    tamper (flip a stored bit) → detect (digest scan) → re-fetch or refuse

``tamper_leaf`` is the injector (it edits the published ``.npy`` in place,
modelling bit-rot / a torn DMA after publish, NOT a torn write — the atomic
rename already excludes those).  ``guarded_restore`` is the consumer-side
policy: scan digests first (:func:`repro_torch.checkpoint.store.corrupt_leaves`
names every bad leaf, where plain ``restore`` refuses at the first), then
either re-fetch the named leaves from a pristine source and retry, or
refuse loudly.  Every stage surfaces as a ``memory.fault`` event
(action = detected / refetched / refused) so campaign summaries count
storage faults alongside PE and SEU faults.
"""
from __future__ import annotations

import os
import shutil

import numpy as np

from repro_torch.checkpoint import store


def _leaf_path(ckpt_dir: str, step: int, name: str) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}", name + ".npy")


def checkpoint_leaves(ckpt_dir: str, step: int) -> list[str]:
    """Leaf names recorded in the step's manifest (digest order)."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    manifest = store._verify(d)
    return sorted(manifest.get("leaf_sha256", {}))


def tamper_leaf(
    ckpt_dir: str, step: int, name: str, rng: np.random.Generator, *, n_bits: int = 1
) -> list[tuple[int, int]]:
    """Flip ``n_bits`` random bits in the published leaf file (in place,
    past the ``.npy`` header so the array still parses — corrupted *content*
    is exactly what shape/dtype checks cannot catch and digests must).
    Returns the flipped (byte_offset, bit) pairs."""
    fp = _leaf_path(ckpt_dir, step, name)
    with open(fp, "rb") as f:
        data = bytearray(f.read())
    # npy v1 header ends at the first newline; keep it intact
    header_end = data.index(b"\n") + 1
    if header_end >= len(data):
        raise ValueError(f"{name}: leaf has no payload bytes to tamper")
    flips = []
    for _ in range(n_bits):
        off = int(rng.integers(header_end, len(data)))
        bit = int(rng.integers(0, 8))
        data[off] ^= 1 << bit
        flips.append((off, bit))
    with open(fp, "wb") as f:
        f.write(data)
    return flips


def tamper_checkpoint(
    ckpt_dir: str, step: int, rng: np.random.Generator, *, n_leaves: int = 1, n_bits: int = 1
) -> list[str]:
    """Tamper ``n_leaves`` randomly chosen leaves of ``step``; returns their
    names (ground truth for asserting the digest scan finds exactly them)."""
    names = checkpoint_leaves(ckpt_dir, step)
    if not names:
        raise ValueError(f"step {step} has no digested leaves to tamper")
    chosen = [names[int(i)] for i in rng.choice(len(names), size=min(n_leaves, len(names)), replace=False)]
    for name in chosen:
        tamper_leaf(ckpt_dir, step, name, rng, n_bits=n_bits)
    return chosen


def pristine_fetcher(src_dir: str):
    """A ``fetch(ckpt_dir, step, name)`` callback that restores a leaf from a
    pristine mirror checkpoint tree (the "re-fetch from object store" leg —
    here the store is another directory, e.g. a copy made before tampering).
    """

    def fetch(ckpt_dir: str, step: int, name: str) -> None:
        shutil.copyfile(_leaf_path(src_dir, step, name), _leaf_path(ckpt_dir, step, name))

    return fetch


def guarded_restore(
    ckpt_dir: str,
    step: int,
    like,
    *,
    device=None,
    log=None,
    fetch=None,
    max_retries: int = 1,
):
    """Restore ``step`` with tamper → detect → re-fetch/refuse semantics.

    Each attempt first scans all leaf digests; every mismatch emits
    ``memory.fault`` (action="detected").  With a ``fetch`` callback and
    retries remaining, the named leaves are re-fetched (action="refetched")
    and the scan repeats; otherwise the restore is refused (action="refused"
    per bad leaf, then ValueError).  A clean scan falls through to
    :func:`repro_torch.checkpoint.store.restore`, whose own per-leaf digest check
    stays on as the last line of defence (TOCTOU between scan and load)."""
    for attempt in range(max_retries + 1):
        bad = store.corrupt_leaves(ckpt_dir, step)
        if not bad:
            return store.restore(ckpt_dir, step, like, device)
        if log is not None:
            for name in bad:
                log.emit("memory.fault", step=step, leaf=name, action="detected")
        if fetch is None or attempt == max_retries:
            if log is not None:
                for name in bad:
                    log.emit("memory.fault", step=step, leaf=name, action="refused")
            raise ValueError(
                f"checkpoint step {step} refused: corrupt leaves {bad} and no "
                "pristine source to re-fetch from"
            )
        for name in bad:
            fetch(ckpt_dir, step, name)
            if log is not None:
                log.emit("memory.fault", step=step, leaf=name, action="refetched")
    raise RuntimeError("unreachable")
