"""Campaign-sampled SEU bit-flip injection (the transient fault class).

Permanent PE faults persist until repaired; a single-event upset flips ONE
stored bit, and the corrupted value persists only until the word is next
overwritten.  Three storage classes matter for the serving stack:

  * **weight leaves** — flipped bits persist until the weights are reloaded;
    the scan probe never reads model weights, so only ABFT's encode-time
    checksum (:func:`repro_torch.core.engine.abft_encode`) can see them;
  * **activation panels** — corrupt one step's compute, then wash out;
  * **KV-cache pages** — persist in the cache and poison every later
    attention read of that slot; flips only ever land in *live* pages.

Plans are sampled on the host with a leading config axis, with the same
numpy calls as the reference package (the same seed gives the same plans),
and :func:`flip_bits` is a pure XOR on the stored bit pattern: applying the
same plan twice restores the leaf bit for bit.  Schedules are keyed (step,
site, index, bit) so the EventLog records exactly when and where each flip
landed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# word container per leaf width: flips address the stored bit pattern, so the
# word width is the dtype's itemsize, not always 32
_WORD_DTYPES = {1: torch.int8, 2: torch.int16, 4: torch.int32}


def word_bits(dtype) -> int:
    """Bits per stored word of ``dtype`` (a torch or numpy dtype): the valid
    flip-bit range."""
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize * 8
    return np.dtype(dtype).itemsize * 8


def flip_bits(x: torch.Tensor, idx, bit) -> torch.Tensor:
    """XOR the ``bit``-th bit of the flattened ``x`` at word positions
    ``idx``; entries outside ``[0, x.numel())`` are dropped (``-1`` is the
    padding of a :class:`FlipPlan`).  Pure: ``x`` is never written, and the
    result is a new tensor on ``x``'s device.  ``idx``/``bit`` are tensors
    or array-likes of one shape.

    An involution when the indices within one plan are unique (the samplers
    draw without replacement).  Works on any 8/16/32-bit leaf; float dtypes
    are flipped through their bit pattern.  Padding is routed to a discard
    slot past the leaf: a negative index would otherwise address the leaf's
    tail."""
    wdt = _WORD_DTYPES.get(x.element_size())
    if wdt is None:
        raise ValueError(f"flip_bits supports 8/16/32-bit leaves, got {x.dtype}")
    raw = x.contiguous().view(wdt).reshape(-1)
    size = raw.shape[0]
    idx = torch.as_tensor(idx, device=x.device).to(torch.long).reshape(-1)
    bit = torch.as_tensor(bit, device=x.device).to(wdt).reshape(-1)
    slot = torch.where((idx >= 0) & (idx < size), idx, torch.full_like(idx, size))
    padded = torch.cat([raw, raw.new_zeros(1)])
    padded[slot] = padded[slot] ^ (torch.ones_like(bit) << bit)
    return padded[:size].view(x.dtype).reshape(x.shape)


@dataclasses.dataclass(frozen=True)
class FlipPlan:
    """A batch of sampled SEU plans: ``idx``/``bit`` are (n_configs,
    max_flips) int32 numpy arrays, -1-padded like the engine's FPT.  Row i is
    config i's plan; feed rows to :func:`flip_bits`."""

    idx: np.ndarray
    bit: np.ndarray

    def __post_init__(self):
        if self.idx.shape != self.bit.shape or self.idx.ndim != 2:
            raise ValueError(
                f"FlipPlan idx/bit must share a (n_configs, max_flips) shape, "
                f"got {self.idx.shape} vs {self.bit.shape}"
            )

    @property
    def n_configs(self) -> int:
        return self.idx.shape[0]

    @property
    def max_flips(self) -> int:
        return self.idx.shape[1]

    def counts(self) -> np.ndarray:
        """(n_configs,) number of real (non-padding) flips per config."""
        return (self.idx >= 0).sum(axis=1)


def _pack_plans(picked: list[np.ndarray], bits: list[np.ndarray], max_flips: int) -> FlipPlan:
    n = len(picked)
    idx = np.full((n, max_flips), -1, np.int32)
    bit = np.zeros((n, max_flips), np.int32)
    for i, (p, b) in enumerate(zip(picked, bits)):
        k = min(p.size, max_flips)
        idx[i, :k] = p[:k]
        bit[i, :k] = b[:k]
    return FlipPlan(idx=idx, bit=bit)


def sample_flip_plans(
    rng: np.random.Generator,
    n_configs: int,
    size: int,
    *,
    rate: float | None = None,
    n_flips: int | None = None,
    max_flips: int | None = None,
    nbits: int = 32,
) -> FlipPlan:
    """Sample per-config SEU plans over a ``size``-word leaf.

    Exactly one of ``rate`` / ``n_flips``: ``rate`` draws each config's flip
    count from Binomial(size, rate), ``n_flips`` pins it.  Word indices are
    drawn without replacement (unique indices keep :func:`flip_bits` an
    involution); bit positions are uniform in [0, nbits).  Counts beyond
    ``max_flips`` (default: the largest sampled count) are truncated."""
    if (rate is None) == (n_flips is None):
        raise ValueError("pass exactly one of rate= / n_flips=")
    if rate is not None:
        counts = rng.binomial(size, rate, size=n_configs)
    else:
        counts = np.full(n_configs, min(n_flips, size), np.int64)
    cap = int(max_flips if max_flips is not None else max(int(counts.max()), 1))
    picked = [rng.choice(size, size=min(int(c), size), replace=False) for c in counts]
    bits = [rng.integers(0, nbits, size=p.size) for p in picked]
    return _pack_plans(picked, bits, cap)


def sample_kv_flips(
    rng: np.random.Generator,
    n_configs: int,
    shape: tuple[int, int, int],
    live: np.ndarray,
    *,
    rate: float | None = None,
    n_flips: int | None = None,
    max_flips: int | None = None,
    nbits: int = 16,
) -> FlipPlan:
    """SEU plans for a (slots, smax, d) KV-cache leaf, constrained to LIVE
    pages: slot ``b`` only holds decoded state in positions ``s < live[b]``;
    a flip in a dead page would be erased by the admission-time reset before
    anything reads it.  The rate applies to the live region.  ``nbits``
    defaults to 16 (the KV cache is bf16)."""
    b_, s_, d_ = shape
    live = np.asarray(live, np.int64)
    if live.shape != (b_,):
        raise ValueError(f"live must be ({b_},), got {live.shape}")
    if np.any((live < 0) | (live > s_)):
        raise ValueError(f"live lengths must be in [0, {s_}], got {live}")
    blocks = [b * s_ * d_ + np.arange(int(live[b]) * d_, dtype=np.int64) for b in range(b_)]
    candidates = np.concatenate(blocks) if blocks else np.zeros(0, np.int64)
    n_live = candidates.size
    if n_live == 0:
        cap = int(max_flips or 1)
        return FlipPlan(np.full((n_configs, cap), -1, np.int32),
                        np.zeros((n_configs, cap), np.int32))
    if (rate is None) == (n_flips is None):
        raise ValueError("pass exactly one of rate= / n_flips=")
    if rate is not None:
        counts = rng.binomial(n_live, rate, size=n_configs)
    else:
        counts = np.full(n_configs, min(n_flips, n_live), np.int64)
    cap = int(max_flips if max_flips is not None else max(int(counts.max()), 1))
    picked = [candidates[rng.choice(n_live, size=min(int(c), n_live), replace=False)] for c in counts]
    bits = [rng.integers(0, nbits, size=p.size) for p in picked]
    return _pack_plans(picked, bits, cap)


# --------------------------------------------------------------------------- #
# keyed schedules -> EventLog
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class FlipSchedule:
    """A keyed injection schedule: config ``i`` of ``plan`` fires at serving
    step ``steps[i]`` on storage site ``site`` (``"weights"``,
    ``"activations"``, ``"kv"``).  Emit with :func:`emit_flip_events` at
    injection time."""

    site: str
    steps: np.ndarray
    plan: FlipPlan

    def __post_init__(self):
        if np.asarray(self.steps).shape != (self.plan.n_configs,):
            raise ValueError(
                f"steps must be ({self.plan.n_configs},), got {np.asarray(self.steps).shape}"
            )


def emit_flip_events(log, site: str, step: int, plan: FlipPlan, config: int) -> int:
    """Emit one ``transient.flip`` event per real flip in ``plan`` row
    ``config``, backdated to ``step``: the ground-truth injection record that
    :func:`repro_torch.obs.events.transient_records` pairs with ``abft.alarm``
    detections.  Returns the number of events emitted."""
    n = 0
    for i, b in zip(plan.idx[config], plan.bit[config]):
        if i < 0:
            continue
        log.emit("transient.flip", step=step, site=site, index=int(i), bit=int(b))
        n += 1
    return n
