"""Everything a run makes from ``--seed``: the weights, the fault map and
the traffic.  The same seed gives the same inputs; each part draws from a
sub-seed of its own, so one part can be drawn again alone (the reference
draws each layer's weights again after the program is gone)."""
from __future__ import annotations

import hashlib
import math
import statistics

import numpy as np
import torch


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for the part named by ``tags`` of run ``seed``."""
    key = "/".join(str(t) for t in (seed, *tags)).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1


# --------------------------------------------------------------------------- #
# weights
# --------------------------------------------------------------------------- #
ALIGN = 64  # elements: every leaf starts 128-byte aligned in its part's buffer


def draw_part(leaves: list, seed: int, part: str, device, dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """The leaves of ``part`` [(name, shape, std)], the family's layout
    (``bridges/<family>.py::part_leaves``), in ``dtype`` on ``device``: one
    normal draw of the whole part from a generator on the device, each
    leaf's slice scaled by its std (None: a norm's scale, all ones), then
    cast; each leaf a view of one buffer.  Drawing the same part again
    gives the same values."""
    offsets, n = [], 0
    for _, shape, _ in leaves:
        offsets.append(n)
        n += -(-math.prod(shape) // ALIGN) * ALIGN
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights", part))
    flat = torch.randn(n, generator=gen, dtype=torch.float32, device=device)
    for (_, shape, std), off in zip(leaves, offsets):
        seg = flat[off:off + math.prod(shape)]
        if std is None:
            seg.fill_(1.0)
        else:
            seg.mul_(std)
    flat = flat.to(dtype)
    return {name: flat[off:off + math.prod(shape)].view(shape)
            for (name, shape, _), off in zip(leaves, offsets)}


def draw_all(bridge, m: dict, seed: int, device, dtype=torch.bfloat16) -> dict[str, dict[str, torch.Tensor]]:
    """Every part of the family's model ``m`` (``bridge``: its module of
    ``bridges/``)."""
    return {p: draw_part(bridge.part_leaves(m, p), seed, p, device, dtype) for p in bridge.parts(m)}


def float_weights(bridge, m: dict, seed: int, device):
    """``weights(part)``: a part's leaves drawn again, in float32, as the
    references take them."""
    return lambda part: {k: v.float() for k, v in draw_part(bridge.part_leaves(m, part), seed, part, device).items()}


# --------------------------------------------------------------------------- #
# the fault map
# --------------------------------------------------------------------------- #
def fault_map(seed: int, rows: int, cols: int, n: int) -> list[tuple[int, int, int, int]]:
    """``n`` distinct faulty PEs of a ``rows`` x ``cols`` array, each with
    its stuck bit (0-31) and stuck value (0/1): (row, col, bit, val)."""
    rng = np.random.default_rng(sub_seed(seed, "faults"))
    pes = rng.choice(rows * cols, size=n, replace=False)
    bits = rng.integers(0, 32, size=n)
    vals = rng.integers(0, 2, size=n)
    return [(int(p) // cols, int(p) % cols, int(b), int(v)) for p, b, v in zip(pes, bits, vals)]


# --------------------------------------------------------------------------- #
# traffic
# --------------------------------------------------------------------------- #
def length_levels(dist: dict, levels: int) -> list[int]:
    """``levels`` lengths at the mid-quantiles (i + 0.5) / levels of a
    lognormal of ``median`` and ``sigma``, clipped to [min, max]: the same
    set of sizes for every seed."""
    z = statistics.NormalDist()
    return [int(min(dist["max"], max(dist["min"], round(dist["median"] * math.exp(dist["sigma"] * z.inv_cdf(
        (i + 0.5) / levels)))))) for i in range(levels)]


class ChatTraffic:
    """The requests of a chat mix, in the order they are sent: every block
    of ``levels`` requests holds the same (prompt, output) sizes in the same
    order, so every seed sends the same work (prompt level i is paired with
    output level i * pair_stride mod levels, and request k of a block takes
    pair k * order_stride mod levels).  The seed draws the prompts' token
    ids, uniform over the vocabulary."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix, self.seed, self.vocab = mix, seed, vocab
        n = mix["levels"]
        p, o = length_levels(mix["prompt"], n), length_levels(mix["output"], n)
        pairs = [(p[i], o[(i * mix["pair_stride"]) % n]) for i in range(n)]
        self.sizes = [pairs[(k * mix["order_stride"]) % n] for k in range(n)]
        if max(a + b for a, b in self.sizes) > mix["smax"]:
            raise ValueError("a request of the mix does not fit the KV capacity smax")

    def request(self, k: int) -> tuple[np.ndarray, int]:
        """(prompt token ids, output tokens) of the k-th request."""
        p, o = self.sizes[k % self.mix["levels"]]
        rng = np.random.default_rng(sub_seed(self.seed, "prompt", k))
        return rng.integers(0, self.vocab, size=p, dtype=np.int64).astype(np.int32), o


class PrefillTraffic:
    """Batches of ``tokens_per_batch`` prompt tokens: batch j's sequence
    length is the (j mod L)-th of block j // L, every block holding each of
    the L ``seq_lens`` once in an order drawn from the seed; B = tokens / S;
    uniform token ids drawn from the seed."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix, self.seed, self.vocab = mix, seed, vocab
        for s in mix["seq_lens"]:
            if mix["tokens_per_batch"] % s:
                raise ValueError(f"seq_len {s} does not divide tokens_per_batch")

    def shape(self, j: int) -> tuple[int, int]:
        lens = self.mix["seq_lens"]
        block, i = divmod(j, len(lens))
        s = lens[np.random.default_rng(sub_seed(self.seed, "order", block)).permutation(len(lens))[i]]
        return self.mix["tokens_per_batch"] // s, s

    def batch(self, j: int) -> np.ndarray:
        b, s = self.shape(j)
        rng = np.random.default_rng(sub_seed(self.seed, "batch", j))
        return rng.integers(0, self.vocab, size=(b, s), dtype=np.int64)
