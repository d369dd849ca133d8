"""Fault models for the 2-D computing array (paper Section III / V-A2).

Host numpy, as in the JAX package: every sampler makes the reference's numpy
calls in the reference's order (``binomial``, ``uniform``, ``geometric``,
``normal``, ``integers``), so the same generator state gives the same maps
bit for bit.

Two permanent-fault distribution models:
  * random   — i.i.d. Bernoulli(PER) per PE (paper's "random distribution model")
  * clustered — Meyer–Pradhan centre-satellite model [42]: defects cluster
    spatially, characteristic of manufacturing defects.

PER/BER conversion (paper Eq. 1): a PE holds ``bits_per_pe`` registers
(8b input + 8b weight + 16b intermediate + 32b accumulator = 64) and is faulty
iff any bit register is faulty::

    PER = 1 - (1 - BER) ** bits_per_pe
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np

BITS_PER_PE = 64  # 8 + 8 + 16 + 32 (paper Section III-B)


def per_from_ber(ber: float | np.ndarray, bits_per_pe: int = BITS_PER_PE) -> np.ndarray:
    """Paper Eq. (1)."""
    return 1.0 - (1.0 - np.asarray(ber, dtype=np.float64)) ** bits_per_pe


def ber_from_per(per: float | np.ndarray, bits_per_pe: int = BITS_PER_PE) -> np.ndarray:
    """Inverse of Eq. (1)."""
    return 1.0 - (1.0 - np.asarray(per, dtype=np.float64)) ** (1.0 / bits_per_pe)


def random_fault_maps(
    rng: np.random.Generator, n: int, rows: int, cols: int, per: float
) -> np.ndarray:
    """(n, rows, cols) bool fault maps, i.i.d. Bernoulli(per)."""
    return rng.random((n, rows, cols)) < per


def clustered_fault_maps(
    rng: np.random.Generator,
    n: int,
    rows: int,
    cols: int,
    per: float,
    cluster_size_mean: float = 4.0,
    cluster_sigma: float = 1.5,
) -> np.ndarray:
    """Meyer–Pradhan style centre-satellite clustered fault maps.

    Clustering is *spatial*: the per-map fault COUNT is drawn from the same
    Binomial(R·C, per) as the random model (so count-only metrics like HyCA's
    FFP see the identical load — exactly the insensitivity the paper reports
    in Figs. 10/14), but the faults are *placed* cluster-wise: centres uniform
    over the array, geometric(1/cluster_size_mean) satellites at discretised
    Gaussian offsets (sigma = ``cluster_sigma`` PEs).  Spatial concentration
    is what breaks the region-locked RR/CR/DR schemes.

    Guarantees (property-tested in the tests): every fault
    lands in-bounds for ANY ``cluster_sigma`` (satellite offsets are clipped
    to the array, so extreme sigmas degrade gracefully toward the random
    model rather than erroring), and each map carries exactly its sampled
    Binomial count.
    """
    if cluster_size_mean < 1.0:
        raise ValueError(f"cluster_size_mean must be >= 1, got {cluster_size_mean}")
    if cluster_sigma < 0.0:
        raise ValueError(f"cluster_sigma must be >= 0, got {cluster_sigma}")
    maps = np.zeros((n, rows, cols), dtype=bool)
    counts = rng.binomial(rows * cols, per, size=n)
    for i in range(n):
        target = int(counts[i])
        placed = 0
        guard = 0
        while placed < target and guard < 64:
            cr = rng.uniform(0, rows)
            cc = rng.uniform(0, cols)
            size = min(int(rng.geometric(1.0 / cluster_size_mean)), target - placed)
            rr = np.clip(np.round(cr + rng.normal(0, cluster_sigma, size)), 0, rows - 1).astype(int)
            cc2 = np.clip(np.round(cc + rng.normal(0, cluster_sigma, size)), 0, cols - 1).astype(int)
            lin = np.unique(rr * cols + cc2)  # dedupe intra-cluster collisions
            rr, cc2 = lin // cols, lin % cols
            fresh = ~maps[i, rr, cc2]
            maps[i, rr[fresh], cc2[fresh]] = True
            placed += int(fresh.sum())
            guard += 1
        # collisions can leave a small remainder; finish with uniform fills
        while placed < target:
            r_, c_ = rng.integers(rows), rng.integers(cols)
            if not maps[i, r_, c_]:
                maps[i, r_, c_] = True
                placed += 1
    return maps


def sample_fault_maps(
    rng: np.random.Generator,
    n: int,
    rows: int,
    cols: int,
    per: float,
    model: Literal["random", "clustered"] = "random",
) -> np.ndarray:
    if model == "random":
        return random_fault_maps(rng, n, rows, cols, per)
    if model == "clustered":
        return clustered_fault_maps(rng, n, rows, cols, per)
    raise ValueError(f"unknown fault model {model!r}")


@dataclasses.dataclass(frozen=True)
class StuckAtFault:
    """A persistent stuck-at fault on one PE's accumulator register.

    ``bit`` is the stuck bit position in the PE's int32 accumulator,
    ``value`` the stuck value (0 or 1).  Applying the fault forces that bit
    on every accumulation step — we model the *final* accumulator corruption,
    which is what the output buffer observes.
    """

    row: int
    col: int
    bit: int
    value: int

    def apply(self, acc: np.ndarray) -> np.ndarray:
        # Mask in the accumulator's own 32-bit width: the engine's stuck-at
        # mux (engine._stuck_at_i32 and the kernel family's drain) operates on
        # the int32 bit pattern, where forcing bit 31 on is the SIGN bit —
        # widening to int64 first turned that into +2**31 instead of the
        # wraparound to -2**31 the hardware observes.  The uint32 view keeps
        # the shift well-defined at bit 31; the int32 array shares its memory.
        a = acc.astype(np.int32)
        u = a.view(np.uint32)
        mask = np.uint32(1) << np.uint32(self.bit)
        if self.value:
            u |= mask
        else:
            u &= ~mask
        return a


def sample_stuck_at(
    rng: np.random.Generator, fault_map: np.ndarray, acc_bits: int = 32
) -> list[StuckAtFault]:
    """One random stuck-at accumulator fault per faulty PE in ``fault_map``."""
    rows, cols = np.nonzero(fault_map)
    bits = rng.integers(0, acc_bits, size=rows.size)
    vals = rng.integers(0, 2, size=rows.size)
    return [
        StuckAtFault(int(r), int(c), int(b), int(v))
        for r, c, b, v in zip(rows, cols, bits, vals)
    ]
