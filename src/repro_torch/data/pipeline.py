"""Deterministic synthetic LM data pipeline: the reference's own, in numpy.

Batches are bitwise the reference's for the same (seed, step, host) and
are numpy arrays: the caller moves them to its device.

Production properties kept even though the tokens are synthetic:
  * deterministic per (seed, step, host_shard) — a restarted job resumes the
    exact stream from the checkpointed step, and each host loads only its
    shard (host-sharded loading, no duplicated IO);
  * learnable structure: a Zipf unigram mixed with an order-2 Markov chain so
    the e2e example's loss curve actually descends;
  * modality stubs for the [audio]/[vlm] archs (precomputed frame / patch
    embeddings, per the assignment spec).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models.lm import LMConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    batch: int = 8
    seq_len: int = 128
    n_hosts: int = 1
    host_id: int = 0
    zipf_a: float = 1.2


class SyntheticLM:
    """Stateless stream: batch(step) is pure in (cfg, model_cfg, step)."""

    def __init__(self, cfg: DataConfig, model: LMConfig):
        if cfg.batch % cfg.n_hosts:
            raise ValueError(f"global batch {cfg.batch} must split over {cfg.n_hosts} hosts")
        self.cfg = cfg
        self.model = model
        rng = np.random.default_rng(cfg.seed)
        v = model.vocab
        # fixed Zipf unigram + a sparse deterministic bigram successor table
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._unigram = (ranks ** -cfg.zipf_a) / np.sum(ranks ** -cfg.zipf_a)
        self._succ = rng.integers(0, v, size=v)  # preferred successor per token

    def batch(self, step: int) -> dict:
        c, m = self.cfg, self.model
        per_host = c.batch // c.n_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, step, c.host_id])
        )
        base = rng.choice(m.vocab, size=(per_host, c.seq_len + 1), p=self._unigram)
        # with prob .5 follow the Markov successor — learnable signal
        follow = rng.random((per_host, c.seq_len)) < 0.5
        for t in range(1, c.seq_len + 1):
            base[:, t] = np.where(follow[:, t - 1], self._succ[base[:, t - 1]], base[:, t])
        out = {
            "tokens": base[:, :-1].astype(np.int32),
            "labels": base[:, 1:].astype(np.int32),
        }
        if m.family == "encdec":
            out["frames"] = rng.standard_normal((per_host, m.enc_len, m.d_model)).astype(np.float32) * 0.02
        if m.family == "vlm":
            out["patches"] = rng.standard_normal((per_host, m.n_patches, m.d_vision)).astype(np.float32) * 0.02
        return out


def make_batch(model: LMConfig, batch: int, seq_len: int, seed: int = 0, step: int = 0) -> dict:
    return SyntheticLM(DataConfig(seed=seed, batch=batch, seq_len=seq_len), model).batch(step)
