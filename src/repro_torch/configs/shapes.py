"""The four input-shape cells and their ``meta``-tensor inputs.

Four LM shape cells (seq_len × global_batch):
  train_4k     — training step, seq 4 096, batch 256
  prefill_32k  — inference prefill (forward), seq 32 768, batch 32
  decode_32k   — one-token decode against a 32 768 KV cache, batch 128
  long_500k    — one-token decode against a 524 288 cache, batch 1
                 (sub-quadratic archs only — a mandated skip otherwise)

:func:`input_specs` returns ``meta`` tensors (shapes and dtypes, no
storage) for every model input of a (config × cell) pair;
:func:`input_shardings` the matching specs for a mesh.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist.sharding import cache_specs, resolve_spec
from repro_torch.models.lm import LMConfig, init_cache


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}


def applicable(cfg: LMConfig, cell: ShapeCell) -> bool:
    """long_500k needs sub-quadratic sequence mixing (mandated skip)."""
    if cell.name == "long_500k":
        return cfg.subquadratic
    return True


def applicable_cells(cfg: LMConfig) -> list[ShapeCell]:
    return [c for c in SHAPES.values() if applicable(cfg, c)]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _frontend_inputs(cfg: LMConfig, b: int) -> dict:
    if cfg.family == "encdec":
        return {"frames": _meta((b, cfg.enc_len, cfg.d_model), torch.bfloat16)}
    if cfg.family == "vlm":
        return {"patches": _meta((b, cfg.n_patches, cfg.d_vision), torch.bfloat16)}
    return {}


def input_specs(cfg: LMConfig, cell: ShapeCell) -> dict:
    """``meta`` stand-ins for every model input of this cell: int32 tokens
    and labels, bf16 frames and patches; a decode cell's cache is
    ``init_cache(cfg, b, s, device="meta")``."""
    b, s = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        return {"tokens": _meta((b, s), torch.int32), "labels": _meta((b, s), torch.int32),
                **_frontend_inputs(cfg, b)}
    if cell.kind == "prefill":
        return {"tokens": _meta((b, s), torch.int32), **_frontend_inputs(cfg, b)}
    if cell.kind == "decode":
        return {"token": _meta((b, 1), torch.int32), "cache": init_cache(cfg, b, s, device="meta")}
    raise ValueError(cell.kind)


def input_shardings(cfg: LMConfig, cell: ShapeCell, mesh) -> dict:
    """The spec tree matching :func:`input_specs`: batch over the data axes,
    the cache per :func:`~repro_torch.dist.sharding.cache_specs`."""
    out: dict = {}
    for k, v in input_specs(cfg, cell).items():
        if k == "cache":
            out[k] = cache_specs(v, mesh)
        else:
            out[k] = resolve_spec(["batch"] + [None] * (v.dim() - 1), tuple(v.shape), mesh)
    return out
