"""Modality frontends, as the JAX package has them: the whisper conv stack
and the llava ViT are stubs, fed precomputed frame / patch embeddings.  What
lives here is the backbone's part:

  * audio: the sinusoidal positions added to the precomputed mel-frame
    embeddings;
  * vision: the multimodal projector (a 2-layer MLP, llava-style, on the
    array at site ``mm.proj``) and the splice of the projected patches over
    the token embeddings' prefix.
"""
from __future__ import annotations

import torch

from repro_torch.core.ftcontext import site_matmul
from repro_torch.models.layers import Params, dense_init, gelu, sinusoidal_positions


def audio_frontend(frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, T, d_model) precomputed conv-frontend output.  Adds the
    fixed sinusoidal positions whisper applies after the conv stack."""
    _, t, d = frames.shape
    return frames + sinusoidal_positions(t, d, device=frames.device)[None].to(frames.dtype)


def mm_projector_init(gen: torch.Generator, d_vision: int, d_model: int, *, device="cuda") -> Params:
    return {
        "fc1": dense_init(gen, d_vision, d_model, device=device),
        "b1": torch.zeros((d_model,), dtype=torch.float32, device=device),
        "fc2": dense_init(gen, d_model, d_model, device=device),
        "b2": torch.zeros((d_model,), dtype=torch.float32, device=device),
    }


def mm_project(patches: torch.Tensor, p: Params, ftc=None) -> torch.Tensor:
    """patches: (B, N_patch, d_vision) -> (B, N_patch, d_model); the biases
    are added in the patches' dtype, the GELU is the tanh form."""
    mm = site_matmul(ftc, "mm.proj")
    dt = patches.dtype
    h = gelu(mm(patches, p["fc1"].to(dt)) + p["b1"].to(dt))
    return mm(h, p["fc2"].to(dt)) + p["b2"].to(dt)


def splice_patches(tok_emb: torch.Tensor, patch_emb: torch.Tensor) -> torch.Tensor:
    """The first N_patch positions of the token embeddings replaced by the
    projected patch embeddings (llava-style prefix layout)."""
    n = patch_emb.shape[1]
    return torch.cat([patch_emb.to(tok_emb.dtype), tok_emb[:, n:]], dim=1)
