"""llava-next-mistral-7b [vlm] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000 — mistral backbone; anyres-tiled ViT frontend is a stub
(input_specs supplies precomputed patch embeddings, 5 tiles × 576 patches).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.models.lm import LMConfig

ARCH_ID = "llava-next-mistral-7b"


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID,
        family="vlm",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv=8,
        d_ff=14336,
        vocab=32000,
        rope_theta=1_000_000.0,
        n_patches=2880,      # anyres: 5 tiles x 24x24 patches
        d_vision=1024,       # CLIP ViT-L/14 embedding width
        tie_embeddings=False,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv=2,
        d_ff=128,
        vocab=512,
        n_patches=16,
        d_vision=48,
        tie_embeddings=False,
        remat=False,
    )
