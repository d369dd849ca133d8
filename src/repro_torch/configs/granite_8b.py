"""granite-8b [dense] — 36L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=49152 — llama-arch, code. [arXiv:2405.04324; hf]"""
from repro_torch.models.lm import LMConfig

ARCH_ID = "granite-8b"


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv=8,
        d_ff=14336,
        vocab=49152,
        rope_theta=10_000_000.0,
        tie_embeddings=False,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv=2,
        d_ff=128,
        vocab=512,
        tie_embeddings=False,
        remat=False,
    )
