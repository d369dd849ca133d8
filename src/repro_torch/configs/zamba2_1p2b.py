"""zamba2-1.2b [hybrid] — 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64 — a Mamba2 backbone and one shared attention
block, applied after every 6 Mamba layers. [arXiv:2411.15242; hf]"""
from repro_torch.models.lm import LMConfig
from repro_torch.models.mamba2 import Mamba2Config

ARCH_ID = "zamba2-1.2b"


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID,
        family="hybrid",
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv=32,
        d_ff=8192,
        vocab=32000,
        ssm=Mamba2Config(d_model=2048, d_state=64, head_dim=64, expand=2, chunk=128),
        attn_every=6,
        subquadratic=True,
        tie_embeddings=True,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke",
        family="hybrid",
        n_layers=5,
        d_model=64,
        n_heads=4,
        n_kv=4,
        d_ff=128,
        vocab=512,
        ssm=Mamba2Config(d_model=64, d_state=16, head_dim=32, expand=2, chunk=32),
        attn_every=2,
        subquadratic=True,
        tie_embeddings=True,
        remat=False,
    )
