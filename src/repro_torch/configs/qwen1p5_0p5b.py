"""qwen1.5-0.5b [dense] — 24L d_model=1024 16H (MHA kv=16) d_ff=2816
vocab=151936 — QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.models.lm import LMConfig

ARCH_ID = "qwen1.5-0.5b"


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv=16,
        d_ff=2816,
        vocab=151936,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv=4,
        d_ff=128,
        vocab=512,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        remat=False,
    )
