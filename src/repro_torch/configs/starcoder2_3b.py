"""starcoder2-3b [dense] — 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152 — GQA, RoPE, LayerNorm + non-gated GELU MLP, bias terms.
[arXiv:2402.19173; hf]"""
from repro_torch.models.lm import LMConfig

ARCH_ID = "starcoder2-3b"


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=30,
        d_model=3072,
        n_heads=24,
        n_kv=2,
        d_ff=12288,
        vocab=49152,
        norm="ln",
        gated_ffn=False,
        act="gelu",
        qkv_bias=True,
        rope_theta=100_000.0,
        tie_embeddings=True,
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
        norm="ln",
        gated_ffn=False,
        act="gelu",
        qkv_bias=True,
        tie_embeddings=True,
        remat=False,
    )
