"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (MHA kv=16) d_ff=1408
vocab=102400 — fine-grained MoE: 2 shared + 64 routed top-6; first layer is a
dense FFN (d_ff 10944). [arXiv:2401.06066; hf]"""
from repro_torch.models.lm import LMConfig
from repro_torch.models.moe import MoEConfig

ARCH_ID = "deepseek-moe-16b"


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID,
        family="moe",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv=16,
        d_ff=1408,
        vocab=102400,
        first_k_dense=1,
        dense_d_ff=10944,
        moe=MoEConfig(
            d_model=2048, n_experts=64, top_k=6, d_expert=1408,
            n_shared=2, d_shared=2816,
        ),
        tie_embeddings=False,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv=4,
        d_ff=32,
        vocab=512,
        first_k_dense=1,
        dense_d_ff=128,
        moe=MoEConfig(d_model=64, n_experts=8, top_k=2, d_expert=32, n_shared=2, d_shared=64),
        tie_embeddings=False,
        remat=False,
    )
