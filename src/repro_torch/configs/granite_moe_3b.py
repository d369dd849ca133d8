"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_expert=512
vocab=49155 — MoE 40 routed experts top-8, no shared experts.
[hf:ibm-granite/granite-3.0-3b-a800m-base; hf]"""
from repro_torch.models.lm import LMConfig
from repro_torch.models.moe import MoEConfig

ARCH_ID = "granite-moe-3b-a800m"


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID,
        family="moe",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv=8,
        d_ff=512,
        vocab=49155,
        # 40 experts padded to 48 (the JAX package's 16-way expert sharding);
        # padded experts are router-masked and never routed to
        moe=MoEConfig(d_model=1536, n_experts=40, top_k=8, d_expert=512, pad_to=48),
        tie_embeddings=True,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv=2,
        d_ff=32,
        vocab=512,
        moe=MoEConfig(d_model=64, n_experts=8, top_k=2, d_expert=32),
        tie_embeddings=True,
        remat=False,
    )
