"""deepseek-v3 [moe] — 61L d_model=7168 128H MLA (q_lora 1536, kv_lora 512,
nope 128, rope 64, v 128; YaRN factor 40 over 4096 positions, interleaved
pairs) — 256 routed experts of 2048, top-8 from 4 of 8 groups by a sigmoid
gate with a score-correction bias, weights normalised and x2.5, 1 shared;
the first 3 layers dense (18432); vocab 129280, untied.  The
multi-token-prediction module is left out: it serves speculative decoding
and training only.  [hf:deepseek-ai/DeepSeek-V3 config.json;
arXiv:2412.19437]

A port-only id (the JAX registry has no such model).  :func:`ep32_config`
is one GPU's share of an EP32 expert layout: 8 of each layer's 256 experts
(``MoEConfig.experts_held``), at 23 of the 61 layers (the 3 dense and 20 of
the 58 MoE layers; the others lie on further pipeline stages)."""
import dataclasses

from repro_torch.models.attention import YarnMLAConfig
from repro_torch.models.layers import YarnScaling
from repro_torch.models.lm import LMConfig
from repro_torch.models.moe import MoEConfig

ARCH_ID = "deepseek-v3"
EP32_ID = "deepseek-v3-ep32"

YARN = YarnScaling(factor=40.0, beta_fast=32.0, beta_slow=1.0, mscale=1.0, mscale_all_dim=1.0,
                   original_max_position_embeddings=4096)


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID,
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv=128,
        d_ff=2048,
        vocab=129280,
        attn_kind="mla",
        mla=YarnMLAConfig(
            d_model=7168, n_heads=128, q_lora=1536, kv_lora=512, d_nope=128, d_rope=64, d_v=128,
            rope_scaling=YARN, rope_interleave=True,
        ),
        first_k_dense=3,
        dense_d_ff=18432,
        moe=MoEConfig(
            d_model=7168, n_experts=256, top_k=8, d_expert=2048, n_shared=1, d_shared=2048,
            scoring="sigmoid", n_group=8, topk_group=4, routed_scale=2.5, norm_topk=True,
        ),
        tie_embeddings=False,
    )


def ep32_config() -> LMConfig:
    full = config()
    return dataclasses.replace(full, name=EP32_ID, n_layers=23,
                               moe=dataclasses.replace(full.moe, experts_held=8, expert_offset=0))


def smoke_config() -> LMConfig:
    """Every mechanism at CPU size: 2 dense then 2 MoE layers, 8 heads of
    MLA with YaRN and interleaved pairs, 32 experts in 4 groups (2 kept),
    top-4, the layer holding 8 of them."""
    return LMConfig(
        name=ARCH_ID + "-smoke",
        family="moe",
        n_layers=4,
        d_model=64,
        n_heads=8,
        n_kv=8,
        d_ff=32,
        vocab=512,
        attn_kind="mla",
        mla=YarnMLAConfig(
            d_model=64, n_heads=8, q_lora=32, kv_lora=16, d_nope=16, d_rope=8, d_v=16,
            rope_scaling=dataclasses.replace(YARN, original_max_position_embeddings=16), rope_interleave=True,
            q_block=16,
        ),
        first_k_dense=2,
        dense_d_ff=128,
        moe=MoEConfig(
            d_model=64, n_experts=32, top_k=4, d_expert=32, n_shared=1, d_shared=32,
            scoring="sigmoid", n_group=4, topk_group=2, routed_scale=2.5, norm_topk=True,
            experts_held=8, expert_offset=8,
        ),
        tie_embeddings=False,
        remat=False,
    )
