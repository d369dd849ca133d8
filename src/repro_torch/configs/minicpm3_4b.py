"""minicpm3-4b [dense] — 62L d_model=2560 40H d_ff=6400 vocab=73448 — MLA
(multi-head latent attention, q_lora=768 kv_lora=256).
[hf:openbmb/MiniCPM3-4B; hf]"""
from repro_torch.models.attention import MLAConfig
from repro_torch.models.lm import LMConfig

ARCH_ID = "minicpm3-4b"


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=62,
        d_model=2560,
        n_heads=40,
        n_kv=40,
        d_ff=6400,
        vocab=73448,
        attn_kind="mla",
        mla=MLAConfig(
            d_model=2560, n_heads=40, q_lora=768, kv_lora=256,
            d_nope=64, d_rope=32, d_v=64,
        ),
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
        attn_kind="mla",
        mla=MLAConfig(
            d_model=64, n_heads=4, q_lora=32, kv_lora=32,
            d_nope=16, d_rope=8, d_v=16,
        ),
        tie_embeddings=True,
        remat=False,
    )
