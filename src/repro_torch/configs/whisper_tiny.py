"""whisper-tiny [audio] — enc-dec, 4L d_model=384 6H (MHA) d_ff=1536
vocab=51865, conv frontend stubbed (precomputed mel-frame embeddings).
[arXiv:2212.04356; unverified]"""
from repro_torch.models.lm import LMConfig

ARCH_ID = "whisper-tiny"


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID,
        family="encdec",
        n_layers=4,
        n_enc_layers=4,
        d_model=384,
        n_heads=6,
        n_kv=6,
        d_ff=1536,
        vocab=51865,
        norm="ln",
        gated_ffn=False,
        act="gelu",
        enc_len=1500,
        tie_embeddings=True,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke",
        family="encdec",
        n_layers=2,
        n_enc_layers=2,
        d_model=64,
        n_heads=4,
        n_kv=4,
        d_ff=128,
        vocab=512,
        norm="ln",
        gated_ffn=False,
        act="gelu",
        enc_len=48,
        tie_embeddings=True,
        remat=False,
    )
