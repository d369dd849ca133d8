"""rwkv6-7b [ssm] — Finch: 32L d_model=4096 (attention-free) d_ff=14336
vocab=65536 — linear attention with a data-dependent decay.  HyCA
applicability: the WKV recurrence is not array-mapped; the projections are
protected. [arXiv:2404.05892; hf]"""
from repro_torch.models.lm import LMConfig
from repro_torch.models.rwkv6 import RWKV6Config

ARCH_ID = "rwkv6-7b"


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID,
        family="ssm",
        n_layers=32,
        d_model=4096,
        n_heads=64,          # d_model / head_dim
        n_kv=64,
        d_ff=14336,
        vocab=65536,
        rwkv=RWKV6Config(d_model=4096, d_ff=14336, head_dim=64, decay_lora=64),
        subquadratic=True,
        tie_embeddings=False,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=2,
        n_kv=2,
        d_ff=128,
        vocab=512,
        rwkv=RWKV6Config(d_model=64, d_ff=128, head_dim=32, decay_lora=16),
        subquadratic=True,
        tie_embeddings=False,
        remat=False,
    )
