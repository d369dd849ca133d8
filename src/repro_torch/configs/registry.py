"""Architecture registry: ``arch`` id → :class:`~repro_torch.models.lm.LMConfig`.

All ten ids of the JAX registry: the dense, moe, vlm, encdec, ssm and
hybrid families.
"""
from __future__ import annotations

import importlib

from repro_torch.models.lm import LMConfig

_MODULES = {  # the reference registry's ids, in its order
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen1p5_0p5b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "llava-next-mistral-7b": "repro_torch.configs.llava_next_mistral_7b",
}

ARCH_IDS = tuple(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {', '.join(ARCH_IDS)}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str) -> LMConfig:
    return _mod(arch).config()


def get_smoke_config(arch: str) -> LMConfig:
    return _mod(arch).smoke_config()
