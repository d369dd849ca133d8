"""Architecture registry: ``arch`` id → :class:`~repro_torch.models.lm.LMConfig`.

The port has eight of the JAX registry's ten ids: the dense, moe, vlm and
encdec families.  The two recurrent ones are known and raise ``KeyError``
naming the slice that brings their model family.
"""
from __future__ import annotations

import importlib

from repro_torch.models.lm import LMConfig

_MODULES = {
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "qwen1.5-0.5b": "repro_torch.configs.qwen1p5_0p5b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b",
    "llava-next-mistral-7b": "repro_torch.configs.llava_next_mistral_7b",
}

# the rest of the JAX registry, and the slice that ports each family
_LATER = {
    "zamba2-1.2b": "the recurrent slice (hybrid: Mamba2 chunked SSD, shared attention)",
    "rwkv6-7b": "the recurrent slice (SSM: RWKV6)",
}

ARCH_IDS = tuple(_MODULES)


def _mod(arch: str):
    if arch in _LATER:
        raise KeyError(f"arch {arch!r} is not ported yet: it comes with {_LATER[arch]}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {', '.join(ARCH_IDS)}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str) -> LMConfig:
    return _mod(arch).config()


def get_smoke_config(arch: str) -> LMConfig:
    return _mod(arch).smoke_config()
