"""Architecture registry: ``arch`` id → :class:`~repro_torch.models.lm.LMConfig`.

The port has qwen1.5-0.5b (dense), granite-moe-3b-a800m and deepseek-moe-16b
(moe); every other id of the JAX registry is known and raises ``KeyError``
naming the slice that brings its model family.
"""
from __future__ import annotations

import importlib

from repro_torch.models.lm import LMConfig

_MODULES = {
    "qwen1.5-0.5b": "repro_torch.configs.qwen1p5_0p5b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
}

# the rest of the JAX registry, and the slice that ports each family
_LATER = {
    "whisper-tiny": "the encoder-decoder slice",
    "zamba2-1.2b": "the hybrid (Mamba2) slice",
    "minicpm3-4b": "the MLA slice",
    "starcoder2-3b": "the dense-variants slice (LayerNorm, non-gated FFN)",
    "granite-8b": "the dense-variants slice",
    "rwkv6-7b": "the SSM (RWKV6) slice",
    "llava-next-mistral-7b": "the multimodal slice",
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
