"""Architecture registry: ``arch`` id → :class:`~repro_torch.models.lm.LMConfig`.

All ten ids of the JAX registry (:data:`ARCH_IDS`): the dense, moe, vlm,
encdec, ssm and hybrid families; and the port's own (:data:`PORT_ONLY`),
outside the parity tests that walk the JAX registry's ids.
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

# the port's own ids, which the JAX registry has not: id -> (module, the
# function that gives its config)
PORT_ONLY = {
    "deepseek-v3": ("repro_torch.configs.deepseek_v3", "config"),
    "deepseek-v3-ep32": ("repro_torch.configs.deepseek_v3", "ep32_config"),
}


def _mod(arch: str):
    if arch in PORT_ONLY:
        return importlib.import_module(PORT_ONLY[arch][0])
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {', '.join(ARCH_IDS + tuple(PORT_ONLY))}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str) -> LMConfig:
    return getattr(_mod(arch), PORT_ONLY[arch][1] if arch in PORT_ONLY else "config")()


def get_smoke_config(arch: str) -> LMConfig:
    return _mod(arch).smoke_config()
