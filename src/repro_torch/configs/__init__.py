from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config  # noqa: F401
