"""Optimizer, learning-rate schedule and gradient compression for training."""
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, clip_by_global_norm  # noqa: F401
from repro_torch.optim.schedules import cosine_warmup  # noqa: F401
