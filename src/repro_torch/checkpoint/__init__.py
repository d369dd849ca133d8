from repro_torch.checkpoint.store import CheckpointManager, restore, save  # noqa: F401
