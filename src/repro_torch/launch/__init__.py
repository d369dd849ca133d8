"""Drivers: the training step and its CLI (``python -m repro_torch.launch.train``)."""
