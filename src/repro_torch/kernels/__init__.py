"""Hand-written Hopper kernels (``csrc/``) with their plain PyTorch twins."""
