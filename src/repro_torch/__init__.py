"""repro_torch — the PyTorch/CUDA port of the HyCA fault-tolerant runtime.

The package mirrors ``src/repro/`` module for module (``core/``,
``kernels/``, ``models/``, ``configs/``, ``obs/``, ``serving/``) and holds the
hand-written Hopper kernels under ``csrc/``.  It imports neither JAX nor any
module of the JAX package: what it needs from there it keeps as its own copy.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
