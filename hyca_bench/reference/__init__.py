"""Plain float32 references, one module per model family
(``reference/<family>.py``).  They import torch only: nothing of the port,
of JAX or of the JAX package."""
