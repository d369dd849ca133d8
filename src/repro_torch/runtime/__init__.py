"""Runtime fault detection on live matmul outputs (the OnlineVerifier).

Elastic re-meshing and straggler mitigation come with the training slice.
"""
from repro_torch.runtime.online_verify import OnlineVerifier, append_fault  # noqa: F401
