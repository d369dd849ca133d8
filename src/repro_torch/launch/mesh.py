"""Production and host meshes.

A :class:`MeshSpec` is an abstract mesh: axis names and sizes, which is all
the sharding rules (:mod:`repro_torch.dist.sharding`) read.  Nothing is
allocated and no process group is made; the production meshes describe 256
and 512 cards the port never holds at once.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    device_type: str = "cuda"

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axis names {self.axis_names} differ in length")

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """The single-pod 16 x 16 ``(data, model)`` mesh, or the multi-pod
    2 x 16 x 16 ``(pod, data, model)`` one."""
    if multi_pod:
        return MeshSpec((2, 16, 16), ("pod", "data", "model"))
    return MeshSpec((16, 16), ("data", "model"))


def make_host_mesh(model: int = 1, device: str = "cuda") -> MeshSpec:
    """A ``(data, model)`` mesh over this host's cards (``device="cuda"``,
    which raises where there is none), or over one CPU device
    (``device="cpu"``)."""
    if device == "cpu":
        n = 1
    elif device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_host_mesh(device='cuda'): CUDA is not available; pass device='cpu'")
        n = torch.cuda.device_count()
    else:
        raise ValueError(f"make_host_mesh takes device 'cuda' or 'cpu', got {device!r}")
    if n % model:
        raise ValueError(f"{n} devices do not split into a model axis of {model}")
    return MeshSpec((n // model, model), ("data", "model"), device)
