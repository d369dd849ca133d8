"""Production and host meshes.

A :class:`MeshSpec` is an abstract mesh: axis names and sizes, which is all
the sharding rules (:mod:`repro_torch.dist.sharding`) read.  Nothing is
allocated and no process group is made; the production meshes describe 256
and 512 cards the port never holds at once.  :func:`fake_device_mesh` binds
a :class:`MeshSpec` to a real ``DeviceMesh`` on the ``fake`` process group,
as rank 0 of all its devices: DTensors on it run every rank-0 op and issue
every collective without a peer, so a sharded step of the production meshes
can be traced on ``meta`` tensors on one host.
"""
from __future__ import annotations

import contextlib
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


@dataclasses.dataclass(frozen=True)
class BoundMesh:
    """A :class:`MeshSpec` bound to the ``DeviceMesh`` its DTensors live on.

    The sharding rules read ``shape`` and ``axis_names`` (the spec's);
    ``dims`` gives the spec axes each dim of ``device_mesh`` stands for,
    major to minor, and :func:`~repro_torch.dist.sharding.placements` maps a
    spec onto those dims."""
    spec: MeshSpec
    device_mesh: object
    dims: tuple[tuple[str, ...], ...]

    @property
    def shape(self) -> tuple[int, ...]:
        return self.spec.shape

    @property
    def axis_names(self) -> tuple[str, ...]:
        return self.spec.axis_names

    @property
    def size(self) -> int:
        return self.spec.size


def device_dims(spec: MeshSpec) -> tuple[tuple[str, ...], ...]:
    """The dims of the ``DeviceMesh`` that carries ``spec``: the axes before
    ``model`` (``pod`` and ``data``) are one dim, ``model`` another.

    The specs put ``pod`` and ``data`` on the same tensor dim, or neither
    (the batch, ZeRO-1's data axes).  Over two mesh dims DTensor would
    reduce a sum over them in two collectives (over 2, then over 16
    devices) where the reference's compiled module issues one over the 32,
    and its sharding propagation would search its redistribution plans over
    three mesh dims, far slower than over two.  One dim of their product
    holds the same ranks in the same groups."""
    names = spec.axis_names
    batch = tuple(a for a in names if a != "model")
    dims = ((batch,) if batch else ()) + ((("model",),) if "model" in names else ())
    if tuple(a for g in dims for a in g) != names:
        raise ValueError(f"mesh axes {names}: the batch axes must precede model")
    return dims


@contextlib.contextmanager
def fake_device_mesh(spec: MeshSpec):
    """``spec`` bound (:class:`BoundMesh`) to a ``DeviceMesh`` of
    ``device_type="cpu"`` on a ``fake`` process group of ``spec.size`` ranks,
    this process rank 0; its dims are :func:`device_dims`'s (16 x 16 for
    the single-pod mesh, 32 x 16 for the multi-pod one, the pod and data
    axes as one).  The process group is created on entry and destroyed on
    exit, so processes that run many callers (a test runner) start each
    with none.  Refused while another default process group exists."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_device_mesh: a default process group already exists")
    dims = device_dims(spec)
    sizes = dict(zip(spec.axis_names, spec.shape))
    dist.init_process_group("fake", rank=0, world_size=spec.size, store=FakeStore())
    try:
        dm = init_device_mesh("cpu", tuple(math.prod(sizes[a] for a in g) for g in dims),
                              mesh_dim_names=tuple("_".join(g) for g in dims))
        yield BoundMesh(spec, dm, dims)
    finally:
        dist.destroy_process_group()
