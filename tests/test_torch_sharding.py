"""The port's logical-axis sharding (``repro_torch.dist.sharding``) and mesh
(``repro_torch.launch.mesh``) held against the JAX package's.

The reference's specs are built on JAX meshes over one repeated CPU device
(what its own ``tests/test_sharding.py`` does: the resolver reads only axis
names and sizes) and on ``jax.eval_shape`` params; the port's on its
abstract ``MeshSpec`` and ``meta`` params.  A layer stack's leaf is one
spec over the stacked shape in both, compared leaf by leaf.
"""
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import get_config as jget
from repro.dist import sharding as JS
from repro.models.lm import init_cache as jcache, init_params as jinit
from repro_torch.configs import ARCH_IDS, get_config as tget
from repro_torch.dist import sharding as TS
from repro_torch.launch.mesh import MeshSpec, make_host_mesh, make_production_mesh
from repro_torch.models.lm import init_cache as tcache, init_params as tinit

ROOT = Path(__file__).resolve().parents[1]
MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")), ((1, 1), ("data", "model"))]


def _jmesh(shape, names):
    devs = np.array([jax.devices()[0]] * int(np.prod(shape))).reshape(shape)
    return Mesh(devs, names)


def _jleaves(spec_tree):
    flat = jax.tree_util.tree_flatten_with_path(spec_tree, is_leaf=lambda x: isinstance(x, JS.P))[0]
    return [(tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p), tuple(sp)) for p, sp in flat]


def _tleaves(tree, path=()):
    """(path, spec) per reference leaf, dict keys sorted as JAX flattens
    them; every list is a layer stack, whose layers must all carry the same
    spec."""
    if isinstance(tree, dict):
        return [e for k in sorted(tree) for e in _tleaves(tree[k], path + (k,))]
    if isinstance(tree, list):
        layers = [_tleaves(lp, path) for lp in tree]
        assert all(lay == layers[0] for lay in layers), path
        return layers[0]
    return [(path, tree)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_zero1_and_cache_specs_match_reference(arch):
    """``param_specs`` and ``zero1_specs`` under tp, dp and ep, and
    ``cache_specs`` of a decode_32k cache, equal JAX's spec for spec on the
    16x16, 2x16x16 and 1x1 meshes, at full width."""
    jcfg, tcfg = jget(arch), tget(arch)
    jp = jax.eval_shape(lambda k: jinit(k, jcfg), jax.random.key(0))
    tp = tinit(torch.Generator(), tcfg, device="meta")
    jc = jax.eval_shape(lambda: jcache(jcfg, 128, 32768))
    tc = tcache(tcfg, 128, 32768, device="meta")
    for shape, names in MESHES:
        jm, tm = _jmesh(shape, names), MeshSpec(shape, names)
        for prof in ("tp", "dp", "ep"):
            assert _tleaves(TS.param_specs(tp, tm, prof)) == _jleaves(JS.param_specs(jp, jm, prof)), (shape, prof)
            assert _tleaves(TS.zero1_specs(tp, tm, prof)) == _jleaves(JS.zero1_specs(jp, jm, prof)), (shape, prof)
        assert _tleaves(TS.cache_specs(tc, tm)) == _jleaves(JS.cache_specs(jc, jm)), shape


def test_resolve_spec_known_cases():
    m2, m3 = MeshSpec(*MESHES[0]), MeshSpec(*MESHES[1])
    assert TS.resolve_spec(["batch", None], (256, 4096), m3) == (("pod", "data"),)
    assert TS.resolve_spec(["batch", None], (1, 1), m3) == ()
    assert TS.resolve_spec(["batch", None], (2, 1), m3) == ("pod",)  # a one-axis tuple is the name
    assert TS.resolve_spec([None, None, "kv_heads", None], (1, 8, 2, 128), m2) == ()
    with TS.use_rules(TS.DP_RULES):
        assert TS.resolve_spec(["batch"], (512,), m3) == (("pod", "data", "model"),)
    for dims, logical in (((256, 4096), ["batch", None]), ((2, 1), ["batch", None]), ((64, 151936), ["batch", "vocab"])):
        jm = _jmesh(*MESHES[1])
        assert TS.resolve_spec(logical, dims, m3) == tuple(JS.resolve_spec(logical, dims, jm))


def test_resolve_spec_always_divisible_property():
    """The reference's hypothesis property (``tests/test_sharding.py``),
    run against the port."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    meshes = (MeshSpec(*MESHES[0]), MeshSpec(*MESHES[1]))

    def prod_of(entry, mesh):
        sizes = TS.axis_sizes(mesh)
        return int(np.prod([sizes[a] for a in TS.spec_axes(entry)]))

    @given(st.lists(st.sampled_from([1, 2, 3, 8, 16, 32, 256, 151936, 49155]), min_size=1, max_size=4))
    @settings(max_examples=100, deadline=None)
    def prop(dims):
        logical = ["batch", "kv_heads", "mlp", "vocab"][: len(dims)]
        for mesh in meshes:
            spec = TS.resolve_spec(logical, dims, mesh)
            entries = list(spec) + [None] * (len(dims) - len(spec))
            for d, e in zip(dims, entries):
                assert d % prod_of(e, mesh) == 0
            jm = _jmesh(mesh.shape, mesh.axis_names)
            assert spec == tuple(JS.resolve_spec(logical, dims, jm))

    prop()


def test_meshes_and_shard_outside_a_mesh(monkeypatch):
    assert make_production_mesh() == MeshSpec((16, 16), ("data", "model"))
    assert make_production_mesh(multi_pod=True).size == 512
    assert make_host_mesh(device="cpu") == MeshSpec((1, 1), ("data", "model"), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_host_mesh()
    x = torch.ones(4, 4)
    assert TS.shard(x, "batch", None) is x
    with TS.use_mesh(make_production_mesh()):
        assert TS.current_mesh().shape == (16, 16)
        assert TS.shard(x, "batch", None) is x  # a plain tensor has no placement
    assert TS.current_mesh() is None


_NAMED = r'''
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from repro_torch.dist import sharding as TS

names = ("data", "model")
cases = [((64, 8), ("data", "model")), ((64, 8), (("data", "model"),)), ((8, 64, 12), (None, "model")),
         ((32, 4), ("data",)), ((16, 16), ()), ((4, 16, 8), (None, ("data", "model"), None))]
tree = {"a": cases[0][1], "blocks": [{"w": cases[2][1]}, {"w": cases[2][1]}]}
for rank in range(16):
    dist.init_process_group("fake", rank=rank, world_size=16, store=FakeStore())
    mesh = DeviceMesh("cpu", torch.arange(16).reshape(4, 4), mesh_dim_names=names)
    coord = dict(zip(names, mesh.get_coordinate()))
    for shape, spec in cases:
        local = list(shape)
        offset = [0] * len(shape)
        for d, entry in enumerate(spec):
            axes = TS.spec_axes(entry)
            g, idx = 1, 0
            for a in axes:
                idx = idx * 4 + coord[a]
                g *= 4
            local[d] = shape[d] // g
            offset[d] = idx * local[d]
        t = distribute_tensor(torch.empty(shape, device="meta"), mesh, TS.placements(mesh, spec))
        got = compute_local_shape_and_global_offset(shape, mesh, TS.placements(mesh, spec))
        assert tuple(t.to_local().shape) == tuple(local), (rank, shape, spec, t.to_local().shape, local)
        assert tuple(got[0]) == tuple(local) and tuple(got[1]) == tuple(offset), (rank, shape, spec, got, offset)
    pl = TS.named(mesh, tree)
    assert pl["a"] == TS.placements(mesh, cases[0][1]) and pl["blocks"][1]["w"] == TS.placements(mesh, cases[2][1])
    dist.destroy_process_group()
print("ok")
'''


def test_named_placements_on_the_fake_backend():
    """``named`` / ``placements`` on a 4x4 DeviceMesh of the ``fake``
    process group: for every rank, each spec's DTensor holds the local shape
    at the global offset that the spec gives (a tensor dim over two axes
    included, major to minor)."""
    out = subprocess.run([sys.executable, "-c", _NAMED], capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]


def test_placements_refuse_what_a_mesh_cannot_hold():
    mesh = MeshSpec(*MESHES[1])
    with pytest.raises(ValueError, match="names the axes"):
        TS.placements(mesh, ("expert",))
    with pytest.raises(ValueError, match="mesh's order"):
        TS.placements(mesh, (("data", "pod"),))
