"""The sharded dry run on DTensors, held against the reference's compiled
dry run on the same production meshes.

The port runs a step on DTensors of a ``fake`` process group
(``launch/mesh.py::fake_device_mesh``), so every test that makes one runs
in a subprocess: a pytest worker runs many files and must not keep a
process group.  The reference's ``repro.launch.dryrun`` sets ``XLA_FLAGS``
to 512 host devices when imported, so it is imported only in its own
subprocess; there its ``make_production_mesh`` is replaced from outside by
meshes of Auto axes (its own meshes have Explicit axes and fail, ROADMAP
C12) and its ``get_config`` by configs cut in depth.  No JAX file is
edited.

The cut cells: qwen1.5-0.5b decode_32k on 16 x 16 and granite-moe-3b-a800m
decode_32k on 2 x 16 x 16, both at 2 layers and full width.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.dist import sharding as TS
from repro_torch.launch import hw
from repro_torch.launch import roofline as TR
from repro_torch.launch.mesh import BoundMesh, MeshSpec, device_dims, make_production_mesh
from repro_torch.models.attention import _softmax_over_cache
from repro_torch.tree import stack_tree, tree_leaves, unstack_tree

ROOT = Path(__file__).resolve().parents[1]
CUT_LAYERS = 2
CUT_CELLS = (("qwen1.5-0.5b", "single"), ("granite-moe-3b-a800m", "multi"))


def _run(script: str, timeout: int = 300, jax: bool = False) -> dict:
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", "/tmp")}
    if jax:
        env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=timeout, env=env,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


# --------------------------------------------------------------------------- #
# the reference: run_cell on Auto-axes meshes, its collectives read from the
# compiled module by its own hlo_stats
# --------------------------------------------------------------------------- #
_REFERENCE = r'''
import dataclasses, json, re
import repro.launch.dryrun as D
import jax
from jax.sharding import AxisType
from repro.configs import get_config
from repro.launch import hlo_stats as H

D.make_production_mesh = lambda *, multi_pod=False: jax.make_mesh(
    (2, 16, 16) if multi_pod else (16, 16), ("pod", "data", "model") if multi_pod else ("data", "model"),
    axis_types=(AxisType.Auto,) * (3 if multi_pod else 2))
D.get_config = lambda a: dataclasses.replace(get_config(a), n_layers=LAYERS)
ops = []
stats = D.collective_stats

def collective_stats(hlo, n_dev):
    ops.clear()
    for line in hlo.splitlines():
        m = re.search(r"= (.*?) (all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)(-start)?\(",
                      line)
        if m:
            ops.append({"kind": m.group(2), "group": H._group_size(line, n_dev), "bytes": H._shape_bytes(m.group(1)),
                        "shape": m.group(1), "in_loop": "while/body" in line})
    return stats(hlo, n_dev)

D.collective_stats = collective_stats
out = {}
for arch, mk in CELLS:
    rec = D.run_cell(arch, "decode_32k", mk, verbose=False)
    rec["ops"] = list(ops)
    out[arch] = rec
print(json.dumps(out))
'''

# --------------------------------------------------------------------------- #
# the port: the same cut cells traced on the fake process group
# --------------------------------------------------------------------------- #
_PORT_CUT = r'''
import dataclasses, json
import torch
from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun, probes
from repro_torch.launch.hlo_stats import dot_flops
from repro_torch.launch.mesh import fake_device_mesh, make_production_mesh

dryrun.get_config = lambda a: dataclasses.replace(get_config(a), n_layers=LAYERS)
out = {}
for arch, mk in CELLS:
    cfg = dryrun.get_config(arch)
    rec = dryrun.run_cell(arch, "decode_32k", mk, verbose=False)
    host, *_ = probes.trace_step(cfg, SHAPES["decode_32k"])
    spec = make_production_mesh(multi_pod=mk == "multi")
    with fake_device_mesh(spec) as mesh:
        trace, args, _, _ = probes.trace_step(cfg, SHAPES["decode_32k"], mesh=mesh)
        moe = args[0]["blocks"][0].get("moe")
        expert_pl = [p.dim if p.is_shard() else None for p in moe["gate"].placements] if moe else None
    rec["ops"] = [{"kind": r.collective, "group": r.group_size, "bytes": r.bytes} for r in trace.records
                  if r.collective]
    rec["bmm_flops"] = [r.flops for r in trace.records if r.op == "bmm"]
    rec["dot_flops"] = dot_flops(trace)
    rec["host_dot_flops"] = dot_flops(host)
    rec["expert_placements"] = expert_pl
    out[arch] = rec
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def cut_records():
    consts = f"LAYERS = {CUT_LAYERS}\nCELLS = {CUT_CELLS!r}\n"
    return {"port": _run(consts + _PORT_CUT), "ref": _run(consts + _REFERENCE, jax=True)}


def test_argument_bytes_per_device_equal_the_reference(cut_records):
    """(a) Per device, the traced step's argument bytes equal the
    reference's compiled record to the byte, and the bytes the specs give
    (``spec_record``); both records are ``ok``."""
    for arch, _ in CUT_CELLS:
        port, ref = cut_records["port"][arch], cut_records["ref"][arch]
        assert port["status"] == ref["status"] == "ok"
        got = port["memory_analysis"]["argument_size_in_bytes"]
        assert got == ref["memory_analysis"]["argument_size_in_bytes"], arch
        assert got == sum(port["argument_bytes_per_device"].values()), arch
        # the outputs: the logits and the cache; the reference's module also
        # outputs 32 bytes more (printed, not held)
        print(arch, "output bytes", port["memory_analysis"]["output_size_in_bytes"],
              ref["memory_analysis"]["output_size_in_bytes"])


def test_qwen_dot_flops_per_device_are_the_hosts_over_256(cut_records):
    """(b) qwen's decode on 16 x 16: every sharded dim divides (batch
    128 / 16, 16 heads and 16 KV heads / 16, d_ff 2816 / 16, vocab / 16),
    so one device's dot FLOPs times 256 equal the host trace's exactly.
    XLA's ``flops`` counts elementwise work too, so it is printed beside,
    not held."""
    port, ref = cut_records["port"]["qwen1.5-0.5b"], cut_records["ref"]["qwen1.5-0.5b"]
    assert port["n_devices"] == 256
    assert port["dot_flops"] * 256 == port["host_dot_flops"] > 0
    print("qwen decode_32k per-device flops: port dots", port["dot_flops"], "port all",
          port["cost_analysis"]["flops"], "reference", ref["cost_analysis"]["flops"])


def _act_elems(cfg, batch: int) -> int:
    return batch * cfg.d_model  # one (B, 1, d) decode activation


def test_qwen_collectives_are_megatrons(cut_records):
    """(c) qwen's decode on 16 x 16 under ``tp``: one all-reduce over
    ``model`` (group 16) after each row-parallel projection (``wo``,
    ``down``) and one for the vocab-sharded embedding lookup, of the
    per-device (8, 1, 1024) activation: 2·L + 1, derived from the config.

    The reference's compiled module has the same kind, group and shape for
    those, counted once in its layer loop's body: (its body's count) · L +
    (its count outside the loop) is the same 2·L + 1.  Two differences are
    XLA's choices, stated here:
      * XLA reduces in f32 on the CPU (32768 bytes), the port in the
        activations' bf16 (16384 bytes): held by element count;
      * XLA keeps the residual sharded over ``model`` on its embed dim, so
        it gathers the normed activation before the projections and
        all-reduces the norms' f32 (8, 1) sums, and it gathers the cache
        write's rows and indices over ``data``.  The port keeps the
        residual replicated, writes each device's cache rows in place, and
        instead gathers each stacked norm scale, which the param specs shard
        over ``model`` (the reference's ``leaf_spec``): 2·L all-gathers of
        d bf16 elements, group 16, and nothing else."""
    cfg = get_config("qwen1.5-0.5b")
    L = CUT_LAYERS
    port, ref = cut_records["port"]["qwen1.5-0.5b"], cut_records["ref"]["qwen1.5-0.5b"]
    act = _act_elems(cfg, 128 // 16)
    ar = [o for o in port["ops"] if o["kind"] == "all-reduce"]
    assert len(ar) == 2 * L + 1
    assert all(o["group"] == 16 and o["bytes"] == act * 2 for o in ar)
    ag = [o for o in port["ops"] if o["kind"] == "all-gather"]
    assert len(ag) == 2 * L and all(o["group"] == 16 and o["bytes"] == cfg.d_model * 2 for o in ag)
    assert len(port["ops"]) == 4 * L + 1
    assert port["collectives"]["counts"]["all-reduce"] == 2 * L + 1
    ref_ar = [o for o in ref["ops"] if o["kind"] == "all-reduce" and o["bytes"] == act * 4 and o["group"] == 16]
    assert sum(L if o["in_loop"] else 1 for o in ref_ar) == 2 * L + 1
    assert {o["kind"] for o in ref["ops"]} == {"all-reduce", "all-gather"}
    for o in ref["ops"]:  # the reference's module, its layer loop's body once
        print("reference", o["kind"], o["group"], o["shape"], "in the layer loop" if o["in_loop"] else "")


def test_granite_moe_on_the_multi_pod_mesh(cut_records):
    """(d) granite-moe on 2 x 16 x 16: its 24 query heads and 8 KV heads do
    not divide ``model`` (16), so the column-parallel q, k and v are
    gathered over ``model`` (group 16) before they are split into heads,
    once each a layer; the expert stacks ``(E, d, f)`` are sharded on the
    expert axis and each expert einsum runs on the device's E / 16 experts
    and B / 32 rows.  The reference gathers over the same group (its
    all-gathers of group 16 are printed)."""
    cfg = get_config("granite-moe-3b-a800m")
    L = CUT_LAYERS
    port, ref = cut_records["port"]["granite-moe-3b-a800m"], cut_records["ref"]["granite-moe-3b-a800m"]
    assert port["n_devices"] == 512
    rows, hd = 128 // 32, cfg.d_model // cfg.n_heads
    gathers = [o for o in port["ops"] if o["kind"] == "all-gather" and o["group"] == 16]
    q_bytes, kv_bytes = rows * cfg.n_heads * hd * 2, rows * cfg.n_kv * hd * 2
    assert sum(o["bytes"] == q_bytes for o in gathers) == L
    assert sum(o["bytes"] == kv_bytes for o in gathers) == 2 * L
    assert port["expert_placements"] == [None, 0]  # replicated over (pod, data), experts over model
    m = cfg.moe
    cap = max(1, int(m.capacity_factor * m.top_k * 1 / m.n_experts))
    expert = 2 * rows * (m.n_padded // 16) * cap * cfg.d_model * m.d_expert
    assert port["bmm_flops"].count(expert) == 3 * L, (expert, sorted(set(port["bmm_flops"])))
    assert port["memory_analysis"]["argument_size_in_bytes"] == ref["memory_analysis"]["argument_size_in_bytes"]
    print("reference all-gathers of group 16:", [o for o in ref["ops"] if o["kind"] == "all-gather"
                                                and o["group"] == 16])


# --------------------------------------------------------------------------- #
# every family on a small fake mesh
# --------------------------------------------------------------------------- #
_FAMILIES = r'''
import json
import torch
from repro_torch.configs import get_smoke_config
from repro_torch.configs.shapes import ShapeCell
from repro_torch.launch import probes
from repro_torch.launch.mesh import MeshSpec, fake_device_mesh
from repro_torch.tree import tree_leaves

CELLS = {"train": ShapeCell("t", "train", 8, 4), "prefill": ShapeCell("p", "prefill", 32, 2),
         "decode": ShapeCell("d", "decode", 16, 2)}

def shapes(out, kind):
    if kind == "train":
        return [list(out[1]["loss"].shape), [list(t.shape) for t in tree_leaves(out[0]["params"])]]
    return list(out[0].shape)

res = {}
with fake_device_mesh(MeshSpec((2, 4), ("data", "model"))) as mesh:
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        for kind in (("decode", "prefill", "train") if arch == "qwen1.5-0.5b" else ("decode", "prefill")):
            n_micro = 2 if kind == "train" else 1
            host = probes.trace_step(cfg, CELLS[kind], n_micro=n_micro)
            tr, args, out, _ = probes.trace_step(cfg, CELLS[kind], n_micro=n_micro, mesh=mesh)
            res[f"{arch}/{kind}"] = {"host": shapes(host[2], kind), "sharded": shapes(out, kind),
                                     "collectives": sum(r.collective is not None for r in tr.records),
                                     "flops": tr.flops, "host_flops": host[0].flops}
print(json.dumps(res))
'''


def test_every_family_traces_on_dtensors():
    """Each family's smoke config on a 2 x 4 fake mesh: decode and prefill
    (and qwen's train step) trace on DTensors, and their logits (the train
    step's loss and new params) have the host trace's shapes; each step
    issues collectives and does less work a device than the host does."""
    from repro_torch.configs import ARCH_IDS

    got = _run(f"ARCHS = {list(ARCH_IDS)!r}\n" + _FAMILIES)
    assert len(got) == 2 * len(ARCH_IDS) + 1
    for name, r in got.items():
        assert r["sharded"] == r["host"], name
        assert r["collectives"] > 0 and 0 < r["flops"] < r["host_flops"], (name, r)


# --------------------------------------------------------------------------- #
# pieces that need no process group
# --------------------------------------------------------------------------- #
class _Dims:
    """A stand-in for a device mesh: ``placements`` reads only the names,
    sizes and ``dims`` of a bound mesh."""


def test_bound_mesh_places_the_batch_axes_as_one_dim():
    spec = make_production_mesh(multi_pod=True)
    assert device_dims(spec) == (("pod", "data"), ("model",))
    assert device_dims(make_production_mesh()) == (("data",), ("model",))
    mesh = BoundMesh(spec, _Dims(), device_dims(spec))
    from torch.distributed.tensor import Replicate, Shard

    assert TS.placements(mesh, (("pod", "data"), None, "model")) == (Shard(0), Shard(2))
    assert TS.placements(mesh, (None, "model")) == (Replicate(), Shard(1))
    assert TS.placements(mesh, (("pod", "data", "model"),)) == (Shard(0), Shard(0))
    with pytest.raises(ValueError, match="split the device mesh's dim"):
        TS.placements(mesh, ("pod",))
    # the resolver reads the spec's three axes
    assert TS.resolve_spec(["batch", None, "heads"], (128, 1, 16), mesh) == (("pod", "data"), None, "model")


def test_shard_is_a_no_op_on_plain_tensors():
    """The served and captured steps run on plain tensors: ``shard`` returns
    them as they are, under any mesh, so they launch nothing more."""
    x = torch.randn(4, 1, 8)
    with TS.use_mesh(MeshSpec((2, 4), ("data", "model"))):
        assert TS.shard(x, "batch", None, "embed") is x
        assert TS.shard(x, "batch", "seq", "heads", dims=(4, 1, 2)) is x
    assert not TS.is_dtensor(x)
    sc = torch.randn(2, 3, 5)
    assert torch.equal(_softmax_over_cache(sc), torch.softmax(sc, dim=-1))


def test_stack_tree_round_trip():
    """The optimizer state's stacked layout: a layer stack's per-layer
    leaves stacked on a leading axis, and back."""
    tree = {"blocks": [{"w": torch.full((2, 3), float(i)), "n": {"g": torch.ones(3) * i}} for i in range(4)],
            "embed": torch.ones(5, 2)}
    st = stack_tree(tree)
    assert st["blocks"]["w"].shape == (4, 2, 3) and st["blocks"]["n"]["g"].shape == (4, 3)
    assert st["embed"] is tree["embed"]
    back = unstack_tree(st, tree)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(tree)))
    specs = {"blocks": [{"w": ("data", None, "model")}] * 4, "embed": ("model",)}
    assert TS.stacked_specs(specs) == {"blocks": {"w": ("data", None, "model")}, "embed": ("model",)}


def test_roofline_reads_a_sharded_dry_run_record():
    """A dry-run record's per-device figures: its collective term is its
    ``total_wire_bytes`` over NVLink, its model FLOPs split over its
    ``n_devices``."""
    rec = {"arch": "qwen1.5-0.5b", "shape": "decode_32k", "mesh": "single", "status": "ok", "n_devices": 256,
           "cost_analysis": {"flops": 2.0e9, "bytes accessed": 1.5e10},
           "collectives": {"total_wire_bytes": 1.6e6}}
    row = TR.analyse_record(rec)
    assert row["collective_s"] == 1.6e6 / hw.NVLINK_BW
    assert row["memory_s"] == 1.5e10 / hw.HBM_BW and row["compute_s"] == 2.0e9 / hw.PEAK_FLOPS_BF16
    assert row["model_flops_per_dev"] == row["model_flops_global"] / 256
