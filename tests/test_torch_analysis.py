"""The port's analysis tier held against the JAX package's: the shape cells
and their inputs (``configs/shapes.py``), parameter counts, collective
statistics (``launch/hlo_stats.py``), the roofline (``launch/roofline.py``),
the cost probes (``launch/probes.py``) and the dry run
(``launch/dryrun.py``).

JAX runs ``eval_shape`` only: nothing is compiled.  The reference's
``repro.launch.dryrun`` and ``repro.launch.probes`` set ``XLA_FLAGS`` when
imported or run (512 host devices), so they are never imported here; the
reference's ``hlo_stats``, ``roofline`` and ``configs.shapes`` are.
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import get_config as jget
from repro.configs import shapes as JSH
from repro.launch import hlo_stats as JH
from repro.launch import roofline as JR
from repro_torch.configs import ARCH_IDS, get_config as tget, get_smoke_config
from repro_torch.configs import shapes as TSH
from repro_torch.launch import dryrun as TD
from repro_torch.launch import hlo_stats as TH
from repro_torch.launch import hw
from repro_torch.launch import probes as TP
from repro_torch.launch import roofline as TR
from repro_torch.launch.mesh import MeshSpec

ROOT = Path(__file__).resolve().parents[1]
MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")), ((1, 1), ("data", "model"))]


def _jmesh(shape, names):
    devs = np.array([jax.devices()[0]] * int(np.prod(shape))).reshape(shape)
    return Mesh(devs, names)


def _tflat(tree, path=(), n_layers=None):
    """(path, leaf, n_layers) in JAX's flattening order: every list is a
    layer stack whose first layer stands for it (n_layers its length, None
    outside a stack)."""
    if isinstance(tree, dict):
        return [e for k in sorted(tree) for e in _tflat(tree[k], path + (k,), n_layers)]
    if isinstance(tree, list):
        return _tflat(tree[0], path, len(tree))
    return [(path, tree, n_layers)]


def _jflat(tree, is_leaf=None):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return [(tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p), leaf) for p, leaf in flat]


def _shape_dtype(t, n_layers):
    shape = tuple(t.shape) if n_layers is None else (n_layers, *t.shape)
    return shape, str(t.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_shardings_param_counts_and_model_flops_match_reference(arch):
    """Every applicable cell's inputs have the reference's shapes and dtypes
    (the cache as stacked leaves), all on ``meta``; ``input_shardings``
    equals JAX's on three meshes; ``n_params`` and ``n_active_params``
    equal JAX's, and so does ``model_flops`` at every cell and at the
    served decode step's."""
    jcfg, tcfg = jget(arch), tget(arch)
    assert [c.name for c in TSH.applicable_cells(tcfg)] == [c.name for c in JSH.applicable_cells(jcfg)]
    for cell in TSH.applicable_cells(tcfg):
        jcell = JSH.SHAPES[cell.name]
        assert dataclasses.astuple(cell) == dataclasses.astuple(jcell)
        ts, js = TSH.input_specs(tcfg, cell), JSH.input_specs(jcfg, jcell)
        tl, jl = _tflat(ts), _jflat(js)
        assert [p for p, _, _ in tl] == [p for p, _ in jl]
        for (_, t, n), (_, j) in zip(tl, jl):
            assert _shape_dtype(t, n) == (tuple(j.shape), str(j.dtype))
            assert t.device.type == "meta"
        for shape, names in MESHES:
            tsh = _tflat(TSH.input_shardings(tcfg, cell, MeshSpec(shape, names)))
            jsh = _jflat(JSH.input_shardings(jcfg, jcell, _jmesh(shape, names)),
                         is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            assert [(p, s) for p, s, _ in tsh] == [(p, tuple(s)) for p, s in jsh]
    n, n_active = tcfg.n_params(), tcfg.n_active_params()
    assert (n, n_active) == (jcfg.n_params(), jcfg.n_active_params())
    for cfg in (jcfg, tcfg):  # each count traces the params once; model_flops reads it per cell
        object.__setattr__(cfg, "n_active_params", lambda: n_active)
    served = ("served_decode", "decode", 96, 4)
    for cell, jcell in [(c, JSH.SHAPES[c.name]) for c in TSH.applicable_cells(tcfg)] + [
            (TSH.ShapeCell(*served), JSH.ShapeCell(*served))]:
        assert TR.model_flops(tcfg, cell) == JR.model_flops(jcfg, jcell)


def test_collective_stats_match_reference_hlo():
    """The same collectives as HLO text lines (list and iota replica groups,
    async start/done pairs, a tuple result) and as trace records give the
    reference's counts, result bytes and ring wire bytes."""
    hlo = "\n".join([
        "  %ar = f32[1024,512]{1,0} all-reduce(f32[1024,512]{1,0} %x), replica_groups={{0,1,2,3}}, to_apply=%sum",
        "  %ag = bf16[64,4096]{1,0} all-gather(bf16[4,4096]{1,0} %y), replica_groups=[16,16]<=[256], dimensions={0}",
        "  %rs = f32[8,128]{1,0} reduce-scatter(f32[128,128]{1,0} %z), replica_groups={{0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15}}, dimensions={0}",
        "  %a2a = bf16[32,64]{1,0} all-to-all(bf16[32,64]{1,0} %w), replica_groups=[32,8]<=[256]",
        "  %cp = s32[16]{0} collective-permute(s32[16]{0} %v), source_target_pairs={{0,1},{1,0}}",
        "  %ars = f32[256]{0} all-reduce-start(f32[256]{0} %u), replica_groups={{0,1}}",
        "  %ard = f32[256]{0} all-reduce-done(f32[256]{0} %ars)",
        "  %ag2 = (bf16[2,8]{1,0}, f32[4]{0}) all-gather(bf16[1,8]{1,0} %a, f32[2]{0} %b), replica_groups={{0,1}}",
    ])
    recs = [
        TH.OpRecord("c10d", "all_reduce", 0, 1024 * 512 * 4, "all-reduce", 4),
        TH.OpRecord("c10d", "all_gather_into_tensor", 0, 64 * 4096 * 2, "all-gather", 16),
        TH.OpRecord("c10d", "reduce_scatter_tensor", 0, 8 * 128 * 4, "reduce-scatter", 16),
        TH.OpRecord("c10d", "all_to_all_single", 0, 32 * 64 * 2, "all-to-all", 8),
        TH.OpRecord("c10d", "permute", 0, 16 * 4, "collective-permute", None),
        TH.OpRecord("c10d", "all_reduce", 0, 256 * 4, "all-reduce", 2),
        TH.OpRecord("c10d", "all_gather_into_tensor_coalesced", 0, 2 * 8 * 2 + 4 * 4, "all-gather", 2),
        TH.OpRecord("aten.mm.default", "mm", 100, 1000),
    ]
    for n_dev in (256, 2):
        j, t = JH.collective_stats(hlo, n_dev), TH.collective_stats(recs, n_dev)
        assert (t.counts, t.result_bytes, t.wire_bytes) == (j.counts, j.result_bytes, j.wire_bytes)
        assert t.total_wire_bytes == j.total_wire_bytes and t.total_result_bytes == j.total_result_bytes


_COLL = r'''
import torch, torch.distributed as dist
import torch.distributed._functional_collectives as fc
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.hlo_stats import OpTrace, collective_stats
dist.init_process_group("fake", rank=1, world_size=4, store=FakeStore())
g = dist.group.WORLD
x = torch.ones(8, 16)
with OpTrace() as tr:
    a = fc.wait_tensor(fc.all_reduce(x, "sum", g))
    b = fc.wait_tensor(fc.all_gather_tensor(x, 0, g))
    c = fc.wait_tensor(fc.reduce_scatter_tensor(x, "sum", 0, g))
    y = a @ x.T
recs = [(r.collective, r.bytes, r.group_size) for r in tr.records if r.collective]
assert recs == [("all-reduce", 512, 4), ("all-gather", 2048, 4), ("reduce-scatter", 128, 4)], recs
cs = collective_stats(tr, 4)
assert cs.wire_bytes["all-reduce"] == 512 * 1.5 and cs.wire_bytes["reduce-scatter"] == 128 * 3
assert tr.flops == 2 * 8 * 16 * 8
print("ok")
'''


def test_op_trace_records_functional_collectives():
    """Functional collectives on the ``fake`` process group (4 ranks) are
    recorded with their result bytes and group size; a matmul's FLOPs are
    counted."""
    out = subprocess.run([sys.executable, "-c", _COLL], capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]


def test_op_histogram_and_bytes():
    x = torch.ones(4, 8, device="meta")
    w = torch.ones(8, 6, device="meta")
    with TH.OpTrace() as tr:
        y = (x @ w).view(2, 12).transpose(0, 1).clone().to(torch.bfloat16)
        torch.bmm(x[None], w[None])
    h = TH.op_histogram(tr)
    assert h == {"fusion": 0, "dot": 2, "convolution": 0, "scatter": 0, "gather": 0, "transpose": 1,
                 "reshape": 1, "copy": 2}
    assert y.shape == (12, 2)
    mm = [r for r in tr.records if r.op == "mm"][0]
    assert mm.flops == 2 * 4 * 8 * 6 and mm.bytes == 4 * (32 + 48 + 24)
    assert all(r.bytes == 0 for r in tr.records if r.op in ("view", "transpose"))


def test_roofline_terms_match_reference(tmp_path, monkeypatch):
    """The reference's ``analyse`` and the port's, reading one probe record
    with the reference's constants set to the H100's (its module attributes
    monkeypatched, its file untouched), give the same terms."""
    monkeypatch.setattr(JR, "PEAK_FLOPS_BF16", hw.PEAK_FLOPS_BF16)
    monkeypatch.setattr(JR, "HBM_BW", hw.HBM_BW)
    monkeypatch.setattr(JR, "ICI_BW", hw.NVLINK_BW)
    monkeypatch.setattr(JR, "N_DEV", 1)
    recs = [
        {"arch": "qwen1.5-0.5b", "shape": "decode_32k", "status": "ok", "n_devices": 1,
         "total": {"flops": 5.3e11, "bytes": 6.6e12, "wire_bytes": 0.0}},
        {"arch": "granite-moe-3b-a800m", "shape": "train_4k", "status": "ok", "n_devices": 1,
         "total": {"flops": 4.1e16, "bytes": 2.0e13, "wire_bytes": 3.0e12}},
        {"arch": "rwkv6-7b", "shape": "long_500k", "status": "ok", "n_devices": 1,
         "total": {"flops": 1.5e10, "bytes": 1.6e10, "wire_bytes": 1.0e12}},
        {"arch": "whisper-tiny", "shape": "prefill_32k", "status": "FAILED", "error": "x"},
    ]
    for i, r in enumerate(recs):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    j, t = JR.analyse(str(tmp_path)), TR.analyse(str(tmp_path))
    keys = ("compute_s", "memory_s", "collective_s", "dominant", "bound_s", "model_flops_global",
            "model_flops_per_dev", "model_over_hlo", "roofline_fraction")
    assert [[r.get(k) for k in keys] for r in t] == [[r.get(k) for k in keys] for r in j]
    assert [r["dominant"] for r in t[:3]] == ["memory", "compute", "collective"]
    assert TR.to_markdown(t).count("\n") == 5 and "FAILED" in TR.to_markdown(t)


SMOKE_CELLS = {
    "train": TSH.ShapeCell("t", "train", 8, 4),
    "prefill": TSH.ShapeCell("p", "prefill", 32, 2),  # llava: 16 patches; rwkv6: chunks of 16
    "decode": TSH.ShapeCell("d", "decode", 16, 2),
}


@pytest.mark.parametrize("arch,kinds", [
    ("qwen1.5-0.5b", ("train", "prefill", "decode")),
    ("deepseek-moe-16b", ("train", "decode")),      # moe, one first-k dense block
    ("zamba2-1.2b", ("train", "decode")),           # hybrid: 5 layers in groups of 2
    ("llava-next-mistral-7b", ("prefill",)),
    ("whisper-tiny", ("decode",)),
    ("rwkv6-7b", ("prefill", "decode")),
])
def test_probe_reconstruction_equals_the_direct_count(arch, kinds):
    """For a smoke config of each family, the reduced-depth reconstruction
    equals the direct full-depth count of the same step, FLOPs and bytes."""
    cfg = get_smoke_config(arch)
    for kind in kinds:
        rec = TP.probe_cell(cfg, SMOKE_CELLS[kind], n_micro_full=2, direct=True)
        for k in ("flops", "bytes"):
            assert rec["total"][k] == pytest.approx(rec["direct"][k], rel=1e-9, abs=0), (kind, k)
        assert rec["direct"]["flops"] > 0 and rec["total"]["wire_bytes"] == 0.0
    assert rec["effective_layers"] == cfg.n_layers


def test_one_dense_layers_probe_flops_are_its_matmuls():
    """qwen's smoke decode step: the probe's per-layer FLOPs are exactly the
    layer's matmuls counted by hand, and the protected calls are recorded."""
    cfg = get_smoke_config("qwen1.5-0.5b")
    b, smax = 2, 16
    rec = TP.probe_cell(cfg, TSH.ShapeCell("d", "decode", smax, b), hyca=True)
    d, hd, f = cfg.d_model, cfg.d_model // cfg.n_heads, cfg.d_ff
    proj = 2 * b * (d * cfg.n_heads * hd + 2 * d * cfg.n_kv * hd + cfg.n_heads * hd * d)
    ffn = 2 * b * 3 * d * f
    attn = 2 * 2 * b * cfg.n_heads * hd * smax  # scores and the weighted sum over the cache
    assert rec["per_layer"]["flops"] == proj + ffn + attn
    assert rec["protected_calls_probe"] == 7 * 1 + 1  # 7 matmuls in one layer, and the head
    with pytest.raises(NotImplementedError, match="no sharded step"):
        TP.probe_cell(cfg, SMOKE_CELLS["decode"], MeshSpec((16, 16), ("data", "model")))
    with pytest.raises(ValueError, match="serving option"):
        TP.probe_cell(cfg, SMOKE_CELLS["train"], serve_bf16=True)
    with pytest.raises(ValueError, match="train-step option"):
        TP.probe_cell(cfg, SMOKE_CELLS["decode"], cast_once=True)


def test_dryrun_host_and_specs_only(tmp_path):
    """The dry run traces qwen's decode_32k (128 x 32768 cache) on ``meta``
    with exact argument and output bytes; the CLI (in a subprocess: it makes
    a ``fake`` process group) traces the cell on the production meshes,
    where each record keeps its specs and its per-device argument bytes,
    which the traced arguments equal; and every applicable qwen cell's specs
    divide their dimensions on both meshes."""
    rec = TD.run_cell("qwen1.5-0.5b", "decode_32k", "host", verbose=False)
    cfg = tget("qwen1.5-0.5b")
    kv = 2 * cfg.n_layers * 128 * 32768 * cfg.n_kv * (cfg.head_dim or cfg.d_model // cfg.n_heads) * 2
    args = 4 * cfg.n_params() + kv + cfg.n_layers * 128 * 4 + 128 * 4
    assert rec["status"] == "ok" and rec["memory_analysis"]["argument_size_in_bytes"] == args
    assert rec["memory_analysis"]["output_size_in_bytes"] == 128 * cfg.padded_vocab * 2 + kv + cfg.n_layers * 128 * 4
    assert rec["cost_analysis"]["flops"] > 0 and rec["collectives"]["total_wire_bytes"] == 0
    assert rec["op_histogram"]["dot"] > 0 and rec["op_histogram"]["fusion"] == 0
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen1.5-0.5b", "--shape",
                          "decode_32k", "--mesh", "both", "--out-dir", str(tmp_path)], capture_output=True, text=True,
                         timeout=300, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    got = {p.name: json.loads(p.read_text()) for p in tmp_path.glob("*.json")}
    assert sorted(got) == [f"qwen1.5-0.5b__decode_32k__{m}.json" for m in ("multi", "single")]
    for r in got.values():
        assert r["status"] == "ok" and r["collectives"]["counts"]["all-reduce"] == 2 * cfg.n_layers + 1
        assert r["memory_analysis"]["argument_size_in_bytes"] == sum(r["argument_bytes_per_device"].values())
        assert r["specs"]["params"]["blocks.ffn.down"] == [None, "model", None]
    for mk, multi in (("single", False), ("multi", True)):
        mesh = TD.make_production_mesh(multi_pod=multi)
        for cell in TSH.applicable_cells(cfg):
            single = TD.spec_record({}, cfg, cell, mesh)
            assert single["specs"]["params"]["blocks.ffn.down"] == [None, "model", None]
            want = {"params", "inputs", "opt"} if cell.kind == "train" else {"params", "inputs"}
            assert set(single["argument_bytes_per_device"]) == want
    with pytest.raises(ValueError, match="puts 16 devices"):
        TD.check_divides({"w": torch.empty(8, 4, device="meta")}, {"w": (None, "model")},
                         MeshSpec((16, 16), ("data", "model")), "params")
