"""The port stands alone: no JAX, nothing of the JAX package, and no silent
CPU fallback when a card was asked for."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_import(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_with_jax_and_reference_package_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro', 'ml_dtypes'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch.serving.server, repro_torch.kernels.ft_matmul\n"
        "import repro_torch.kernels.dppu_recompute, repro_torch.kernels._build\n"
        "import repro_torch.configs, repro_torch.core.scan, repro_torch.models.moe\n"
        "import repro_torch.configs.granite_moe_3b, repro_torch.configs.deepseek_moe_16b\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.os_array_matmul, repro_torch.kernels.ref\n"
        "import repro_torch.repair, repro_torch.obs, repro_torch.obs.counters, repro_torch.obs.series\n"
        "import repro_torch.obs.schema, repro_torch.obs.trace, repro_torch.obs.replay\n"
        "import repro_torch.obs.export, repro_torch.obs.httpd\n"
        "import repro_torch.transient, repro_torch.runtime, repro_torch.core.detection\n"
        "import repro_torch.launch.train, repro_torch.checkpoint.store, repro_torch.optim.compression\n"
        "import repro_torch.data.pipeline, repro_torch.transient.memory, repro_torch.repair.retrain\n"
        "import repro_torch.tree, repro_torch.models.lm\n"
        "import repro_torch.core.campaign, repro_torch.core.reliability, repro_torch.core.perf_model\n"
        "import repro_torch.core.area, repro_torch.core.fault_models, repro_torch.configs.hyca_dla\n"
        "import repro_torch.bench.run\n"
        "repro_torch.bench.run.modules()\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) for m in sys.modules if sys.modules[m])\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_default_to_the_card(monkeypatch):
    from repro_torch.core.scan import build_scan_engine
    from repro_torch.kernels.dppu_recompute import probe_check, probe_check_ref
    from repro_torch.serving import (
        FaultInjector, FaultManager, FaultManagerConfig, FaultTolerantServer, ModelBundle, ServerConfig,
    )

    cfg = ServerConfig()
    assert cfg.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelBundle(cfg)
    # a CPU scan engine computes the plain probe and launches no kernel
    eng = build_scan_engine(4, 4, device="cpu")
    g = torch.Generator().manual_seed(0)
    px = torch.randint(-4, 8, (4, 8), generator=g, dtype=torch.int32)
    pw = torch.randint(-4, 8, (8, 4), generator=g, dtype=torch.int32)
    ar = px @ pw
    ar[1, 2] ^= 1 << 30
    ar_neg = px @ -pw
    before = probe_check.launches
    state = eng.init_state()
    flags = []
    for _ in range(eng.cfg.steps_per_sweep):
        state, f, _ = eng.probe_block(state, px, pw, ar, ar_neg)
        flags.append(f)
    assert torch.equal(torch.cat(flags), probe_check_ref(px, pw, ar, window=8))
    assert int(state.hits.sum()) == 1 and int(state.hits[1, 2]) == 1
    assert probe_check.launches == before
    # the ABFT canary is ported: its constructors work on the CPU
    assert ModelBundle(ServerConfig(device="cpu", abft=True)).device.type == "cpu"
    # repair="retrain" is ported: a retrain server builds on the CPU
    assert FaultTolerantServer(ServerConfig(device="cpu", repair="retrain")).cfg.retrain_steps == 4
    mgr = FaultManager(ServerConfig(device="cpu").hyca(), FaultInjector(8, 8),
                       FaultManagerConfig(abft=True), device="cpu")
    assert mgr.cfg.abft and mgr.abft_check() is False and mgr.abft_alarms == 0


def test_every_entry_point_defaults_to_cuda():
    """The default device of each entry point that takes one is ``cuda``:
    only a caller who asks gets the plain versions on the CPU."""
    import inspect

    from repro_torch.core.detection import scan_array, scans_to_full_detection
    from repro_torch.core.scan import ScanConfig, ScanEngine, build_scan_engine
    from repro_torch.serving import FaultManager, ServerConfig
    from repro_torch.transient.coverage import build_program, run_class, run_coverage

    assert ServerConfig().device == "cuda"
    for entry in (FaultManager, build_scan_engine, scan_array, scans_to_full_detection,
                  run_coverage, run_class, build_program):
        assert inspect.signature(entry).parameters["device"].default == "cuda", entry
    assert ScanEngine(ScanConfig(rows=4, cols=4, window=8, block_rows=1, confirm_hits=2)).device == "cuda"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """``chip_smoke.py`` exits non-zero and prints no result when there is no
    card (here) — and so also in a directory holding nothing else."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", lone):
        out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                             cwd=script.parent, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
