"""No module the benchmark loads is JAX or the JAX package (whole
top-level names: the port's ``repro_torch`` begins with ``repro``), and the
reference loads nothing of the port."""
import ast
import subprocess
import sys

import pytest

from hyca_bench.harness import env
from hyca_bench.harness.spec import BENCH_DIR, ROOT


def imported_tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH_DIR.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not set(imported_tops(path)) & set(env.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_torch_only(path):
    assert set(imported_tops(path)) <= {"__future__", "math", "typing", "torch"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake_for_test", object())
    assert "repro_torch_fake_for_test" not in env.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake_for_test", object())
    assert "repro.fake_for_test" in env.forbidden_modules()


def test_a_run_loads_no_forbidden_module():
    """The harness, the port and the reference in a fresh process, through
    a smoke run: sys.modules holds none of the forbidden names after it."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from hyca_bench import run\n"
            "from hyca_bench.tests import smoke\n"
            "smoke.run('deepseek.chat', seconds=0.5)\n"
            "from hyca_bench.harness import env\n"
            "print(env.forbidden_modules())\n") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env=dict(__import__("os").environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
