"""The process around a run: where caches live, how long the process has
run, and which modules it must never hold."""
from __future__ import annotations

import os
import sys
import time

from hyca_bench.harness.spec import ROOT

# top-level module names a run may not load (compared whole: the port's
# ``repro_torch`` begins with the JAX package's ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

_T0 = time.perf_counter()


def prepare() -> None:
    """Fix every build and kernel cache inside the checkout, at fixed paths
    (the port's own ``csrc`` builds already go to ``build/repro_torch/``),
    keep libraries from loading JAX, and put the port's ``src/`` on the
    path.  Call before torch is imported."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def seconds_since_start() -> float:
    """Seconds since this process started (``/proc/self/stat``), so that
    ``setup_s`` includes the interpreter's start and every import; the time
    since this module was imported where ``/proc`` is missing."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is in :data:`FORBIDDEN`."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})
