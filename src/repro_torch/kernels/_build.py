"""Build and load the port's CUDA kernels.

Each ``src/repro_torch/csrc/<name>.cu`` is compiled on first use by ``nvcc``
into its own shared library with a plain C interface
(``build/repro_torch/<name>-<hash>.so`` at the repository root) and loaded with
``ctypes``.  A name may hold a folder (``obs/span_mark``: the device marks of
:mod:`repro_torch.obs.spans`); :func:`sources` and :func:`build_all` take the
kernels of ``csrc/`` itself.  The file name carries a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so a library is rebuilt only
when one of them changes.  :func:`build_all` starts one ``nvcc`` per source at once and waits
for all of them.  ``nvcc`` runs with ``-Xptxas -v``; its report is kept
beside each library (``<name>-<hash>.log``) and :func:`ptxas_usage` reads
each kernel's registers, shared memory and spill bytes from it.

Nothing here runs at import time: the CPU tests import every module, and this
host has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME  # deferred: probes the toolkit

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    # the shared headers (csrc/*.cuh) count as part of every source
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def log_path(name: str) -> Path:
    return library_path(name).with_suffix(".log")


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = library_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    # build to a private name, then rename: a concurrent loader never sees a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    log_path(name).write_text(log)
    os.replace(tmp, out)


def build_all() -> dict[str, Path]:
    """Compile every kernel source whose library is missing, one ``nvcc`` per
    source, all started together.  Returns {name: library path}."""
    names = sources()
    jobs = {n: _start(n) for n in names}
    try:
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)
    finally:
        for job in jobs.values():
            if job is not None and job[0].poll() is None:
                job[0].kill()
                job[0].wait()
    return {n: library_path(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def _demangle(symbol: str) -> str:
    cxxfilt = shutil.which("c++filt")
    if cxxfilt is None:
        return symbol
    return subprocess.run([cxxfilt, symbol], capture_output=True, text=True).stdout.strip() or symbol


def ptxas_usage(name: str) -> list[dict]:
    """Each kernel of ``csrc/<name>.cu`` as ``nvcc -Xptxas -v`` reported it
    when the library was built: registers a thread, static shared memory
    bytes and spill store / load bytes."""
    kernels = []
    for line in log_path(name).read_text().splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            kernels.append({"kernel": _demangle(entry.group(1)), "registers": None, "smem_bytes": 0,
                            "spill_stores": None, "spill_loads": None})
        elif kernels and (spill := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            kernels[-1]["spill_stores"], kernels[-1]["spill_loads"] = int(spill[1]), int(spill[2])
        elif kernels and (regs := re.search(r"Used (\d+) registers", line)):
            kernels[-1]["registers"] = int(regs[1])
            smem = re.search(r"(\d+) bytes smem", line)
            kernels[-1]["smem_bytes"] = int(smem[1]) if smem else 0
    return kernels
