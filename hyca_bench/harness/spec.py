"""``BENCHMARK.json`` and the files it names, each found by its name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's ``file`` is given in ``BENCHMARK.json``; the mix is
``traffic/<traffic>.json``, the cell's limits ``limits/<cell>.json``, and a
per-layer metric's reader ``metrics/<metric>.py`` or, failing that,
``metrics/<metric up to its first dot>.py``.  The code a name selects is a
module of its own, found by :func:`module`: the mix's ``kind`` a driver
(``drivers/<kind>.py``), a served mix's ``arrival.process`` an arrival
process (``arrivals/<process>.py``), the configuration's ``family`` its
bridge to the port, counts and reference (``bridges/``, ``counts/``,
``reference/<family>.py``).  Adding a cell, a mix, a metric, a family, a
kind or an arrival process is adding files; no existing file changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]   # hyca_bench/
ROOT = BENCH_DIR.parent                            # the checkout: BENCHMARK.json, src/


class Spec:
    """``bench_file``: a ``BENCHMARK.json``; its configurations' ``file``
    paths are relative to its directory.  ``data_dir`` holds ``traffic/``
    and ``limits/`` (the benchmark's own, unless a test brings its own)."""

    def __init__(self, bench_file: Path = ROOT / "BENCHMARK.json", data_dir: Path = BENCH_DIR):
        self.bench_file = Path(bench_file)
        self.doc = json.loads(self.bench_file.read_text())
        self.data_dir = Path(data_dir)

    @staticmethod
    def _named(entries: list[dict], name: str, what: str) -> dict:
        for e in entries:
            if e["name"] == name:
                return e
        raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")

    def cell(self, workload: str) -> dict:
        return self._named(self.doc["workloads"], workload, "workload")

    def config(self, name: str) -> dict:
        entry = self._named(self.doc["configs"], name, "config")
        cfg = json.loads((self.bench_file.parent / entry["file"]).read_text())
        if cfg["name"] != name:
            raise ValueError(f"{entry['file']} holds config {cfg['name']!r}, BENCHMARK.json names {name!r}")
        return cfg

    def traffic(self, name: str) -> dict:
        return json.loads((self.data_dir / "traffic" / f"{name}.json").read_text())

    def limits(self, workload: str) -> dict:
        return json.loads((self.data_dir / "limits" / f"{workload}.json").read_text())

    def _metrics(self, key: str, workload: str) -> list[dict]:
        return [m for m in self.doc[key] if workload in m.get("workloads", [workload])]

    def end_to_end(self, workload: str) -> list[dict]:
        return self._metrics("end_to_end", workload)

    def per_layer(self, workload: str) -> list[dict]:
        return self._metrics("per_layer", workload)


def module(folder: str, name: str):
    """``hyca_bench/<folder>/<name>.py`` (``drivers``, ``arrivals``,
    ``bridges``, ``counts``, ``reference``), imported by its name."""
    if not (BENCH_DIR / folder / f"{name}.py").exists():
        raise KeyError(f"no module hyca_bench/{folder}/{name}.py")
    return importlib.import_module(f"hyca_bench.{folder}.{name}")


def reader_path(metric: str) -> Path:
    """The reader of a per-layer metric: ``metrics/<metric>.py``, else the
    file of its stem (``mfu.serve`` -> ``metrics/mfu.py``)."""
    own = BENCH_DIR / "metrics" / f"{metric}.py"
    return own if own.exists() else BENCH_DIR / "metrics" / f"{metric.split('.')[0]}.py"


def reader(metric: str):
    """The ``read(rec, metric)`` function of ``metric``'s reader."""
    path = reader_path(metric)
    mod_name = "hyca_bench_metric_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
