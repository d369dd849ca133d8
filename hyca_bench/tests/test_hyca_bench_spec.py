"""BENCHMARK.json against its contract, and every name in it resolving to
its files."""
import json
import re

import pytest

from hyca_bench.harness import spec as spec_mod
from hyca_bench.harness.spec import BENCH_DIR, ROOT, Spec

DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in DOC["workloads"]]


def test_top_level_keys_and_command():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert DOC["command"] == ["python3", "hyca_bench/run.py"] and DOC["paths"] == ["hyca_bench"]
    assert 1 <= DOC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    n = len(DOC["workloads"])
    assert (2 + 14 * 24) * (DOC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert sum(w["chips"] == 4 for w in DOC["workloads"]) <= max(1, n // 4)


def test_names_units_and_keys():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in DOC[k]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in DOC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    for m in DOC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in DOC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in DOC["end_to_end"]}
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in DOC["end_to_end"])


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_to_its_files(workload):
    s = Spec()
    w = s.cell(workload)
    cfg = s.config(w["config"])
    mix = s.traffic(w["traffic"])
    kind = spec_mod.module("drivers", mix["kind"])
    assert callable(kind.Driver) and callable(kind.compare) and callable(kind.tally)
    if "arrival" in mix:
        assert callable(spec_mod.module("arrivals", mix["arrival"]["process"]).Arrivals)
    limits = s.limits(workload)
    known = {"served_gap", "served_gap_mean"} if mix["kind"] == "chat" else {"rms_err_mean"}
    assert "unrepaired_faults" in limits and len(set(limits) & known) == 1 and set(limits) <= known | {"unrepaired_faults"}
    for folder in ("bridges", "counts", "reference"):
        assert (BENCH_DIR / folder / f"{cfg['family']}.py").exists()
    e2e = [m["name"] for m in s.end_to_end(workload)]
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in s.per_layer(workload):
        assert m["moves"] in e2e
    assert s.per_layer(workload)


@pytest.mark.parametrize("metric", [m["name"] for m in DOC["end_to_end"] + DOC["per_layer"]])
def test_metric_has_a_reader(metric):
    assert spec_mod.reader_path(metric).exists()
    assert callable(spec_mod.reader(metric))


@pytest.mark.parametrize("entry", DOC["configs"], ids=lambda c: c["name"])
def test_config_file_is_what_the_port_runs(entry):
    """The file's sizes give the port's registry configuration exactly, at
    full width and depth."""
    from repro_torch.configs import get_config

    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"]
    assert spec_mod.module("bridges", cfg["family"]).lm_config(cfg) == get_config(cfg["arch"])
