"""The serving benchmarks' twins held against the reference: serving_goodput,
scan_latency, detector_coverage and ft_overhead in quick mode on the CPU,
the legacy per-PE boot scan, and the regress twin.

The committed ``experiments/bench/{serving_goodput,scan_latency,
detector_coverage}.json`` are quick-mode runs of the reference: the twins
must equal them on every field that is not a time or a ratio of times.
One exception: the committed serving_goodput file's unprotected curve is
older than the reference on this tree, which itself serves ``[48, 48, 42,
36, 30, 12]`` where the file says ``[48, 42, 36, 30, 24, 12]``; that curve
is held to a live run of the reference benchmark instead (the twin serves
torch's seeded init, the reference JAX's; on the CPU both give one curve).  ``ft_overhead.json`` is a full-mode run (48 steps,
8 repeats, 16 slots), so the twin's quick run is held to it on structure
and on its correctness claims."""
import importlib
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro.core.engine import HyCAConfig as JHyCA
from repro.core.redundancy import DPPUConfig as JDPPU
from repro.serving.fault_manager import FaultInjector as JInjector
from repro.serving.fault_manager import FaultManager as JManager
from repro.serving.fault_manager import FaultManagerConfig as JMConfig
from repro_torch.bench import detector_coverage, ft_overhead, regress, scan_latency, serving_goodput
from repro_torch.core.engine import HyCAConfig
from repro_torch.core.redundancy import DPPUConfig
from repro_torch.serving.fault_manager import FaultInjector, FaultManager, FaultManagerConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "experiments" / "bench"
# run bookkeeping and the device a run names
VOLATILE = {"elapsed_s", "backend", "device"}



@pytest.fixture(autouse=True)
def one_thread():
    """Smoke-size steps are many tiny tensor ops: one intra-op thread runs
    them fastest, and keeps this file from contending with the suite's
    other workers for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _committed(name: str) -> dict:
    return json.loads((BENCH / f"{name}.json").read_text())


def _claims(out: dict, skip=()) -> list:
    return [(c["claim"], c["ok"], c["detail"]) for c in out["claims"] if c["claim"] not in skip]


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    """One quick run of each twin on the CPU, saved as the bench runner
    saves them (the regress twin's baseline)."""
    out_dir = tmp_path_factory.mktemp("bench_torch")
    runs = {
        "serving_goodput": serving_goodput.run(True, device="cpu"),
        "scan_latency": scan_latency.run(True, device="cpu"),
        "detector_coverage": detector_coverage.run(True, device="cpu"),
        "ft_overhead": ft_overhead.run(True, device="cpu"),
    }
    for name, out in runs.items():
        (out_dir / f"{name}.json").write_text(json.dumps(out, default=float))
    return runs, out_dir


def test_serving_goodput_twin_equals_reference(twins):
    out = twins[0]["serving_goodput"]
    ref = _committed("serving_goodput")
    unprot = ("unprotected", "unprotected_per_step")
    assert out["all_ok"]
    assert {k: v for k, v in out.items() if k not in VOLATILE | {"curve"}} == \
        {k: v for k, v in ref.items() if k not in VOLATILE | {"curve"}}
    assert {k: v for k, v in out["curve"].items() if k not in unprot} == \
        {k: v for k, v in ref["curve"].items() if k not in unprot}
    if str(ROOT) not in sys.path:  # the repository root holds the reference's benchmarks package
        sys.path.insert(0, str(ROOT))
    live = importlib.import_module("benchmarks.serving_goodput").run(quick=True)
    assert out["curve"] == live["curve"] and _claims(out) == _claims(live)
    assert out["curve"]["unprotected"] == [48, 48, 42, 36, 30, 12]


SCAN_TIMES = ("boot_batched_ms", "boot_legacy_ms", "boot_speedup_x", "step_ms")


def test_scan_latency_twin_equals_committed(twins):
    out = twins[0]["scan_latency"]
    ref = _committed("scan_latency")
    speed = ref["claims"][-1]["claim"]  # its ok and detail are a ratio of times
    assert "not collapsed" in speed and out["claims"][-1]["claim"] == speed
    assert _claims(out, skip=(speed,)) == _claims(ref, skip=(speed,))
    assert all(ok for _, ok, _ in _claims(out, skip=(speed,)))
    assert [{k: v for k, v in r.items() if k not in SCAN_TIMES} for r in out["results"]] == \
        [{k: v for k, v in r.items() if k not in SCAN_TIMES} for r in ref["results"]]
    assert (out["reps"], out["n_faults"]) == (ref["reps"], ref["n_faults"])
    assert all(r[k] > 0 for r in out["results"] for k in SCAN_TIMES)


def test_detector_coverage_twin_equals_committed(twins):
    out = twins[0]["detector_coverage"]
    ref = _committed("detector_coverage")
    assert out["all_ok"]
    assert {k: v for k, v in out.items() if k not in VOLATILE} == {k: v for k, v in ref.items() if k not in VOLATILE}


def test_ft_overhead_twin_structure_and_claims(twins):
    out = twins[0]["ft_overhead"]
    ref = _committed("ft_overhead")
    assert out["all_ok"]
    for k in ("rows", "cols", "dppu", "n_faults"):
        assert out[k] == ref[k]
    assert (out["steps"], out["repeats"], out["n_slots"]) == (8, 3, 4)  # quick mode
    assert [r["arch"] for r in out["results"]] == [r["arch"] for r in ref["results"]] == ft_overhead.FAMILIES
    assert [set(r) for r in out["results"]] == [set(r) for r in ref["results"]]
    keys = [(r["arch"], r["site"]) for r in out["site_results"]]
    assert keys == [(r["arch"], r["site"]) for r in ref["site_results"]] and len(keys) == 10
    assert [set(r) for r in out["site_results"]] == [set(r) for r in ref["site_results"]]
    timing = ("no slower than twopass", "ROADMAP target")  # full mode only
    want = [c["claim"] for c in ref["claims"] if not any(t in c["claim"] for t in timing)]
    assert [c["claim"] for c in out["claims"]] == want
    assert all(r[f"{m}_ms_per_step"] > 0 for r in out["results"] for m in ("off", "twopass", "fused"))


# --------------------------------------------------------------------------- #
# the legacy per-PE boot scan
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("scan_block", [1, 2, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_boot_scan_legacy_matches_batched_and_reference(seed, scan_block):
    """``boot_scan(batched=False)`` confirms the batched scan's set, with the
    same hit counters, FPT and scan count, and the reference's legacy loop's
    (the seeds and faults of the reference's tests/test_scan.py)."""
    rng = np.random.default_rng(seed)
    coords = {(int(rng.integers(0, 8)), int(rng.integers(0, 8))) for _ in range(6)}

    def manager(inj_cls, mgr_cls, mcfg_cls, hyca, **kw):
        inj = inj_cls(8, 8, seed=seed)
        for r, c in coords:
            inj.inject_at(r, c)
        return mgr_cls(hyca, inj, mcfg_cls(confirm_hits=2, scan_block=scan_block), **kw)

    def port():
        hyca = HyCAConfig(rows=8, cols=8, dppu=DPPUConfig(size=8, group_size=8))
        return manager(FaultInjector, FaultManager, FaultManagerConfig, hyca, device="cpu")

    batched, legacy = port(), port()
    ref = manager(JInjector, JManager, JMConfig, JHyCA(rows=8, cols=8, dppu=JDPPU(size=8, group_size=8)))
    assert batched.boot_scan() == legacy.boot_scan(batched=False) == ref.boot_scan(batched=False) == len(coords)
    assert batched.confirmed_coords() == legacy.confirmed_coords() == ref.confirmed_coords() == frozenset(coords)
    np.testing.assert_array_equal(legacy.hits, batched.hits)
    np.testing.assert_array_equal(legacy.hits, np.asarray(ref.hits))
    np.testing.assert_array_equal(legacy.confirmed_state.fpt.numpy(), batched.confirmed_state.fpt.numpy())
    np.testing.assert_array_equal(legacy.confirmed_state.fpt.numpy(), np.asarray(ref.confirmed_state.fpt))
    assert legacy.scan_state.sweep == batched.scan_state.sweep == int(ref.scan_state.sweep)
    assert legacy.scans == ref.scans == 4 * 64
    assert legacy.counts() == batched.counts() == ref.counts()


# --------------------------------------------------------------------------- #
# the regress twin
# --------------------------------------------------------------------------- #
def test_regress_twin_self_diff_passes(twins):
    base = str(twins[1])
    out = regress.diff_benchmarks(base, base)
    assert out["ok"] and out["rows"]
    assert all(r["ratio"] == 1.0 for r in out["rows"])
    assert {r["bench"] for r in out["rows"]} == {"ft_overhead", "scan_latency", "detector_coverage"}
    assert regress.main(["--baseline", base]) == 0


def test_regress_twin_flags_synthetic_2x_regression(twins, tmp_path):
    base = twins[1]
    d = json.loads((base / "ft_overhead.json").read_text())
    for rec in d["results"]:
        rec["twopass_overhead_x"] *= 2.0
    (tmp_path / "ft_overhead.json").write_text(json.dumps(d))
    out = regress.diff_benchmarks(str(base), str(tmp_path))
    assert not out["ok"]
    bad = [r for r in out["rows"] if not r["ok"]]
    assert bad and all(r["metric"] == "twopass_overhead_x" for r in bad)
    assert all(r["ratio"] == pytest.approx(2.0) for r in bad)
    # scan_latency absent from the current run is a note, not a failure
    assert any("scan_latency" in n for n in out["notes"])
    # CLI contract: exit 1, and 0 under --warn-only
    assert regress.main(["--baseline", str(base), "--current", str(tmp_path)]) == 1
    assert regress.main(["--baseline", str(base), "--current", str(tmp_path), "--warn-only"]) == 0


def test_regress_twin_never_reads_the_reference_files(twins):
    """The reference's committed files are skipped, never compared: the
    port's times are not measured against them."""
    out = regress.diff_benchmarks(str(BENCH), str(twins[1]))
    assert not out["rows"]
    # the seven budgets of the three twins this run wrote
    assert sum("reference benchmark's file" in n for n in out["notes"]) == 7
