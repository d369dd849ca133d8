"""The port's fleet held against the JAX package's.

The traffic model, the chaos hooks, the elastic spare pools and the
straggler mitigator are host numpy in both packages: the same inputs give the
same outputs bit for bit.  ``run_fleet`` runs real servers (the smoke qwen
on the CPU here) whose scheduling is eos-free and whose fault truth comes
from each injector's numpy stream, so every key of the port's report equals
the reference's, wearout included.  ``run_vfleet`` draws nothing at random
at fault rate 0, so it equals the reference's on every key but the wall
time; with wearout its draws come from a torch generator, held
statistically.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.core import campaign as jcp
from repro.obs.events import EventLog as JEventLog
from repro.runtime import elastic as jel
from repro.runtime.straggler import StragglerMitigator as JStraggler
from repro.serving import fleet as jfleet
from repro.serving import traffic as jtr
from repro.serving import vfleet as jvf
from repro.serving.fault_manager import FaultInjector as JInjector
from repro_torch.core import campaign as tcp
from repro_torch.obs.events import EventLog
from repro_torch.obs.schema import validate_event, validate_jsonl
from repro_torch.runtime import elastic as tel
from repro_torch.runtime.straggler import StragglerMitigator
from repro_torch.serving import (
    AutoscaleSpec,
    ChaosSpec,
    FleetConfig,
    ServerConfig,
    TrafficSpec,
    request_classes,
    run_fleet,
    run_vfleet,
    sample_trace,
)
from repro_torch.serving import vfleet as tvf
from repro_torch.serving.fault_manager import FaultInjector
from repro_torch.serving.traffic import requests_at

# the reference's pinned parity configs (tests/test_vfleet.py), and the
# report keys both engines share
J_SERVER = jfleet.ServerConfig(n_slots=2, smax=32, mode="protected", scan_block=2,
                               rows=4, cols=4, dppu_size=2)
J_POOL = jfleet.FleetConfig(
    n_replicas=3, n_spares=2, spare_policy="pool", n_regions=1, steps=48,
    fault_rate=0.0, retire_fraction=0.25, seed=0,
    chaos=jcp.ChaosSpec(per=0.3, at_step=10, seed=3),
    traffic=jtr.TrafficSpec(request_rate=0.8, sla_steps=12, seed=5),
    server=J_SERVER,
)
J_REGION = jfleet.FleetConfig(
    n_replicas=4, n_spares=2, spare_policy="region", n_regions=2, steps=40,
    fault_rate=0.0, retire_fraction=0.25, seed=7,
    chaos=jcp.ChaosSpec(per=0.5, at_step=6, seed=11),
    traffic=jtr.TrafficSpec(request_rate=1.2, sla_steps=14, seed=9, n_classes=2, tail=0.6),
    server=J_SERVER,
)
# wearout on top of chaos: both servers draw it from the injector's numpy stream
J_WEAR = dataclasses.replace(J_POOL, fault_rate=0.05, steps=40, seed=2)
PARITY_KEYS = (
    "goodput_tokens", "requests_completed", "requests_expired",
    "requests_lost", "requests_unrouted", "retirements", "replacements",
    "spares_remaining", "chaos_injected", "alive_final",
    "slo_requests", "slo_met", "slo_misses",
)


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def port_cfg(cfg) -> FleetConfig:
    """The reference's FleetConfig as the port's, on the CPU."""
    d = _fields(cfg)
    d["server"] = ServerConfig(**{**_fields(cfg.server), "device": "cpu"})
    d["chaos"] = None if cfg.chaos is None else ChaosSpec(**_fields(cfg.chaos))
    d["traffic"] = None if cfg.traffic is None else TrafficSpec(**_fields(cfg.traffic))
    if cfg.autoscale is not None:
        d["autoscale"] = AutoscaleSpec(**_fields(cfg.autoscale))
    return FleetConfig(**d)


POOL = port_cfg(J_POOL)



@pytest.fixture(autouse=True)
def one_thread():
    """Tiny tensor ops, thousands of them: one intra-op thread runs them
    fastest, and keeps this file from contending with the suite's other
    workers for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# --------------------------------------------------------------------------- #
# traffic
# --------------------------------------------------------------------------- #
SPECS = [
    dict(request_rate=0.8, sla_steps=12, seed=5),
    dict(request_rate=1.2, sla_steps=14, seed=9, n_classes=2, tail=0.6),
    dict(request_rate=1.5, seed=42, n_classes=3, burst_rate=0.1, diurnal_amplitude=0.3,
         arch_mix=("qwen1.5-0.5b", "granite-8b"), tail=1.5, prompt_len=64, max_new_tokens=64),
]


@pytest.mark.parametrize("spec", SPECS, ids=["one-class", "two-class", "bursty"])
def test_traffic_bitwise(spec):
    j, t = jtr.TrafficSpec(**spec), TrafficSpec(**spec)
    assert [_fields(c) for c in request_classes(t, 32)] == [_fields(c) for c in jtr.request_classes(j, 32)]
    a, b = sample_trace(t, 128, 4, 32), jtr.sample_trace(j, 128, 4, 32)
    assert a.counts.dtype == b.counts.dtype and np.array_equal(a.counts, b.counts)
    ra, rb = np.random.default_rng([spec["seed"], 0x7E1]), np.random.default_rng([spec["seed"], 0x7E1])
    na = nb = 0
    for step in range(128):
        qa, na = requests_at(a, step, ra, 512, na)
        qb, nb = jtr.requests_at(b, step, rb, 512, nb)
        assert [(r.rid, r.prompt.tolist(), r.max_new_tokens, r.arrival_step, r.deadline_step) for r in qa] == \
               [(r.rid, r.prompt.tolist(), r.max_new_tokens, r.arrival_step, r.deadline_step) for r in qb]
    assert na == nb == a.total_requests


# --------------------------------------------------------------------------- #
# chaos hooks
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("model", ["random", "clustered"])
def test_chaos_maps_and_signatures_bitwise(model):
    t = ChaosSpec(per=0.2, fault_model=model, seed=4, replicas=(0, 2, 9))
    j = jcp.ChaosSpec(per=0.2, fault_model=model, seed=4, replicas=(0, 2, 9))
    assert t.targets(5) == j.targets(5) == (0, 2)
    assert np.array_equal(tcp.chaos_maps(t, 5, 8, 8), jcp.chaos_maps(j, 5, 8, 8))
    for a, b in zip(tcp.chaos_signatures(t, 5, 8, 8), jcp.chaos_signatures(j, 5, 8, 8)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("signatures", [False, True], ids=["injector-rng", "spec-signatures"])
def test_apply_chaos_into_injectors(signatures):
    spec = ChaosSpec(per=0.25, seed=6)
    maps = tcp.chaos_maps(spec, 2, 8, 8)
    bits, vals = tcp.chaos_signatures(spec, 2, 8, 8)
    ti, ji = FaultInjector(8, 8, seed=3), JInjector(8, 8, seed=3)
    for inj in (ti, ji):
        inj.inject_at(0, 0)
        inj.inject_n(3)
    kw = dict(bits=bits[0], vals=vals[0]) if signatures else {}
    n_t = tcp.apply_chaos(ti, maps[0], **kw)
    n_j = jcp.apply_chaos(ji, maps[0], **kw)
    assert n_t == n_j > 0
    ti.inject_map(maps[1])
    ji.inject_map(maps[1])
    for k in ("fault_map", "stuck_bit", "stuck_val"):
        assert np.array_equal(getattr(ti, k), getattr(ji, k)), k
    assert ti.version == ji.version and ti.n_faults == ji.n_faults
    assert ti.rng.integers(0, 1 << 30) == ji.rng.integers(0, 1 << 30)


# --------------------------------------------------------------------------- #
# elastic and straggler
# --------------------------------------------------------------------------- #
REMESH = [
    ((16, 16), ("data", "model"), [17], 256),
    ((2, 16, 16), ("pod", "data", "model"), [0, 300], 256),
    ((16, 16), ("data", "model"), [], 256),
    ((4, 8), ("data", "model"), [3, 9, 31], 64),
]


@pytest.mark.parametrize("case", REMESH, ids=["single-pod", "multi-pod", "no-failure", "three"])
def test_plan_remesh_equals_reference(case):
    assert dataclasses.asdict(tel.plan_remesh(*case)) == dataclasses.asdict(jel.plan_remesh(*case))


def test_plan_remesh_all_dead_raises():
    with pytest.raises(RuntimeError):
        tel.plan_remesh((2, 2), ("data", "model"), [0, 1, 2, 3], 8)


@pytest.mark.parametrize("policy", ["pool", "region"])
def test_spare_pools_equal_reference(policy):
    a = tel.spare_pool_ffp(np.random.default_rng(3), 1024, 0.01, n_spares=32, policy=policy, n_trials=300)
    b = jel.spare_pool_ffp(np.random.default_rng(3), 1024, 0.01, n_spares=32, policy=policy, n_trials=300)
    assert a == b
    assert np.array_equal(tel.initial_spares(7, policy, 3), jel.initial_spares(7, policy, 3))
    pa, pb = tel.SparePool(5, policy=policy, n_regions=2), jel.SparePool(5, policy=policy, n_regions=2)
    for region in (0, 1, 1, 0, 1, 0, 1):
        assert pa.try_allocate(region) == pb.try_allocate(region)
        assert pa.remaining == pb.remaining


def test_straggler_mitigator_equals_reference():
    rng = np.random.default_rng(0)
    a, b = StragglerMitigator(8, 37), JStraggler(8, 37)
    speed = np.ones(8)
    speed[[2, 5]] = 2.5
    for _ in range(6):
        times = a.assignment * speed * (1 + 0.05 * rng.random(8))
        a.observe(times)
        b.observe(times)
        assert np.array_equal(a.stragglers(), b.stragglers())
        assert np.array_equal(a.rebalance(), b.rebalance())
        assert a.expected_step_time() == b.expected_step_time()
    assert set(a.stragglers()) <= {2, 5}


# --------------------------------------------------------------------------- #
# run_fleet: port against reference, every key
# --------------------------------------------------------------------------- #
J_CFGS = {"pool": J_POOL, "region": J_REGION, "wearout": J_WEAR}


@functools.lru_cache(maxsize=None)
def port_legacy(name: str) -> dict:
    """The port's run_fleet of a pinned config, with every step record (run
    once, read by the tests below)."""
    return run_fleet(dataclasses.replace(port_cfg(J_CFGS[name]), record_steps=True))


@pytest.mark.parametrize("name", ["pool", "region", "wearout"])
def test_run_fleet_equals_reference(name):
    want = jfleet.run_fleet(dataclasses.replace(J_CFGS[name], record_steps=True))
    got = port_legacy(name)
    assert set(got) == set(want)
    diffs = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not diffs, diffs
    assert got["retirements"] > 0 and sum(len(r) for r in got["step_records"]) > 0
    if J_CFGS[name].fault_rate > 0:
        assert sum(r["true_faults"] for r in got["replica_summaries"]) > 0


def test_run_fleet_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = dataclasses.replace(POOL, server=dataclasses.replace(POOL.server, device="cuda"))
    for fn in (run_fleet, run_vfleet):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(cfg)


# --------------------------------------------------------------------------- #
# run_vfleet: port against reference at fault rate 0
# --------------------------------------------------------------------------- #
def _j_wait_hist(cfg) -> np.ndarray:
    """The reference's admission-wait histogram of a run (its driver loop,
    which keeps the histogram in the scan's state only)."""
    import jax.numpy as jnp

    geom, params, state, _ = jvf._build(cfg)
    step = 0
    while step < cfg.steps:
        n = min(max(1, cfg.chunk_steps), cfg.steps - step)
        state, _ = jvf._chunk(geom, state, params, jnp.arange(step, step + n, dtype=jnp.int32))
        step += n
    return np.asarray(state["counters"]["wait_hist"])


@pytest.mark.parametrize("jcfg", [J_POOL, J_REGION], ids=["pool", "region"])
def test_run_vfleet_equals_reference(jcfg):
    want = jvf.run_vfleet(jcfg)
    got = run_vfleet(port_cfg(jcfg))
    assert set(got) == set(want)
    diffs = {k: (got[k], want[k]) for k in want if k != "sim_wall_s" and got[k] != want[k]}
    assert not diffs, diffs
    assert got["retirements"] > 0 and got["latency_e2e_p99"] is not None
    prog = next(p for k, p in tvf._PROGRAMS.items() if k[1] == jcfg.steps and k[0].policy == jcfg.spare_policy)
    assert np.array_equal(prog.wait_hist.numpy(), _j_wait_hist(jcfg))


@pytest.mark.parametrize("name", ["pool", "region"])
def test_vfleet_matches_port_legacy(name):
    legacy = port_legacy(name)
    vec = run_vfleet(port_cfg(J_CFGS[name]))
    diffs = {k: (legacy[k], vec[k]) for k in PARITY_KEYS if legacy[k] != vec[k]}
    assert not diffs, diffs
    assert legacy["alive_mean"] == vec["alive_mean"]


_CHANNEL_TO_RECORD = {
    "tokens": "tokens_generated",
    "queue_depth": "queue_depth",
    "active": "active_slots",
    "confirmed": "confirmed_faults",
    "effective_slots": "effective_slots",
    "true_faults": "true_faults",
    "surviving_cols": "surviving_cols",
}


def test_vfleet_series_matches_legacy_step_records():
    legacy = port_legacy("pool")
    vec = run_vfleet(dataclasses.replace(POOL, series=True, chunk_steps=20))
    series = vec["series"]
    assert series["tokens"].shape == (POOL.steps, POOL.n_replicas)
    mismatches = []
    for i, records in enumerate(legacy["step_records"]):
        for rec in records:
            for ch, field in _CHANNEL_TO_RECORD.items():
                got, want = int(series[ch][rec["step"], i]), int(rec[field])
                if got != want:
                    mismatches.append((i, rec["step"], ch, got, want))
    n = sum(len(r) for r in legacy["step_records"]) * len(_CHANNEL_TO_RECORD)
    assert n > 0 and not mismatches, f"{len(mismatches)}/{n}: {mismatches[:8]}"


def test_vfleet_series_bitexact_and_no_rebuild():
    off = run_vfleet(POOL)
    on = run_vfleet(dataclasses.replace(POOL, series=True))
    assert {k: off[k] for k in off if k != "sim_wall_s"} == {k: on[k] for k in off if k != "sim_wall_s"}
    assert int(on["series"]["tokens"].sum()) == on["goodput_tokens"]
    n0 = len(tvf._TRACES)
    for i, rate in enumerate((0.01, 0.05)):
        run_vfleet(dataclasses.replace(POOL, series=True, fault_rate=rate, seed=i))
    run_vfleet(dataclasses.replace(POOL, series=True, chaos=dataclasses.replace(POOL.chaos, per=0.6, at_step=4)))
    assert len(tvf._TRACES) == n0, "a rate or chaos sweep rebuilt the program"


def test_one_build_across_fault_rates():
    run_vfleet(dataclasses.replace(POOL, fault_rate=0.01))
    n0 = len(tvf._TRACES)
    reports = [run_vfleet(dataclasses.replace(POOL, fault_rate=r, seed=i)) for i, r in enumerate((0.0, 0.05, 0.2))]
    assert len(tvf._TRACES) == n0
    assert reports[0]["goodput_tokens"] == run_vfleet(POOL)["goodput_tokens"]


def test_autoscale_emits_schema_valid_events(tmp_path):
    log = EventLog()
    cfg = dataclasses.replace(
        POOL, n_replicas=2, n_spares=0, steps=96, chunk_steps=8, chaos=None,
        traffic=TrafficSpec(request_rate=4.0, sla_steps=64, seed=1),
        autoscale=AutoscaleSpec(min_replicas=1, max_replicas=6, high_queue=2.0, low_queue=0.0),
    )
    report = run_vfleet(cfg, log=log)
    scale = log.of_kind("fleet.autoscale")
    assert any(e.data["action"] == "scale_out" for e in scale)
    for e in scale:
        validate_event(e.to_json())
    path = tmp_path / "autoscale.jsonl"
    log.to_jsonl(str(path))
    assert validate_jsonl(str(path)) == len(log.events)
    assert report["alive_final"] > 2
    jlog = JEventLog()
    jcfg = dataclasses.replace(
        J_POOL, n_replicas=2, n_spares=0, steps=96, chunk_steps=8, chaos=None,
        traffic=jtr.TrafficSpec(request_rate=4.0, sla_steps=64, seed=1),
        autoscale=jvf.AutoscaleSpec(min_replicas=1, max_replicas=6, high_queue=2.0, low_queue=0.0),
    )
    want = jvf.run_vfleet(jcfg, log=jlog)
    assert [(e.step, e.data) for e in scale] == [(e.step, e.data) for e in jlog.of_kind("fleet.autoscale")]
    assert {k: report[k] for k in PARITY_KEYS} == {k: want[k] for k in PARITY_KEYS}


def test_batched_confirmed_states_matches_single_merge():
    from repro_torch.core.engine import empty_fault_state

    rng = np.random.default_rng(0)
    hits = rng.integers(0, 3, size=(3, 4, 4)).astype(np.int32)
    sbit = rng.integers(0, 32, size=(3, 4, 4)).astype(np.int32)
    sval = rng.integers(0, 2, size=(3, 4, 4)).astype(np.int32)
    batched = tvf.batched_confirmed_states(torch.from_numpy(hits), sbit, sval, confirm_hits=2)
    want = jvf.batched_confirmed_states(hits, sbit, sval, confirm_hits=2)
    for i in range(3):
        one = empty_fault_state(16).merge(torch.from_numpy(hits[i] >= 2), stuck_bit=torch.from_numpy(sbit[i]),
                                          stuck_val=torch.from_numpy(sval[i]))
        for k in ("fpt", "stuck_bit", "stuck_val"):
            assert torch.equal(getattr(batched, k)[i], getattr(one, k))
            assert np.array_equal(getattr(batched, k)[i].numpy(), np.asarray(getattr(want, k))[i])


# --------------------------------------------------------------------------- #
# wearout: held statistically
# --------------------------------------------------------------------------- #
def test_wearout_count_within_poisson_band():
    # no chaos, nothing retires (retire only at 0 surviving columns of 8,
    # and the rate keeps the arrays far from it), so the final true faults
    # of every replica sum every wearout draw
    rate, n, steps = 0.01, 32, 400
    cfg = FleetConfig(
        n_replicas=n, n_spares=4, steps=steps, fault_rate=rate, retire_fraction=0.0, seed=3,
        chunk_steps=100, series=True, traffic=TrafficSpec(request_rate=0.3, sla_steps=64, seed=2),
        server=ServerConfig(n_slots=4, smax=64, mode="protected", scan_block=2, rows=8, cols=8,
                            dppu_size=4, device="cpu"),
    )
    rep = run_vfleet(cfg)
    assert rep["retirements"] == 0 and rep["alive_final"] == n
    total = int(rep["series"]["true_faults"][-1].sum())
    mu = rate * n * steps
    assert abs(total - mu) <= 2.576 * np.sqrt(mu) + 1, (total, mu)
    # another seed draws other faults
    other = run_vfleet(dataclasses.replace(cfg, seed=4))
    assert not np.array_equal(other["series"]["true_faults"], rep["series"]["true_faults"])


def test_fleet_goodput_twin_claims():
    from repro_torch.bench import fleet_goodput

    out = fleet_goodput.run(quick=True, device="cpu")
    assert out["all_ok"], [c for c in out["claims"] if not c["ok"]]
    base = next(r for r in out["results"] if r["fleet"] == "baseline")
    assert (base["goodput_tokens"], base["requests_completed"], base["latency_e2e_p50"],
            base["latency_e2e_p99"]) == (98047, 11556, 14.0, 24.0)


# --------------------------------------------------------------------------- #
# an idle slot past its KV capacity (found by the fleet: a replica's free
# slot keeps decoding, and its cache index passes smax)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "minicpm3-4b"])
def test_decode_past_kv_capacity_matches_jax(arch):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as j_smoke
    from repro.models import lm as JL
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm as TL

    jcfg = dataclasses.replace(j_smoke(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    jparams = JL.init_params(jax.random.key(0), jcfg)
    tparams = TL.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    smax = 4
    jcache, tcache = JL.init_cache(jcfg, 2, smax), TL.init_cache(tcfg, 2, smax, device="cpu")
    jstep = jax.jit(JL.decode_step, static_argnums=(1,))
    rng = np.random.default_rng(3)
    for _ in range(smax + 3):   # the last three writes fall past the cache
        tok = rng.integers(0, tcfg.vocab, (2, 1)).astype(np.int32)
        jl, jcache = jstep(jparams, jcfg, jcache, {"token": jnp.asarray(tok)})
        tl, tcache = TL.decode_step(tparams, tcfg, tcache, {"token": torch.from_numpy(tok)})
        np.testing.assert_allclose(tl.numpy()[..., :tcfg.vocab], np.asarray(jl)[..., :tcfg.vocab], rtol=0, atol=2e-5)
    for i, layer in enumerate(tcache["attn"]):
        assert int(layer["idx"][0]) == smax + 3
        for name, t in layer.items():
            want = np.asarray(jcache["attn"][name][i].astype(jnp.float32))
            np.testing.assert_allclose(t.float().numpy(), want, rtol=0, atol=2e-5)
