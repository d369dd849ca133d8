"""The port's launch tier held against the reference's: the step builders
``make_prefill`` / ``make_decode`` and the serving CLI ``main(argv)``.

The step builders run on the JAX side on a host mesh (Auto axes) and on the port's side
on the CPU, with the same params (the JAX ones through numpy) in f32 and the
same fault tables, beyond DPPU capacity so corrupted elements flow through
the whole stack; the tolerance is ``tests/test_torch_models.py``'s for
``decode_step`` in f32.  Within capacity, a protected step equals the
fault-free table through the same context bit for bit in both packages.

The CLI serves its own random weights in each package (JAX's init against
torch's), so tokens differ; every summary key that does not read a clock
counts steps, requests, scans and detections, and must be equal."""
import dataclasses
import json
import urllib.request

import jax
import jax.numpy as jnp
from jax.sharding import AxisType
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.core import engine as JE
from repro.core.ftcontext import build_ftcontext as j_build
from repro.core.redundancy import DPPUConfig as JDPPU
from repro.launch import serve as JS
from repro.models import lm as JL
from repro_torch.configs import get_smoke_config
from repro_torch.core import engine as TE
from repro_torch.core.ftcontext import build_ftcontext
from repro_torch.core.redundancy import DPPUConfig as TDPPU
from repro_torch.launch import hw
from repro_torch.launch import serve as TS
from repro_torch.models import lm as TL

ARCH = "qwen1.5-0.5b"
TOL, MEAN_TOL = 2e-5, 2e-6  # f32, as test_torch_models.py holds decode_step
B, S, STEPS = 4, 8, 4
# capacity 1 on the 4 x 4 array: PE(0, 1) is repaired, the other two corrupt
OVER = [(0, 1, 22, 1), (1, 2, 30, 0), (2, 3, 25, 1)]
# capacity 4 on the 8 x 8 array: all three repaired
WITHIN = [(0, 1, 30, 1), (2, 3, 31, 0), (3, 6, 20, 1)]



@pytest.fixture(autouse=True)
def one_thread():
    """Smoke-size steps are many tiny tensor ops: one intra-op thread runs
    them fastest, and keeps this file from contending with the suite's
    other workers for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _states(faults, n):
    fm = np.zeros((n, n), bool)
    for r, c, _, _ in faults:
        fm[r, c] = True
    js = JE.fault_state_from_map(fm, max_faults=n * n)
    bits = np.zeros(n * n, np.int32)
    vals = np.zeros(n * n, np.int32)
    for i, (r, c) in enumerate(np.asarray(js.fpt)[:len(faults)]):
        _, _, bits[i], vals[i] = next(f for f in faults if f[:2] == (r, c))
    js = JE.FaultState(js.fpt, jnp.asarray(bits), jnp.asarray(vals))
    ts = TE.FaultState(torch.from_numpy(np.array(js.fpt)), torch.from_numpy(bits), torch.from_numpy(vals))
    return js, ts


def _contexts(dispatch, faults=OVER, n=4, dppu=1):
    """(JAX context, port context) of ``dispatch`` over ``faults`` on the
    n x n array; None for off."""
    if dispatch == "off":
        return None, None
    js, ts = _states(faults, n)
    jc = JE.HyCAConfig(n, n, JDPPU(size=dppu, group_size=dppu), "protected")
    tc = TE.HyCAConfig(n, n, TDPPU(size=dppu, group_size=dppu), "protected")
    return j_build(js, jc, dispatch=dispatch), build_ftcontext(ts, tc, dispatch=dispatch)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(j_smoke(ARCH), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype=torch.float32)
    jparams = JL.init_params(jax.random.key(0), jcfg)
    tparams = TL.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    # the reference's make_host_mesh() gives Explicit axes, under which its
    # decode's cache scatter raises ShardingTypeError (ROADMAP C8, the root
    # of C2); the same local devices with Auto axes lower both builders
    n = len(jax.devices())
    mesh = jax.make_mesh((n, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    return jcfg, tcfg, jparams, tparams, mesh


def _close(t, j):
    a = np.asarray(j.astype(jnp.float32))
    b = t.float().numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=TOL)
    assert np.abs(b - a).mean() <= MEAN_TOL


@pytest.mark.parametrize("dispatch", ["off", "twopass", "fused"])
def test_make_prefill_matches_jax(models, dispatch):
    jcfg, tcfg, jparams, tparams, mesh = models
    jftc, tftc = _contexts(dispatch)
    tokens = np.random.default_rng(0).integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(tokens)}
    jfn, _ = JS.make_prefill(jcfg, mesh, jparams, jbatch, ftc=jftc)
    tfn, specs = TS.make_prefill(tcfg, "cpu", ftc=tftc)
    assert specs is None
    jl, tl = jfn(jparams, jbatch), tfn(tparams, {"tokens": torch.from_numpy(tokens)})
    assert tl.shape == (B, 1, tcfg.padded_vocab) == tuple(jl.shape)
    _close(tl[..., :tcfg.vocab], jl[..., :jcfg.vocab])


@pytest.mark.parametrize("dispatch", ["off", "twopass", "fused"])
def test_make_decode_matches_jax(models, dispatch):
    jcfg, tcfg, jparams, tparams, mesh = models
    jftc, tftc = _contexts(dispatch)
    jcache = JL.init_cache(jcfg, B, 16)
    tcache = TL.init_cache(tcfg, B, 16, device="cpu")
    jfn, _ = JS.make_decode(jcfg, mesh, jparams, jcache, ftc=jftc)
    tfn, specs = TS.make_decode(tcfg, "cpu", batch=B, ftc=tftc)
    assert specs is None
    rng = np.random.default_rng(1)
    for _ in range(STEPS):
        tok = rng.integers(0, tcfg.vocab, (B, 1)).astype(np.int32)
        jl, jcache = jfn(jparams, jcache, {"token": jnp.asarray(tok)})
        tl, out = tfn(tparams, tcache, {"token": torch.from_numpy(tok)})
        assert out is tcache  # the cache is advanced in place
        _close(tl[..., :tcfg.vocab], jl[..., :jcfg.vocab])
    for i in range(tcfg.n_layers):
        for name in ("k", "v"):
            _close(tcache["attn"][i][name], jcache["attn"][name][i])
        assert np.array_equal(tcache["attn"][i]["idx"].numpy(), np.asarray(jcache["attn"]["idx"][i]))


@pytest.mark.parametrize("dispatch", ["twopass", "fused"])
def test_protected_within_capacity_equals_off(models, dispatch):
    """Both packages: the protected step (three faults the DPPU of 4
    repairs, 8 x 8 array) gives the bits of the same context over a
    fault-free table."""
    jcfg, tcfg, jparams, tparams, mesh = models
    jftc, tftc = _contexts(dispatch, WITHIN, n=8, dppu=4)
    js0, ts0 = JE.empty_fault_state(64), TE.empty_fault_state(64, device="cpu")
    tok = np.random.default_rng(2).integers(0, tcfg.vocab, (B, 1)).astype(np.int32)
    tokens = np.random.default_rng(3).integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    jout, tout = {}, {}
    for name, jc, tc in (("protected", jftc, tftc), ("off", jftc.with_state(js0), tftc.with_state(ts0))):
        jdec, _ = JS.make_decode(jcfg, mesh, jparams, JL.init_cache(jcfg, B, 16), ftc=jc)
        jpre, _ = JS.make_prefill(jcfg, mesh, jparams, {"tokens": jnp.asarray(tokens)}, ftc=jc)
        tdec, _ = TS.make_decode(tcfg, "cpu", ftc=tc)
        tpre, _ = TS.make_prefill(tcfg, "cpu", ftc=tc)
        jout[name] = (np.asarray(jdec(jparams, JL.init_cache(jcfg, B, 16), {"token": jnp.asarray(tok)})[0]),
                      np.asarray(jpre(jparams, {"tokens": jnp.asarray(tokens)})))
        tout[name] = (tdec(tparams, TL.init_cache(tcfg, B, 16, device="cpu"), {"token": torch.from_numpy(tok)})[0],
                      tpre(tparams, {"tokens": torch.from_numpy(tokens)}))
    for a, b in zip(jout["protected"], jout["off"]):
        assert np.array_equal(a.view(np.int32), b.view(np.int32))
    for a, b in zip(tout["protected"], tout["off"]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_make_decode_holds_one_cache_and_swaps(models):
    """A call with another cache builds the step over it; a fault table
    swapped into the context in place is served by the same step."""
    _, tcfg, _, tparams, _ = models
    _, tftc = _contexts("fused", WITHIN, n=8, dppu=4)
    fn, _ = TS.make_decode(tcfg, "cpu", batch=B, ftc=tftc)
    tok = {"token": torch.tensor([[1], [2], [3], [4]], dtype=torch.int32)}
    first, _ = fn(tparams, TL.init_cache(tcfg, B, 16, device="cpu"), tok)
    c2 = TL.init_cache(tcfg, B, 16, device="cpu")
    again, out = fn(tparams, c2, tok)
    assert out is c2 and torch.equal(first, again)
    assert c2["attn"][0]["idx"].tolist() == [1] * B
    # 8 faults on PE rows 0-3 in columns 0 and 1: the DPPU repairs column 0's
    _, bad = _states([(r, c, 30, 1) for c in range(2) for r in range(4)], 8)
    tftc.swap(state=bad)
    corrupted, _ = fn(tparams, TL.init_cache(tcfg, B, 16, device="cpu"), tok)
    assert not torch.equal(first, corrupted)
    with pytest.raises(ValueError, match="batch of 4"):
        fn(tparams, TL.init_cache(tcfg, 2, 16, device="cpu"), {"token": tok["token"][:2]})


# --------------------------------------------------------------------------- #
# the serving CLI
# --------------------------------------------------------------------------- #
BASE = ["--requests", "6", "--gen", "6", "--prompt-len", "4"]
CLI = {
    "off": ["--mode", "off"],
    "protected": ["--mode", "protected", "--faults", "3"],
    "unprotected": ["--mode", "unprotected", "--faults", "3"],
    "remap": ["--mode", "protected", "--faults", "8", "--repair", "remap"],
    "chaos": ["--chaos-per", "0.2", "--chaos-at", "4"],
    "counters": ["--mode", "protected", "--faults", "3", "--counters", "--dispatch", "fused"],
    "faults64": ["--mode", "protected", "--faults", "64"],
}
WALL = {"wall_s", "tokens_per_s", "host_phase_ms"}


def _untimed(summary: dict) -> dict:
    return {k: v for k, v in summary.items() if k not in WALL}


@pytest.mark.parametrize("name", list(CLI))
def test_cli_matches_jax(name):
    js = JS.main(BASE + CLI[name])
    ts = TS.main(BASE + CLI[name] + ["--device", "cpu"])
    assert _untimed(ts) == _untimed(js)
    assert ts["steps"] > 0
    if name == "faults64":
        assert ts["effective_slots_final"] == 0
    if name == "counters":
        assert ts["counters"]["protected_calls"] > 0


def test_cli_files_match_jax(tmp_path):
    """--metrics-out, --series-out and --spans-out of one chaos run with
    counters: the same events (but their wall-clock stamps), the same
    Prometheus text (but the clock's gauges), the same spans, the same
    series."""
    args = BASE + CLI["chaos"] + ["--mode", "protected", "--faults", "3", "--counters"]
    for pkg, main, extra in (("j", JS.main, []), ("t", TS.main, ["--device", "cpu"])):
        d = tmp_path / pkg
        main(args + extra + ["--metrics-out", str(d / "ev.jsonl"), "--series-out", str(d / "series"),
                             "--spans-out", str(d / "spans.jsonl")])
    j, t = tmp_path / "j", tmp_path / "t"

    def events(p):
        return [{k: v for k, v in json.loads(line).items() if k != "ts"} for line in p.read_text().splitlines()]

    def prom(p):
        return [line for line in p.read_text().splitlines() if not any(w in line for w in WALL)]

    assert events(t / "ev.jsonl") == events(j / "ev.jsonl") and len(events(t / "ev.jsonl")) > 20
    assert prom(t / "ev.jsonl.prom") == prom(j / "ev.jsonl.prom")
    assert (t / "spans.jsonl").read_text() == (j / "spans.jsonl").read_text()
    ts, jsr = np.load(t / "series.npz"), np.load(j / "series.npz")
    assert sorted(ts.files) == sorted(jsr.files)
    for k in jsr.files:
        if k != "meta":
            assert np.array_equal(ts[k], jsr[k]), k


def test_cli_metrics_port_scrape(monkeypatch, tmp_path):
    """--metrics-port 0: the endpoint binds 127.0.0.1, serves the run's
    Prometheus text while it is up (scraped from the last step), and is
    stopped when main returns."""
    from repro_torch.obs import httpd
    from repro_torch.serving.server import FaultTolerantServer

    servers, scraped = [], []
    real_init, real_run = httpd.MetricsServer.__init__, FaultTolerantServer.run

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        servers.append(self)

    def run(self, *a, **kw):
        out = real_run(self, *a, **kw)
        url = f"http://127.0.0.1:{servers[0].port}/metrics"
        with urllib.request.urlopen(url, timeout=10) as r:
            scraped.append(r.read().decode())
        return out

    monkeypatch.setattr(httpd.MetricsServer, "__init__", init)
    monkeypatch.setattr(FaultTolerantServer, "run", run)
    out = tmp_path / "ev.jsonl"
    TS.main(BASE + CLI["protected"] + ["--device", "cpu", "--metrics-port", "0", "--metrics-out", str(out)])
    assert servers[0]._host == "127.0.0.1" and servers[0]._httpd is None  # stopped
    lines = [ln for ln in scraped[0].splitlines() if not any(w in ln for w in WALL)]
    assert lines == [ln for ln in (tmp_path / "ev.jsonl.prom").read_text().splitlines()
                     if not any(w in ln for w in WALL)]
    assert any(ln.startswith("hyca_steps") for ln in lines)


def test_cuda_requested_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config(ARCH)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.make_prefill(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.make_decode(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.main(BASE + CLI["off"])


def test_hw_constants_are_the_h100s():
    names = ("PEAK_FLOPS_BF16", "PEAK_FLOPS_F32", "PEAK_OPS_INT32", "HBM_BW", "HBM_BYTES", "SM_COUNT",
             "SMEM_PER_SM", "SMEM_PER_BLOCK", "L2_BYTES", "NVLINK_BW", "POWER_LIMIT_W")
    assert all(getattr(hw, n) > 0 for n in names)
    assert (hw.PEAK_FLOPS_BF16, hw.HBM_BW, hw.SM_COUNT, hw.L2_BYTES) == (989e12, 3.35e12, 132, 50 * 2**20)
    assert hw.PEAK_FLOPS_BF16 > hw.PEAK_FLOPS_F32 and hw.SMEM_PER_BLOCK < hw.SMEM_PER_SM
    # no TPU figure carries over: v5e's bf16 peak, HBM rate and size, ICI and VMEM
    from repro.launch import hw as tpu

    assert not hasattr(hw, "ICI_BW") and not hasattr(hw, "VMEM_BYTES") and not hasattr(hw, "CHIPS_PER_POD")
    for n in ("PEAK_FLOPS_BF16", "HBM_BW", "HBM_BYTES"):
        assert getattr(hw, n) != getattr(tpu, n)
    assert "H100" in hw.__doc__ and "700.00 W" in hw.__doc__ and "TPU" not in hw.__doc__
