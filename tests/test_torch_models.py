"""The port's model stack held against the JAX model stack.

The JAX params (``init_params`` from a fixed key) are handed to the port
through numpy, and both run the same teacher-forced decode with an FTContext
carrying faults beyond DPPU capacity, so corrupted elements flow through the
whole stack.  Tolerances: in f32 the two differ only by summation order and
libm rounding (|Δ| <= 2e-5 on logits of size ~1); in bf16 every op rounds
to 8 mantissa bits, the two frameworks round at some different places, and
the differences compound through six cached steps, so |Δ| <= 2^-4 with a
mean |Δ| <= 4e-3.  A stuck bit is a discontinuity: a stuck exponent bit
turns a one-ulp difference that straddles a power of two into a jump of the
value's size, so the bf16 case carries faults on the low bf16 mantissa bits
(16-18), which survive the cast but jump by at most one bf16 ulp.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.core import engine as JE
from repro.core.ftcontext import build_ftcontext as j_build
from repro.core.redundancy import DPPUConfig as JDPPU
from repro.models import lm as JL
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import engine as TE
from repro_torch.core.ftcontext import ProtectPolicy, build_ftcontext
from repro_torch.core.redundancy import DPPUConfig as TDPPU
from repro_torch.models import lm as TL

ARCH = "qwen1.5-0.5b"
ROWS, COLS = 4, 4
# capacity 1: PE(0, 1) is repaired; the other two corrupt, on PE rows < the
# batch of 3
FAULTS = {torch.float32: [(0, 1, 22, 1), (1, 2, 30, 0), (2, 3, 25, 1)],
          torch.bfloat16: [(0, 1, 18, 1), (1, 2, 17, 0), (2, 3, 16, 1)]}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0**-4}
MEAN_TOL = {torch.float32: 2e-6, torch.bfloat16: 4e-3}


@pytest.fixture(scope="module")
def jax_params():
    return JL.init_params(jax.random.key(0), j_smoke(ARCH))


def _numpy_tree(params):
    return jax.tree.map(np.asarray, params)


def _contexts(faults, mode="protected", layer_fraction=1.0):
    fm = np.zeros((ROWS, COLS), bool)
    for r, c, _, _ in faults:
        fm[r, c] = True
    js = JE.fault_state_from_map(fm, max_faults=16)
    bits = np.zeros(16, np.int32)
    vals = np.zeros(16, np.int32)
    for i, (r, c) in enumerate(np.asarray(js.fpt)[:3]):
        _, _, bits[i], vals[i] = next(f for f in faults if f[:2] == (r, c))
    js = JE.FaultState(js.fpt, jnp.asarray(bits), jnp.asarray(vals))
    ts = TE.FaultState(torch.from_numpy(np.array(js.fpt)), torch.from_numpy(bits), torch.from_numpy(vals))
    jc = JE.HyCAConfig(ROWS, COLS, JDPPU(size=1, group_size=1), mode)
    tc = TE.HyCAConfig(ROWS, COLS, TDPPU(size=1, group_size=1), mode)
    from repro.core.ftcontext import ProtectPolicy as JPolicy

    return (j_build(js, jc, dispatch="fused", policy=JPolicy(layer_fraction=layer_fraction)),
            build_ftcontext(ts, tc, dispatch="fused", policy=ProtectPolicy(layer_fraction=layer_fraction)))


def test_params_from_numpy_round_trip(jax_params):
    tree = _numpy_tree(jax_params)
    p = TL.params_from_numpy(tree, "cpu")
    cfg = get_smoke_config(ARCH)
    assert len(p["blocks"]) == cfg.n_layers
    assert p["embed"].shape == (cfg.padded_vocab, cfg.d_model)
    back = {k: v.numpy() for k, v in p.items() if k != "blocks"}
    restacked = jax.tree.map(lambda *xs: np.stack(xs), *[
        jax.tree.map(lambda t: t.numpy(), blk) for blk in p["blocks"]])
    back["blocks"] = restacked
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # working copies: cast once, floating leaves only, shared when already cast
    w = TL.cast_params(p, torch.bfloat16)
    assert w["blocks"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert TL.cast_params(w, torch.bfloat16)["embed"] is w["embed"]


def test_init_params_and_cache_shapes():
    cfg = get_smoke_config(ARCH)
    gen = torch.Generator().manual_seed(0)
    p = TL.init_params(gen, cfg)
    p2 = TL.init_params(torch.Generator().manual_seed(0), cfg)
    assert torch.equal(p["blocks"][1]["ffn"]["down"], p2["blocks"][1]["ffn"]["down"])
    assert p["blocks"][0]["attn"]["bq"].shape == (cfg.n_heads * cfg.attn_cfg.hd,)
    cache = TL.init_cache(cfg, 3, 16, device="cpu")
    assert len(cache["attn"]) == cfg.n_layers
    assert cache["attn"][0]["k"].shape == (3, 16, cfg.n_kv, cfg.attn_cfg.hd)
    assert cache["attn"][0]["k"].dtype == torch.bfloat16
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.padded_vocab) == (24, 1024, 152064)
    assert get_config("rwkv6-7b").family == "ssm"
    with pytest.raises(ValueError, match="unknown family"):
        TL.init_cache(dataclasses.replace(cfg, family="rnn"), 1, 4, device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layer_fraction", [1.0, 0.5])
def test_decode_step_matches_jax(jax_params, dtype, layer_fraction):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jcfg = dataclasses.replace(j_smoke(ARCH), dtype=jdt)
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    tparams = TL.cast_params(TL.params_from_numpy(_numpy_tree(jax_params), "cpu"), dtype)
    jftc, tftc = _contexts(FAULTS[dtype], "protected", layer_fraction)
    jcache = JL.init_cache(jcfg, 3, 16)
    tcache = TL.init_cache(tcfg, 3, 16, device="cpu")
    jstep = jax.jit(JL.decode_step, static_argnums=(1,))
    rng = np.random.default_rng(1)
    for _ in range(6):
        tok = rng.integers(0, tcfg.vocab, (3, 1)).astype(np.int32)
        jl, jcache = jstep(jax_params, jcfg, jcache, {"token": jnp.asarray(tok)}, ftc=jftc)
        tl, tcache = TL.decode_step(tparams, tcfg, tcache, {"token": torch.from_numpy(tok)}, ftc=tftc)
        assert tl.shape == (3, 1, tcfg.padded_vocab) and tl.dtype == dtype
        a = np.asarray(jl.astype(jnp.float32))
        b = tl.float().numpy()
        np.testing.assert_allclose(b[..., :tcfg.vocab], a[..., :tcfg.vocab], rtol=0, atol=TOL[dtype])
        assert np.abs(b[..., :tcfg.vocab] - a[..., :tcfg.vocab]).mean() <= MEAN_TOL[dtype]
        assert (b[..., tcfg.vocab:] < -1e29).all()
    for i in range(tcfg.n_layers):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                tcache["attn"][i][name].float().numpy(),
                np.asarray(jcache["attn"][name][i].astype(jnp.float32)), rtol=0, atol=TOL[dtype])
        assert np.array_equal(tcache["attn"][i]["idx"].numpy(), np.asarray(jcache["attn"]["idx"][i]))


def test_faults_reach_the_logits(jax_params):
    """The over-capacity faults really corrupt the decode, and a fault-free
    table through the same protected context is the clean run."""
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype=torch.float32)
    tparams = TL.params_from_numpy(_numpy_tree(jax_params), "cpu")
    _, tftc = _contexts(FAULTS[torch.float32], "protected")
    tok = torch.tensor([[5], [6], [7]], dtype=torch.int32)
    faulty, _ = TL.decode_step(tparams, tcfg, TL.init_cache(tcfg, 3, 8, device="cpu"), {"token": tok}, ftc=tftc)
    clean_ctx = tftc.with_state(TE.empty_fault_state(16))
    clean, _ = TL.decode_step(tparams, tcfg, TL.init_cache(tcfg, 3, 8, device="cpu"), {"token": tok}, ftc=clean_ctx)
    plain, _ = TL.decode_step(tparams, tcfg, TL.init_cache(tcfg, 3, 8, device="cpu"), {"token": tok})
    assert not torch.equal(faulty, clean)
    torch.testing.assert_close(clean, plain, rtol=0, atol=1e-5)
