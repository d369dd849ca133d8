"""The attention model families of the port held against the JAX package:
granite-8b (llama-style dense, untied head), starcoder2-3b (LayerNorm,
non-gated GELU FFN, QKV bias), minicpm3-4b (MLA), llava-next-mistral-7b
(vlm: the multimodal projector and the patch splice) and whisper-tiny
(encdec: the encoder over frames, cross-attention in every decoder layer).

Each smoke config's JAX params (``init_params`` from a fixed key) reach the
port through numpy; inputs are made with numpy from seeds.  Tolerances are
those of the dense and moe families (``test_torch_train.py``,
``test_torch_models.py``): in f32 the frameworks differ only by summation
order and libm rounding (logits within 2e-5, each gradient leaf within 1e-4
of its largest entry); in bf16 they round at different places (forward
logits within 2^-3, mean 2^-6; decode logits within 2^-4, mean 4e-3, with
faults on the low bf16 mantissa bits).  Protected with faults the DPPU
repairs is held bitwise to off, as ``tests/test_ftcontext.py`` holds the
JAX package.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as JS
from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.configs.registry import ARCH_IDS as J_ARCH_IDS
from repro.models import layers as JLay
from repro.models import lm as JL
from repro.repair import remap as JR
from repro.serving import FaultTolerantServer as JServer
from repro.serving import ModelBundle as JBundle
from repro.serving import ServerConfig as JConfig
from repro.serving.fault_manager import FaultInjector as JInjector
from repro_torch.checkpoint import store as TS
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import engine as TE
from repro_torch.core.ftcontext import build_ftcontext
from repro_torch.core.redundancy import DPPUConfig as TDPPU
from repro_torch.launch import train as TT
from repro_torch.models import encdec as TED
from repro_torch.models import layers as TLay
from repro_torch.models import lm as TL
from repro_torch.repair import remap as TR
from repro_torch.serving import FaultTolerantServer, ModelBundle, ServerConfig
from repro_torch.serving.fault_manager import FaultInjector
from repro_torch.serving.scheduler import DECODE
from repro_torch.tree import tree_leaves, tree_map

from test_torch_models import FAULTS as DECODE_FAULTS
from test_torch_models import MEAN_TOL as DECODE_MEAN_TOL
from test_torch_models import TOL as DECODE_TOL
from test_torch_models import _contexts
from test_torch_train import DTYPES, GRAD_TOL, LOGIT_TOL, LOSS_TOL, _ctxs, _leafwise_max_err

ARCHS = ("granite-8b", "starcoder2-3b", "minicpm3-4b", "llava-next-mistral-7b", "whisper-tiny")
CONSISTENCY_TOL = 0.08  # rtol and atol, as tests/test_models.py holds the reference


@pytest.fixture(scope="module")
def jparams():
    return {arch: JL.init_params(jax.random.key(0), j_smoke(arch)) for arch in ARCHS}


def _cfgs(arch, dtype="f32", **kw):
    jdt, tdt = DTYPES[dtype]
    return (dataclasses.replace(j_smoke(arch), dtype=jdt, **kw),
            dataclasses.replace(get_smoke_config(arch), dtype=tdt, **kw))


def _port(jp):
    return TL.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _batch(cfg, b=2, s=16, seed=0):
    """tokens, labels (a few masked) and the family's frames / patches, as
    (JAX batch, port batch)."""
    rng = np.random.default_rng(seed)
    s = max(s, cfg.n_patches)
    arrs = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    arrs["labels"][0, :3] = -1
    if cfg.family == "encdec":
        arrs["frames"] = (rng.standard_normal((b, cfg.enc_len, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "vlm":
        arrs["patches"] = (rng.standard_normal((b, cfg.n_patches, cfg.d_vision)) * 0.02).astype(np.float32)
    return {k: jnp.asarray(v) for k, v in arrs.items()}, {k: torch.from_numpy(v) for k, v in arrs.items()}


def _logit_err(jl, tl, vocab):
    d = np.abs(np.asarray(jl.astype(jnp.float32))[..., :vocab] - tl.float().numpy()[..., :vocab])
    return float(d.max()), float(d.mean())


# --------------------------------------------------------------------------- #
# configs and params
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    """The port's config files are copies of the reference's: every field
    equal (the dtype as its torch twin), full and smoke."""
    for jget, tget in ((j_config, get_config), (j_smoke, get_smoke_config)):
        jc, tc = jget(arch), tget(arch)
        jf = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc) if f.name != "dtype"}
        tf = {f.name: getattr(tc, f.name) for f in dataclasses.fields(tc) if f.name != "dtype"}
        for k in ("mla", "moe"):
            jf[k] = None if jf[k] is None else dataclasses.asdict(jf[k])
            tf[k] = None if tf[k] is None else dataclasses.asdict(tf[k])
        assert jf == tf
        assert (jc.dtype, tc.dtype) == (jnp.bfloat16, torch.bfloat16)


def test_registry_is_the_reference_registry():
    """The port's registry holds the reference registry's ten ids, in its
    order, the recurrent ones included (tests/test_torch_recurrent.py)."""
    assert ARCH_IDS == tuple(J_ARCH_IDS) and len(ARCH_IDS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_match_the_reference_tree(jparams, arch):
    """The port's own init has the reference's tree (after restacking),
    leaf for leaf in shape and dtype, and the JAX params survive the trip
    through the port's layout bit for bit."""
    cfg = get_smoke_config(arch)
    own = TL.params_to_numpy(TL.init_params(torch.Generator().manual_seed(0), cfg))
    ref = jax.tree.map(np.asarray, jparams[arch])
    assert jax.tree.structure(own) == jax.tree.structure(ref)
    assert all(a.shape == b.shape and a.dtype == b.dtype for a, b in zip(jax.tree.leaves(own), jax.tree.leaves(ref)))
    back = TL.params_to_numpy(_port(jparams[arch]))
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)))


def test_layernorm_and_sinusoidal_positions_match_jax():
    """LayerNorm's dtype order (the mean cast to x.dtype before it is
    subtracted) in f32 and bf16; the sinusoidal table."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((3, 5, 48)) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    b = (0.1 * rng.standard_normal(48)).astype(np.float32)
    jp, tp = {"g": jnp.asarray(g), "b": jnp.asarray(b)}, {"g": torch.from_numpy(g), "b": torch.from_numpy(b)}
    want = np.asarray(JLay.layernorm(jnp.asarray(x), jp))
    np.testing.assert_allclose(TLay.layernorm(torch.from_numpy(x), tp).numpy(), want, rtol=0, atol=2e-6)
    want16 = np.asarray(JLay.layernorm(jnp.asarray(x, jnp.bfloat16), jp).astype(jnp.float32))
    got16 = TLay.layernorm(torch.from_numpy(x).bfloat16(), tp)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(), want16, rtol=0, atol=2.0**-5)
    np.testing.assert_allclose(TLay.sinusoidal_positions(1500, 384, device="cpu").numpy(),
                               np.asarray(JLay.sinusoidal_positions(1500, 384)), rtol=0, atol=2e-4)


# --------------------------------------------------------------------------- #
# forward, decode
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(jparams, arch, dtype):
    """``forward`` with the family's frames / patches, protected on a faulty
    array (twopass, one fault repaired, two not) against JAX."""
    jc, tc = _cfgs(arch, dtype)
    jb, tb = _batch(jc)
    jf, tf = _ctxs("twopass_protected", dtype)
    jl, _ = JL.forward(jparams[arch], jc, jb, ftc=jf)
    tl, _ = TL.forward(_port(jparams[arch]), tc, tb, ftc=tf)
    assert tl.dtype == DTYPES[dtype][1] and tuple(tl.shape) == jl.shape
    err, mean = _logit_err(jl, tl, jc.vocab)
    tol, mean_tol = LOGIT_TOL[dtype]
    assert err <= tol and mean <= mean_tol, (err, mean)
    assert np.all(tl.float().numpy()[..., jc.vocab:] <= -1e29)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(jparams, arch, dtype):
    """Four cached decode steps under a fused protected context with two
    faults past DPPU capacity, against JAX: logits and every cache part.
    whisper's ``enc`` is filled with the same seeded encoder output on both
    sides, so cross-attention reads real keys."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jcfg = dataclasses.replace(j_smoke(arch), dtype=jdt)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    tparams = TL.cast_params(_port(jparams[arch]), dtype)
    jftc, tftc = _contexts(DECODE_FAULTS[dtype])
    jcache, tcache = JL.init_cache(jcfg, 3, 8), TL.init_cache(tcfg, 3, 8, device="cpu")
    rng = np.random.default_rng(1)
    if tcfg.family == "encdec":
        enc = rng.standard_normal((3, tcfg.enc_len, tcfg.d_model)).astype(np.float32)
        jcache["enc"] = jnp.asarray(enc, jnp.bfloat16)
        tcache["enc"].copy_(torch.from_numpy(enc))
    jstep = jax.jit(JL.decode_step, static_argnums=(1,))
    for _ in range(4):
        tok = rng.integers(0, tcfg.vocab, (3, 1)).astype(np.int32)
        jl, jcache = jstep(jparams[arch], jcfg, jcache, {"token": jnp.asarray(tok)}, ftc=jftc)
        tl, tcache = TL.decode_step(tparams, tcfg, tcache, {"token": torch.from_numpy(tok)}, ftc=tftc)
        assert tl.shape == (3, 1, tcfg.padded_vocab) and tl.dtype == dtype
        err, mean = _logit_err(jl, tl, tcfg.vocab)
        assert err <= DECODE_TOL[dtype] and mean <= DECODE_MEAN_TOL[dtype], (err, mean)
    for name in tcache["attn"][0]:
        got = torch.stack([c[name] for c in tcache["attn"]])
        want = np.asarray(jcache["attn"][name].astype(jnp.float32) if name != "idx" else jcache["attn"][name])
        if name == "idx":
            assert np.array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=DECODE_TOL[dtype])
    if "enc" in tcache:  # read, never written
        assert np.array_equal(tcache["enc"].float().numpy(), np.asarray(jcache["enc"].astype(jnp.float32)))


def _visible_state(seed=3, n=4, max_faults=8):
    """``n`` faults on an 8x8 array with bit 30 stuck at 1 (a high exponent
    bit: the corruption shows on any value), n <= the DPPU's 8."""
    rng = np.random.default_rng(seed)
    fmap = np.zeros((8, 8), bool)
    fmap.reshape(-1)[rng.choice(64, size=n, replace=False)] = True
    st = TE.fault_state_from_map(fmap, max_faults=max_faults)
    return TE.FaultState(st.fpt, torch.full((max_faults,), 30, dtype=torch.int32),
                         torch.ones((max_faults,), dtype=torch.int32))


@pytest.mark.parametrize("dispatch", ["twopass", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_protected_equals_off_bitwise(jparams, arch, dispatch):
    """Faults within DPPU capacity move no bit of ``forward`` or
    ``decode_step`` (the same context fed an empty fault table is off);
    unprotected, the same faults change both; off is the plain run within
    float tolerance."""
    _, tc = _cfgs(arch)
    params = _port(jparams[arch])
    _, tb = _batch(tc, b=1, s=8, seed=4)
    state = _visible_state()
    hy = {m: TE.HyCAConfig(8, 8, TDPPU(size=8, group_size=8), m) for m in ("protected", "unprotected")}
    prot = build_ftcontext(state, hy["protected"], dispatch=dispatch)
    off = prot.with_state(TE.empty_fault_state(state.max_faults))
    bad = build_ftcontext(state, hy["unprotected"], dispatch=dispatch)

    def run(ctx):
        logits, _ = TL.forward(params, tc, tb, ftc=ctx)
        cache = TL.init_cache(tc, 1, 9, dtype=torch.float32, device="cpu")
        if tc.family == "encdec":
            cache["enc"].copy_(torch.from_numpy(np.random.default_rng(5).standard_normal(cache["enc"].shape)))
        step, _ = TL.decode_step(params, tc, cache, {"token": tb["tokens"][:, :1]}, ftc=ctx)
        return logits, step

    (f_off, d_off), (f_prot, d_prot), (f_bad, d_bad), (f_ref, d_ref) = (run(c) for c in (off, prot, bad, None))
    assert torch.equal(f_prot.view(torch.int32), f_off.view(torch.int32))
    assert torch.equal(d_prot.view(torch.int32), d_off.view(torch.int32))
    assert not torch.equal(f_bad, f_off) and not torch.equal(d_bad, d_off)
    torch.testing.assert_close(f_off, f_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(d_off, d_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "whisper-tiny"])
def test_prefill_decode_consistency(arch):
    """Teacher-forced decode reproduces the port's own forward (the
    reference's oracle for the cache path, ``tests/test_models.py``): MLA's
    absorbed decode against its expanded forward; for encdec the cache's
    ``enc`` holds the port's encoder output of the same frames.  bf16
    weights and cache, as served."""
    cfg = get_smoke_config(arch)
    params = TL.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    _, tb = _batch(cfg, b=2, s=16, seed=6)
    full, _ = TL.forward(params, cfg, tb)
    cache = TL.init_cache(cfg, 2, 17, device="cpu")
    work = TL.cast_params(params, cfg.dtype)
    if cfg.family == "encdec":
        from repro_torch.models.frontends import audio_frontend

        cache["enc"].copy_(TED.encoder_forward(audio_frontend(tb["frames"].to(cfg.dtype)), work["encoder"],
                                               cfg.d_model, cfg.n_heads))
    outs = []
    for t in range(16):
        lg, cache = TL.decode_step(work, cfg, cache, {"token": tb["tokens"][:, t:t + 1]})
        outs.append(lg[:, 0].float())
    dec, ref = torch.stack(outs, dim=1), full.float()
    mask = ref > -1e29
    torch.testing.assert_close(dec[mask], ref[mask], rtol=CONSISTENCY_TOL, atol=CONSISTENCY_TOL)
    assert all(int(c["idx"][0]) == 16 for c in cache["attn"])


# --------------------------------------------------------------------------- #
# loss and gradients
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dispatch", ["twopass_protected", "twopass_unprotected"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(jparams, arch, dispatch):
    """``loss_fn`` and its gradients w.r.t. the f32 masters under the
    two-pass engine on a faulty array, against ``jax.value_and_grad`` (no
    mesh: ROADMAP C2); the projector's and the encoder's leaves included."""
    jc, tc = _cfgs(arch)
    jb, tb = _batch(jc, seed=1)
    jf, tf = _ctxs(dispatch)
    (jloss, _), jg = jax.value_and_grad(lambda p: JL.loss_fn(p, jc, jb, ftc=jf), has_aux=True)(jparams[arch])
    leaves = tree_map(lambda a: a.requires_grad_(), _port(jparams[arch]))
    tloss, _ = TL.loss_fn(leaves, tc, tb, ftc=tf)
    tloss.backward()
    tg = TL.params_to_numpy(tree_map(lambda a: a.grad, leaves))
    assert abs(float(jloss) - float(tloss.detach())) <= LOSS_TOL["f32"] * max(1.0, abs(float(jloss)))
    assert jax.tree.structure(jg) == jax.tree.structure(tg)
    assert _leafwise_max_err(jg, tg) <= GRAD_TOL["f32"]
    extra = {"vlm": ("mm_proj", "fc1"), "encdec": ("encoder", "layers")}.get(jc.family)
    if extra:  # the frontend's params learn
        assert np.abs(tree_leaves(tg[extra[0]][extra[1]])[0]).max() > 0


# --------------------------------------------------------------------------- #
# serving, the ledger, salience, checkpoints
# --------------------------------------------------------------------------- #
BASE = dict(n_slots=4, smax=32, rows=4, cols=4, dppu_size=4, dispatch="fused", seed=0)
BIST = [(0, 1, 30, 1), (1, 2, 31, 0), (3, 3, 20, 1)]  # 3 <= capacity 4
GAP = 1e-4


def _trace(vocab):
    rng = np.random.default_rng(42)
    return [{"step": 0, "prompt": rng.integers(0, vocab, size=4), "max_new_tokens": 6} for _ in range(6)]


@pytest.mark.parametrize("arch", ARCHS)
def test_server_matches_jax(jparams, arch):
    """The smoke server, protected with three BIST faults, against the JAX
    server on the same trace and weights in f32: events, summary and every
    token (no sampled row within GAP of a tie).  whisper is served over a
    zero encoder output on both sides, as the reference serves it."""
    kw = dict(arch=arch, mode="protected", **BASE)
    jb = JBundle(JConfig(**kw), lm=dataclasses.replace(j_smoke(arch), dtype=jnp.float32))
    tb = ModelBundle(ServerConfig(device="cpu", **kw),
                     lm=dataclasses.replace(get_smoke_config(arch), dtype=torch.float32),
                     params=TL.params_from_numpy(jax.tree.map(np.asarray, jb.params), "cpu"))
    jinj, tinj = JInjector(4, 4, seed=1), FaultInjector(4, 4, seed=1)
    for r, c, b, v in BIST:
        jinj.inject_at(r, c, bit=b, val=v)
        tinj.inject_at(r, c, bit=b, val=v)
    jsrv = JServer(JConfig(**kw), bundle=jb, injector=jinj)
    jsum = jsrv.run(_trace(jb.lm.vocab), max_steps=64)
    tsrv = FaultTolerantServer(ServerConfig(device="cpu", **kw), bundle=tb, injector=tinj)
    gaps = []
    step_fn = tb.step_fn

    def recording(*a, **k):
        logits, cache = step_fn(*a, **k)
        used = torch.tensor([s.request is not None and (s.phase == DECODE or s.pos == s.request.prompt_len - 1)
                             for s in tsrv.scheduler.slots])
        if used.any():
            top = torch.topk(logits[:, -1, :tb.lm.vocab], 2, dim=-1).values
            gaps.append(float((top[:, 0] - top[:, 1])[used].min()))
        return logits, cache

    tb.step_fn = recording
    tsum = tsrv.run(_trace(tb.lm.vocab), max_steps=64)
    assert [(e.kind, e.step, e.data) for e in tsrv.log.events] == [(e.kind, e.step, e.data) for e in jsrv.log.events]
    volatile = {"wall_s", "tokens_per_s", "host_phase_ms"}
    assert {k: v for k, v in tsum.items() if k not in volatile} == {k: v for k, v in jsum.items() if k not in volatile}
    assert gaps and min(gaps) > GAP
    jt, tt = jsrv.completions_by_rid(), tsrv.completions_by_rid()
    assert jt.keys() == tt.keys() and len(tt) == 6
    assert all(np.array_equal(jt[r], tt[r]) for r in jt)
    assert tsrv.manager.n_confirmed == len(BIST)


@pytest.mark.parametrize("arch", ARCHS)
def test_ledger_matches_jax(jparams, arch):
    """The port's decode-step ledger, recorded on the ``meta`` device,
    equals the JAX ledger row for row: MLA's q-side LoRA pair, ``wkv_a``
    and ``wo`` (not ``wkv_b``, which decode absorbs off the array), and
    whisper's cross-attention K and V over the whole encoder output."""
    kw = dict(arch=arch, mode="off", n_slots=3, smax=16, rows=4, cols=4, dppu_size=2, seed=0, dispatch="fused")
    jb = JBundle(JConfig(counters=True, **kw), lm=dataclasses.replace(j_smoke(arch), dtype=jnp.float32))
    tb = ModelBundle(ServerConfig(device="cpu", **kw),
                     lm=dataclasses.replace(get_smoke_config(arch), dtype=torch.float32),
                     params=TL.params_from_numpy(jax.tree.map(np.asarray, jb.params), "cpu"))
    rows = [(c.site, c.m, c.n, c.count, c.dispatch, c.protected) for c in tb.ledger]
    assert rows == [(c.site, c.m, c.n, c.count, c.dispatch, c.protected) for c in jb.ftc.ledger]
    cfg = tb.lm
    if cfg.family == "encdec":
        assert ("attn.qkv", 3 * cfg.enc_len, cfg.d_model) in {r[:3] for r in rows}


@pytest.mark.parametrize("arch", ARCHS)
def test_weight_salience_matches_jax(jparams, arch):
    """The salience fold reads every layer stack stacked, the encoder's
    one level below the top included: float64 equal to the reference."""
    ref = JR.weight_salience(jparams[arch], 8)
    assert np.array_equal(TR.weight_salience(_port(jparams[arch]), 8), ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_across_packages(jparams, arch, tmp_path):
    """The params written by each package read back bitwise by the other:
    the same leaf names (``encoder__layers__attn__wq`` stacked), manifests
    and tree hash."""
    jp, tp = jparams[arch], _port(jparams[arch])
    JS.save(str(tmp_path / "jax"), 1, jp)
    TS.save(str(tmp_path / "port"), 1, tp)
    got = TS.restore(str(tmp_path / "jax"), 1, tp)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(tp)))
    back = JS.restore(str(tmp_path / "port"), 1, jp)
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)))
    import json

    manifests = [json.load(open(tmp_path / d / "step_00000001" / "manifest.json")) for d in ("jax", "port")]
    assert manifests[0] == manifests[1]
    if arch == "whisper-tiny":
        names = {n for n, _, _ in manifests[0]["leaves"]}
        assert "encoder__layers__attn__wq" in names and "encoder__ln_post__g" in names


def test_reset_fn_zeroes_one_slot_of_every_cache_part():
    """whisper's cache: each decoder layer's K/V/idx and the encoder output
    ``enc`` lose slot 1, on its batch axis, and nothing else."""
    cfg = get_smoke_config("whisper-tiny")
    bundle = ModelBundle(ServerConfig(arch="whisper-tiny", device="cpu", **BASE), lm=cfg)
    cache = bundle.fresh_cache()
    for t in tree_leaves(cache):
        t.fill_(1)
    bundle.reset_fn(cache, 1)
    assert cache["enc"].shape == (4, cfg.enc_len, cfg.d_model)
    for t in tree_leaves(cache):
        assert not t[1].any() and bool((t[[0, 2, 3]] == 1).all())


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "whisper-tiny"])
def test_train_cli_runs_the_frontend_families(tmp_path, arch):
    """The training CLI on the smoke configs whose batches carry patches or
    frames: protected twopass steps with a checkpoint."""
    state = TT.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2", "--seq", "16", "--steps", "2",
                     "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2", "--hyca-mode", "protected"])
    assert int(state["opt"]["step"]) == 2
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(state["params"]))
