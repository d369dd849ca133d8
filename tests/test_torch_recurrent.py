"""The recurrent families of the port held against the JAX package: RWKV6
(rwkv6-7b, family ssm) and Mamba2 with a shared attention block
(zamba2-1.2b, family hybrid), and the plain matmul's promotion of mixed
float operands, which RWKV6's decay LoRA needs (an f32 ``tanh`` against the
``cfg.dtype`` weight ``w_b``).

Params come from the JAX init through numpy; inputs are made with numpy
from seeds.  Tolerances are those of the attention families
(``test_torch_families.py``): logits of a forward within ``LOGIT_TOL``,
decode logits and cache parts within ``DECODE_TOL`` (mean
``DECODE_MEAN_TOL``), gradients within ``GRAD_TOL`` of each leaf's largest
entry, prefill against decode within ``CONSISTENCY_TOL``.  One tolerance
is new, ``MODULE_TOL``, for a single block's output against the JAX
block's: in f32 the two differ by summation order and libm rounding
(2e-5 of the output's largest entry, as the f32 logits); in bf16 one block
rounds at a few different places, each at most one bf16 ulp (2^-8) of the
value (2^-5 of the largest entry, half the forward logits' 2^-3, which
have compounded through every layer).  Chunked against recurrent and
stepwise: 2e-3, as ``tests/test_models.py`` holds the reference.

Stuck bits and rounding (ROADMAP C, known limits).  Where the two
frameworks' values of an output on an unrepaired faulty PE differ by one
ulp across a carry into the stuck bit b, the stuck bit moves them one
weight of b apart, 2^(b-23) of the value's binade in f32.  The LM head is
the last matmul, so a logit it writes may sit that weight off JAX's and
nothing follows it: ``_head_room`` allows exactly that.  A jump inside the
stack propagates, so the f32 decode carries its faults on the mantissa bits
of ``test_torch_train.py`` (22, 21, 20) rather than the exponent bits of
``test_torch_models.py`` (an exponent fault scales a row by 16, and its
rounding differences with it), and zamba2's gradients are held under the
protected and the plan dispatch: its unprotected run straddles bit 20 of
an FFN output in the second group (0.21875003 against 0.21874997, a jump of
2^-6), which reaches the shared block's gradients at 3.9e-4 of their
largest entry.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as JS
from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.configs.registry import ARCH_IDS as J_ARCH_IDS
from repro.core import engine as JE
from repro.core.ftcontext import ProtectPolicy as JPolicy
from repro.core.ftcontext import build_ftcontext as j_build
from repro.core.redundancy import DPPUConfig as JDPPU
from repro.models import lm as JL
from repro.models import mamba2 as JM
from repro.models import rwkv6 as JR6
from repro.obs.counters import trace_site_calls as j_trace
from repro.repair import remap as JR
from repro.serving import FaultTolerantServer as JServer
from repro.serving import ModelBundle as JBundle
from repro.serving import ServerConfig as JConfig
from repro.serving.fault_manager import FaultInjector as JInjector
from repro_torch.checkpoint import store as TS
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import engine as TE
from repro_torch.core import ftcontext as TF
from repro_torch.core.redundancy import DPPUConfig as TDPPU
from repro_torch.launch import train as TT
from repro_torch.models import lm as TL
from repro_torch.models import mamba2 as TM
from repro_torch.models import rwkv6 as TR6
from repro_torch.obs.counters import _LedgerRecorder, trace_site_calls
from repro_torch.repair import remap as TR
from repro_torch.serving import FaultTolerantServer, ModelBundle, ServerConfig
from repro_torch.serving.fault_manager import FaultInjector
from repro_torch.tree import tree_leaves, tree_map

from test_torch_families import BASE, BIST, CONSISTENCY_TOL, DECODE_FAULTS, DECODE_MEAN_TOL, DECODE_TOL
from test_torch_families import _batch, _trace, _visible_state
from test_torch_models import _contexts
from test_torch_train import DTYPES, FAULT_BITS, GRAD_TOL, LOGIT_TOL, LOSS_TOL, _ctxs, _leafwise_max_err

RWKV, ZAMBA = "rwkv6-7b", "zamba2-1.2b"
ARCHS = (RWKV, ZAMBA)
MODULE_TOL = {"f32": 2e-5, "bf16": 2.0**-5}  # of the output's largest entry
STEP_TOL = 2e-3  # chunked against recurrent / stepwise, as tests/test_models.py
# the f32 decode's faults (capacity 1 repairs PE(0, 1)): mantissa bits, as FAULT_BITS
MANTISSA_FAULTS = [(0, 1, 22, 1), (1, 2, 21, 0), (2, 3, 20, 1)]


@pytest.fixture(scope="module")
def jparams():
    return {arch: JL.init_params(jax.random.key(0), j_smoke(arch)) for arch in ARCHS}


def _np(t) -> np.ndarray:
    return np.asarray(t.astype(jnp.float32)) if isinstance(t, jax.Array) else t.detach().float().numpy()


def _both(a: np.ndarray, dtype: str):
    """One numpy array as a JAX and a torch tensor of ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _port(jp):
    return TL.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _cfgs(arch, dtype="f32", **kw):
    jdt, tdt = DTYPES[dtype]
    return (dataclasses.replace(j_smoke(arch), dtype=jdt, **kw),
            dataclasses.replace(get_smoke_config(arch), dtype=tdt, **kw))


def _head_room(ref, unrepaired, rows=4, cols=4) -> np.ndarray:
    """Per logit of ``ref`` (..., V), the room a stuck bit of the head leaves:
    on an unrepaired PE (i % rows, j % cols) with stuck bit b, one weight of
    b at the logit's binade, 2^(b - 23 + floor(log2 |v|)); 0 elsewhere."""
    v = _np(ref)
    flat = v.reshape(-1, v.shape[-1])
    room = np.zeros_like(flat)
    for r, c, b in unrepaired:
        sub = flat[r::rows, c::cols]
        room[r::rows, c::cols] = np.exp2(b - 23 + np.floor(np.log2(np.maximum(np.abs(sub), 1e-30))))
    return room.reshape(v.shape)


def _logits_held(jl, tl, vocab, tol, mean_tol, unrepaired=()):
    """max |Δ| beyond the head's stuck-bit room within ``tol``, mean |Δ|
    within ``mean_tol``."""
    d = np.abs(_np(jl) - _np(tl))[..., :vocab]
    over = d - (_head_room(jl, unrepaired)[..., :vocab] if unrepaired else 0.0)
    assert float(over.max()) <= tol and float(d.mean()) <= mean_tol, (float(d.max()), float(over.max()), float(d.mean()))


def _rel_err(want, got) -> float:
    want, got = _np(want), _np(got)
    assert want.shape == got.shape
    return float(np.abs(want - got).max()) / max(float(np.abs(want).max()), 1e-30)


# --------------------------------------------------------------------------- #
# the plain matmul promotes mixed float operands as jnp.matmul does
# --------------------------------------------------------------------------- #
def _mixed_operands(seed=0):
    """f32 x with entries ±(1 + 2^-8) that bf16 cannot hold, and integer
    bf16 w: every partial sum is a multiple of 2^-8 below 2^16, exact in f32
    in any order, so each route is held bit for bit."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-4, 5, (3, 5, 16)).astype(np.float32)
    x[rng.random(x.shape) < 0.3] = (1 + 2.0**-8) * rng.choice([-1, 1])
    w = rng.integers(-4, 5, (16, 24)).astype(np.float32)
    return x, w


def _ctx_pair(dispatch, sites=None):
    hy = {"j": JE.HyCAConfig(4, 4, JDPPU(size=1, group_size=1), "protected"),
          "t": TE.HyCAConfig(4, 4, TDPPU(size=1, group_size=1), "protected")}
    jst = JE.empty_fault_state(4)
    tst = TE.empty_fault_state(4)
    return (j_build(jst, hy["j"], dispatch=dispatch, policy=JPolicy(sites=sites)),
            TF.build_ftcontext(tst, hy["t"], dispatch=dispatch, policy=TF.ProtectPolicy(sites=sites)))


@pytest.mark.parametrize("order", ["f32_x_bf16_w", "bf16_x_f32_w"])
def test_plain_matmul_promotes_as_jnp_matmul(order):
    """Every plain route of the port on a mixed f32 / bf16 pair, held bit for
    bit to the reference's route on the same operands: ``site_matmul``
    without a context (``jnp.matmul``), ``FTContext.matmul`` at a site the
    policy leaves unprotected and under ``dispatch="plain"`` (JAX's
    ``FTContext.matmul``), the call ledger's recorder (``jnp.matmul``; on
    ``meta`` it records the promoted dtype) and the salience probe.  An
    operand pair of one dtype takes ``torch.matmul`` unchanged."""
    x, w = _mixed_operands()
    jx, tx = _both(x, "f32" if order.startswith("f32") else "bf16")
    jw, tw = _both(w, "bf16" if order.startswith("f32") else "f32")
    want = jnp.matmul(jx, jw)
    assert want.dtype == jnp.float32

    def same(got, ref):
        assert str(got.dtype) == f"torch.{ref.dtype}"
        assert np.array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))

    same(TF.site_matmul(None, "ssm.in")(tx, tw), want)
    same(TF.plain_matmul(tx, tw), want)
    for dispatch, sites in (("fused", frozenset({"ffn"})), ("plain", None)):
        jc, tc = _ctx_pair(dispatch, sites)
        same(tc.matmul(tx, tw, site="ssm.in"), jc.matmul(jx, jw, site="ssm.in"))
    rec = _LedgerRecorder(_ctx_pair("fused")[1])
    same(rec.matmul(tx, tw, site="ssm.in"), want)
    assert rec.matmul(tx.to("meta"), tw.to("meta"), site="ssm.in").dtype == torch.float32
    same(TR.SalienceProbe(4).matmul(tx, tw, site="ssm.in"), want)
    a = torch.from_numpy(x)
    assert torch.equal(TF.plain_matmul(a, a.transpose(-1, -2)), torch.matmul(a, a.transpose(-1, -2)))


# --------------------------------------------------------------------------- #
# the modules
# --------------------------------------------------------------------------- #
R6 = (TR6.RWKV6Config(d_model=64, d_ff=128, head_dim=32, decay_lora=16),
      JR6.RWKV6Config(d_model=64, d_ff=128, head_dim=32, decay_lora=16))
M2 = (TM.Mamba2Config(d_model=64, d_state=16, head_dim=32, chunk=16),
      JM.Mamba2Config(d_model=64, d_state=16, head_dim=32, chunk=16))
# the reference's blocks, compiled once a config (op-by-op dispatch of a bf16
# block takes seconds)
J_RWKV_FORWARD = jax.jit(JR6.rwkv6_forward, static_argnums=(2,), static_argnames=("chunked",))
J_RWKV_DECODE = jax.jit(JR6.rwkv6_decode, static_argnums=(2,))
J_SSD = jax.jit(JM.ssd_chunked, static_argnums=(6,))
J_MAMBA_FORWARD = jax.jit(JM.mamba2_forward, static_argnums=(2,))
J_MAMBA_DECODE = jax.jit(JM.mamba2_decode, static_argnums=(2,))


def _block(init, jcfg, dtype, seed):
    """A block's JAX params, in ``dtype`` on both sides (the reference's
    per-stage cast)."""
    jdt, tdt = DTYPES[dtype]
    jp = init(jax.random.key(seed), jcfg)
    return jax.tree.map(lambda a: a.astype(jdt), jp), tree_map(lambda a: a.to(tdt), _port(jp))


def _wkv_inputs(seed=3, b=2, s=32, h=2, dk=32):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, dk)).astype(np.float32) * 0.5 for _ in range(3))
    logw = rng.uniform(TR6.LOGW_MIN, -0.01, (b, s, h, dk)).astype(np.float32)
    u = (rng.standard_normal((h, dk)) * 0.02).astype(np.float32)
    state = (rng.standard_normal((b, h, dk, dk)) * 0.1).astype(np.float32)
    return r, k, v, logw, u, state


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_wkv_matches_jax(dtype):
    """``wkv_chunked`` and ``wkv_recurrent`` against JAX's, from a zero and
    from a given state, with the bonus ``u`` in ``dtype`` (the block's cast);
    the chunked form against the recurrent one."""
    r, k, v, logw, u, state = _wkv_inputs()
    jin = [jnp.asarray(a) for a in (r, k, v, logw)]
    tin = [torch.from_numpy(a) for a in (r, k, v, logw)]
    ju, tu = _both(u, dtype)
    for st in (None, state):
        js, ts = (None, None) if st is None else (jnp.asarray(st), torch.from_numpy(st))
        for jf, tf in ((JR6.wkv_chunked, TR6.wkv_chunked), (JR6.wkv_recurrent, TR6.wkv_recurrent)):
            jy, jS = jf(*jin, ju, js)
            ty, tS = tf(*tin, tu, ts)
            assert ty.dtype == tS.dtype == torch.float32
            assert _rel_err(jy, ty) <= MODULE_TOL["f32"] and _rel_err(jS, tS) <= MODULE_TOL["f32"]
        yc, Sc = TR6.wkv_chunked(*tin, tu, ts)
        yr, Sr = TR6.wkv_recurrent(*tin, tu, ts)
        torch.testing.assert_close(yc, yr, rtol=STEP_TOL, atol=STEP_TOL)
        torch.testing.assert_close(Sc, Sr, rtol=STEP_TOL, atol=STEP_TOL)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        TR6.wkv_chunked(*(t[:, :20] for t in tin), tu)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rwkv6_forward_and_decode_match_jax(dtype):
    """``rwkv6_forward`` (chunked and recurrent) and four ``rwkv6_decode``
    steps against JAX's, output and every state part; the decode writes its
    state into the cache's own tensors; chunked against recurrent as in
    ``tests/test_models.py``."""
    tcfg, jcfg = R6
    jp, tp = _block(JR6.rwkv6_init, jcfg, dtype, 1)
    rng = np.random.default_rng(4)
    jx, tx = _both(rng.standard_normal((2, 32, 64)).astype(np.float32), dtype)
    for chunked in (True, False):
        jy = J_RWKV_FORWARD(jx, jp, jcfg, chunked=chunked)
        ty = TR6.rwkv6_forward(tx, tp, tcfg, chunked=chunked)
        assert ty.dtype == DTYPES[dtype][1] and _rel_err(jy, ty) <= MODULE_TOL[dtype]
    if dtype == "f32":
        torch.testing.assert_close(TR6.rwkv6_forward(tx, tp, tcfg), TR6.rwkv6_forward(tx, tp, tcfg, chunked=False),
                                   rtol=STEP_TOL, atol=STEP_TOL)
    jc, tc = JR6.rwkv6_cache_init(jcfg, 2), TR6.rwkv6_cache_init(tcfg, 2, device="cpu")
    held = {k: t.data_ptr() for k, t in tc.items()}
    for t in range(4):
        jy, jc = J_RWKV_DECODE(jx[:, t:t + 1], jp, jcfg, jc)
        ty, tc2 = TR6.rwkv6_decode(tx[:, t:t + 1], tp, tcfg, tc)
        assert tc2 is tc and {k: v.data_ptr() for k, v in tc.items()} == held
        assert _rel_err(jy, ty) <= MODULE_TOL[dtype]
        for k in tc:
            assert tc[k].dtype == torch.float32 and _rel_err(jc[k], tc[k]) <= MODULE_TOL[dtype], k


def _ssd_inputs(seed=5, b=2, s=32, h=4, p=32, n=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 2)).astype(np.float32)  # softplus, > 0
    B, C = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    A_log = np.log(np.arange(1, h + 1, dtype=np.float32))
    D = np.ones(h, np.float32)
    return x, dt, A_log, B, C, D


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mamba2_matches_jax(dtype):
    """``ssd_chunked`` (x, B, C, A_log and D in ``dtype``; dt f32, as
    ``mamba2_forward`` hands it), ``mamba2_forward`` and four
    ``mamba2_decode`` steps against JAX's; the decode writes ``ssm`` in
    place; the chunked forward against the stepwise decode."""
    x, dt, A_log, B, C, D = _ssd_inputs()
    j = [_both(a, dtype)[0] for a in (x, A_log, B, C, D)]
    t = [_both(a, dtype)[1] for a in (x, A_log, B, C, D)]
    jy = J_SSD(j[0], jnp.asarray(dt), j[1], j[2], j[3], j[4], 8)
    ty = TM.ssd_chunked(t[0], torch.from_numpy(dt), t[1], t[2], t[3], t[4], 8)
    assert ty.dtype == DTYPES[dtype][1] and _rel_err(jy, ty) <= MODULE_TOL[dtype]
    with pytest.raises(ValueError, match="multiple of the chunk"):
        TM.ssd_chunked(t[0][:, :20], torch.from_numpy(dt)[:, :20], t[1], t[2][:, :20], t[3][:, :20], t[4], 8)
    tcfg, jcfg = M2
    jp, tp = _block(JM.mamba2_init, jcfg, dtype, 2)
    rng = np.random.default_rng(6)
    jx, tx = _both((rng.standard_normal((2, 32, 64)) * 0.3).astype(np.float32), dtype)
    jy, ty = J_MAMBA_FORWARD(jx, jp, jcfg), TM.mamba2_forward(tx, tp, tcfg)
    assert ty.dtype == DTYPES[dtype][1] and _rel_err(jy, ty) <= MODULE_TOL[dtype]
    jc, tc = JM.mamba2_cache_init(jcfg, 2), TM.mamba2_cache_init(tcfg, 2, device="cpu")
    held = tc["ssm"].data_ptr()
    steps = []
    for i in range(32):
        jyi, jc = J_MAMBA_DECODE(jx[:, i:i + 1], jp, jcfg, jc)
        tyi, tc2 = TM.mamba2_decode(tx[:, i:i + 1], tp, tcfg, tc)
        assert tc2 is tc and tc["ssm"].data_ptr() == held
        if i < 4:
            assert _rel_err(jyi, tyi) <= MODULE_TOL[dtype] and _rel_err(jc["ssm"], tc["ssm"]) <= MODULE_TOL[dtype]
        steps.append(tyi)
    if dtype == "f32":
        torch.testing.assert_close(torch.cat(steps, dim=1), ty, rtol=STEP_TOL, atol=STEP_TOL)


def test_mamba2_init_matches_the_reference_distributions():
    """``A_log`` = log(1..H), ``D`` ones, ``dt_bias`` the inverse softplus of
    a dt in [dt_min, dt_max), as the reference draws them."""
    tcfg, jcfg = M2
    tp = TM.mamba2_init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    jp = JM.mamba2_init(jax.random.key(0), jcfg)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {k: v.shape for k, v in jp.items()}
    for k in ("A_log", "D", "norm"):
        assert np.array_equal(tp[k].numpy(), np.asarray(jp[k]))
    dt = torch.nn.functional.softplus(tp["dt_bias"].double())
    assert bool(((dt >= tcfg.dt_min * (1 - 1e-5)) & (dt <= tcfg.dt_max * (1 + 1e-5))).all())


# --------------------------------------------------------------------------- #
# the lm level: configs, params, forward, decode
# --------------------------------------------------------------------------- #
def test_every_reference_arch_resolves():
    """Every id of the reference's registry resolves, full and smoke; an
    unknown id and an unknown family raise."""
    for arch in J_ARCH_IDS:
        assert get_config(arch).name == arch and get_smoke_config(arch).name == arch + "-smoke"
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("mamba-1")
    with pytest.raises(ValueError, match="unknown family"):
        TL.init_cache(dataclasses.replace(get_smoke_config(RWKV), family="rnn"), 1, 4, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    """Every field of the full and the smoke config equal to the
    reference's, the nested RWKV6 / Mamba2 configs field by field."""
    for jget, tget in ((j_config, get_config), (j_smoke, get_smoke_config)):
        jc, tc = jget(arch), tget(arch)
        jf = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc) if f.name != "dtype"}
        tf = {f.name: getattr(tc, f.name) for f in dataclasses.fields(tc) if f.name != "dtype"}
        for k in ("mla", "moe", "ssm", "rwkv"):
            jf[k] = None if jf[k] is None else dataclasses.asdict(jf[k])
            tf[k] = None if tf[k] is None else dataclasses.asdict(tf[k])
        assert jf == tf
        assert (jc.dtype, tc.dtype) == (jnp.bfloat16, torch.bfloat16)


def test_full_width_param_counts():
    """The full-width trees, built on ``meta``, hold the reference's
    parameter counts."""
    for arch in ARCHS:
        lm = get_config(arch)
        n = sum(t.numel() for t in tree_leaves(TL.init_params(torch.Generator(), lm, device="meta")))
        assert n == j_config(arch).n_params(), arch


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_match_the_reference_tree(jparams, arch):
    """The port's own init has the reference's tree (rwkv's (5, d) ``mu``
    in each stacked block, zamba2's unstacked ``shared`` beside the stacked
    ``blocks``), leaf for leaf in shape and dtype, and the JAX params cross
    into the port's layout and back bit for bit."""
    own = TL.params_to_numpy(TL.init_params(torch.Generator().manual_seed(0), get_smoke_config(arch), device="cpu"))
    ref = jax.tree.map(np.asarray, jparams[arch])
    assert jax.tree.structure(own) == jax.tree.structure(ref)
    assert all(a.shape == b.shape and a.dtype == b.dtype for a, b in zip(jax.tree.leaves(own), jax.tree.leaves(ref)))
    port = _port(jparams[arch])
    back = TL.params_to_numpy(port)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)))
    cfg = get_smoke_config(arch)
    assert len(port["blocks"]) == cfg.n_layers
    if arch == RWKV:
        assert tuple(port["blocks"][0]["mu"].shape) == (5, cfg.d_model)
    else:
        assert isinstance(port["shared"], dict) and tuple(port["shared"]["attn"]["wq"].shape) == (64, 64)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(jparams, arch, dtype):
    """``forward`` protected on a faulty array (twopass, one fault repaired,
    two not) against JAX, with the head's stuck-bit room in f32."""
    jc, tc = _cfgs(arch, dtype)
    jb, tb = _batch(jc, s=32)
    jf, tf = _ctxs("twopass_protected", dtype)
    jl, _ = jax.jit(JL.forward, static_argnums=(1,))(jparams[arch], jc, jb, ftc=jf)
    tl, _ = TL.forward(_port(jparams[arch]), tc, tb, ftc=tf)
    assert tl.dtype == DTYPES[dtype][1] and tuple(tl.shape) == jl.shape
    # _ctxs: the DPPU repairs PE(0, 1); PE(1, 2) and PE(2, 3) corrupt
    unrepaired = [(1, 2, FAULT_BITS[dtype][1]), (2, 3, FAULT_BITS[dtype][2])] if dtype == "f32" else ()
    _logits_held(jl, tl, jc.vocab, *LOGIT_TOL[dtype], unrepaired)


@pytest.mark.parametrize("layer_fraction", [1.0, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(jparams, arch, dtype, layer_fraction):
    """Four cached decode steps under a fused protected context with two
    faults past DPPU capacity (f32: on mantissa bits), the protected layer
    prefix at 1.0 and 0.5,
    against JAX: logits and every cache part (rwkv's ``S``, ``x_tm``,
    ``x_cm``; zamba2's ``ssm`` and the shared block's K/V/idx), each cache
    tensor kept at its address."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jcfg = dataclasses.replace(j_smoke(arch), dtype=jdt)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    tparams = TL.cast_params(_port(jparams[arch]), dtype)
    faults = MANTISSA_FAULTS if dtype == torch.float32 else DECODE_FAULTS[dtype]
    jftc, tftc = _contexts(faults, layer_fraction=layer_fraction)
    jcache, tcache = JL.init_cache(jcfg, 3, 8), TL.init_cache(tcfg, 3, 8, device="cpu")
    ptrs = [t.data_ptr() for t in tree_leaves(tcache)]
    rng = np.random.default_rng(1)
    jstep = jax.jit(JL.decode_step, static_argnums=(1,))
    for _ in range(4):
        tok = rng.integers(0, tcfg.vocab, (3, 1)).astype(np.int32)
        jl, jcache = jstep(jparams[arch], jcfg, jcache, {"token": jnp.asarray(tok)}, ftc=jftc)
        tl, tcache2 = TL.decode_step(tparams, tcfg, tcache, {"token": torch.from_numpy(tok)}, ftc=tftc)
        assert tcache2 is tcache and tl.shape == (3, 1, tcfg.padded_vocab) and tl.dtype == dtype
        unrepaired = [f[:3] for f in faults[1:]] if dtype == torch.float32 else ()
        _logits_held(jl, tl, tcfg.vocab, DECODE_TOL[dtype], DECODE_MEAN_TOL[dtype], unrepaired)
    assert [t.data_ptr() for t in tree_leaves(tcache)] == ptrs
    for part, layers in tcache.items():
        for name in layers[0]:
            got = torch.stack([c[name] for c in layers])
            want = np.asarray(jcache[part][name].astype(jnp.float32) if name != "idx" else jcache[part][name])
            if name == "idx":
                assert np.array_equal(got.numpy(), want)
            else:
                # the recurrent states are f32; the shared block's K/V cache is
                # bf16, where two values within DECODE_TOL may round one bf16
                # ulp (at most 2^-7 of the value) apart
                assert got.dtype == (torch.float32 if part != "shared_attn" else torch.bfloat16), (part, name)
                np.testing.assert_allclose(got.float().numpy(), want, atol=DECODE_TOL[dtype],
                                           rtol=2.0**-7 if got.dtype == torch.bfloat16 else 0)


def test_hybrid_is_all_or_nothing(jparams):
    """zamba2 protects every mamba layer and every application of the
    shared block whatever the layer fraction, as the reference does: the
    ledger of a decode step at fraction 0.5 has no plain call and equals the
    JAX one row for row, and forward and decode at 0.5 equal those at 1.0
    bit for bit; rwkv6 at 0.5 splits its stack."""
    for arch in ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
        params = _port(jparams[arch])
        rows = {}
        for frac in (1.0, 0.5):
            ctx = _contexts(DECODE_FAULTS[torch.float32], layer_fraction=frac)[1]
            rows[frac] = trace_site_calls(
                lambda c, p, ch, t: TL.decode_step(p, cfg, ch, {"token": t}, ftc=c), ctx, params,
                TL.init_cache(cfg, 2, 8, device="cpu"), torch.zeros((2, 1), dtype=torch.int32))
        if arch == ZAMBA:
            assert rows[0.5] == rows[1.0] and all(r.protected for r in rows[0.5])
            jcfg = dataclasses.replace(j_smoke(arch), dtype=jnp.float32, unroll=True)
            jctx = _contexts(DECODE_FAULTS[torch.float32], layer_fraction=0.5)[0]
            jrows = _jax_ledger(jparams[arch], jcfg, jctx)
            assert [(r.site, r.m, r.n, r.count, r.dispatch, r.protected) for r in rows[0.5]] == jrows
            _, tb = _batch(cfg, b=1, s=32, seed=2)
            outs = [TL.forward(params, cfg, tb, ftc=_contexts(DECODE_FAULTS[torch.float32], layer_fraction=f)[1])[0]
                    for f in (1.0, 0.5)]
            assert torch.equal(outs[0], outs[1])
        else:  # the unprotected half of the stack records no call: plain matmuls
            def n(rs):
                return sum(r.count for r in rs if r.site == "ssm.in")
            assert n(rows[0.5]) * 2 == n(rows[1.0]) == 6 * cfg.n_layers


def _jax_ledger(jp, jcfg, jctx):
    """The JAX decode step's call ledger, as (site, m, n, count, dispatch,
    protected) rows."""
    cache = JL.init_cache(jcfg, 2, 8)
    led = j_trace(lambda c: JL.decode_step(jp, jcfg, cache, {"token": jnp.zeros((2, 1), jnp.int32)}, ftc=c), jctx)
    return [(r.site, r.m, r.n, r.count, r.dispatch, r.protected) for r in led]


@pytest.mark.parametrize("dispatch", ["twopass", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_protected_equals_off_bitwise(jparams, arch, dispatch):
    """Faults within DPPU capacity move no bit of ``forward`` or of two
    ``decode_step``s (the recurrent state carried); unprotected, the same
    faults change both; off is the plain run within float tolerance."""
    _, tc = _cfgs(arch)
    params = _port(jparams[arch])
    _, tb = _batch(tc, b=1, s=16, seed=4)
    state = _visible_state()
    hy = {m: TE.HyCAConfig(8, 8, TDPPU(size=8, group_size=8), m) for m in ("protected", "unprotected")}
    prot = TF.build_ftcontext(state, hy["protected"], dispatch=dispatch)
    off = prot.with_state(TE.empty_fault_state(state.max_faults))
    bad = TF.build_ftcontext(state, hy["unprotected"], dispatch=dispatch)

    def run(ctx):
        logits, _ = TL.forward(params, tc, tb, ftc=ctx)
        cache = TL.init_cache(tc, 1, 9, dtype=torch.float32, device="cpu")
        for t in range(2):
            step, _ = TL.decode_step(params, tc, cache, {"token": tb["tokens"][:, t:t + 1]}, ftc=ctx)
        return logits, step

    (f_off, d_off), (f_prot, d_prot), (f_bad, d_bad), (f_ref, d_ref) = (run(c) for c in (off, prot, bad, None))
    assert torch.equal(f_prot.view(torch.int32), f_off.view(torch.int32))
    assert torch.equal(d_prot.view(torch.int32), d_off.view(torch.int32))
    assert not torch.equal(f_bad, f_off) and not torch.equal(d_bad, d_off)
    torch.testing.assert_close(f_off, f_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(d_off, d_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """Teacher-forced decode reproduces the port's own chunked forward
    (``tests/test_models.py``'s oracle for the cache path), bf16 weights as
    served: the recurrent state carried token by token against the chunked
    sequence form."""
    cfg = get_smoke_config(arch)
    params = TL.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    _, tb = _batch(cfg, b=2, s=32, seed=6)
    full, _ = TL.forward(params, cfg, tb)
    cache = TL.init_cache(cfg, 2, 33, device="cpu")
    work = TL.cast_params(params, cfg.dtype)
    outs = []
    for t in range(32):
        lg, cache = TL.decode_step(work, cfg, cache, {"token": tb["tokens"][:, t:t + 1]})
        outs.append(lg[:, 0].float())
    dec, ref = torch.stack(outs, dim=1), full.float()
    mask = ref > -1e29
    torch.testing.assert_close(dec[mask], ref[mask], rtol=CONSISTENCY_TOL, atol=CONSISTENCY_TOL)
    if arch == ZAMBA:
        assert all(int(c["idx"][0]) == 32 for c in cache["shared_attn"])


# --------------------------------------------------------------------------- #
# loss and gradients
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,dispatch", [(RWKV, "twopass_protected"), (RWKV, "twopass_unprotected"),
                                           (ZAMBA, "twopass_protected"), (ZAMBA, "twopass_plan")])
def test_loss_and_grads_match_jax(jparams, arch, dispatch):
    """``loss_fn`` and its gradients w.r.t. the f32 masters under the
    two-pass engine on a faulty array, the plan's remap and prune included
    (fused has no gradient: ROADMAP C5; zamba2 unprotected: the docstring above),
    against ``jax.value_and_grad``: the decay LoRA's mixed f32 x bf16 pair,
    ``mu``, ``u``, ``A_log``, ``dt_bias`` and the shared block included."""
    jc, tc = _cfgs(arch)
    jb, tb = _batch(jc, s=32, seed=1)
    jf, tf = _ctxs(dispatch)
    (jloss, _), jg = jax.jit(jax.value_and_grad(lambda p: JL.loss_fn(p, jc, jb, ftc=jf), has_aux=True))(jparams[arch])
    leaves = tree_map(lambda a: a.requires_grad_(), _port(jparams[arch]))
    tloss, _ = TL.loss_fn(leaves, tc, tb, ftc=tf)
    tloss.backward()
    tg = TL.params_to_numpy(tree_map(lambda a: a.grad, leaves))
    assert abs(float(jloss) - float(tloss.detach())) <= LOSS_TOL["f32"] * max(1.0, abs(float(jloss)))
    assert jax.tree.structure(jg) == jax.tree.structure(tg)
    assert _leafwise_max_err(jg, tg) <= GRAD_TOL["f32"]
    learn = tg["blocks"]["w_b"] if arch == RWKV else tg["blocks"]["mamba"]["dt_bias"]
    assert np.abs(learn).max() > 0


# --------------------------------------------------------------------------- #
# serving, the ledger, salience, checkpoints, reset, the train CLI
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_server_matches_jax(jparams, arch):
    """The smoke server, protected with three BIST faults, against the JAX
    server on the same trace and weights in f32: events, summary and every
    token; each new request starts from a zeroed recurrent state."""
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
    tsum = tsrv.run(_trace(tb.lm.vocab), max_steps=64)
    assert [(e.kind, e.step, e.data) for e in tsrv.log.events] == [(e.kind, e.step, e.data) for e in jsrv.log.events]
    volatile = {"wall_s", "tokens_per_s", "host_phase_ms"}
    assert {k: v for k, v in tsum.items() if k not in volatile} == {k: v for k, v in jsum.items() if k not in volatile}
    jt, tt = jsrv.completions_by_rid(), tsrv.completions_by_rid()
    assert jt.keys() == tt.keys() and len(tt) == 6
    assert all(np.array_equal(jt[r], tt[r]) for r in jt)
    assert tsrv.manager.n_confirmed == len(BIST)


@pytest.mark.parametrize("arch", ARCHS)
def test_ledger_matches_jax(jparams, arch):
    """The port's decode-step ledger, recorded on the ``meta`` device (the
    mixed f32 x bf16 ``w_b`` call included), equals the JAX ledger row for
    row: the projections only, never the WKV or SSD recurrence.  zamba2 is
    held to the reference's unrolled ledger: its scanned one counts the
    mamba layers of the first group only, since ``lax.scan`` reuses the
    traced body for the later groups (ROADMAP C7)."""
    kw = dict(arch=arch, mode="off", n_slots=3, smax=16, rows=4, cols=4, dppu_size=2, seed=0, dispatch="fused")
    jb = JBundle(JConfig(counters=True, **kw), lm=dataclasses.replace(j_smoke(arch), unroll=arch == ZAMBA))
    tb = ModelBundle(ServerConfig(device="cpu", **kw), lm=get_smoke_config(arch),
                     params=TL.params_from_numpy(jax.tree.map(np.asarray, jb.params), "cpu"))
    rows = [(c.site, c.m, c.n, c.count, c.dispatch, c.protected) for c in tb.ledger]
    assert rows == [(c.site, c.m, c.n, c.count, c.dispatch, c.protected) for c in jb.ftc.ledger]
    assert {r[0] for r in rows} == ({"ssm.in", "ssm.out", "ffn", "head"} if arch == RWKV
                                    else {"ssm.in", "ssm.out", "attn.qkv", "attn.out", "ffn", "head"})


@pytest.mark.parametrize("arch", ARCHS)
def test_weight_salience_matches_jax(jparams, arch):
    """The salience fold reads the stacked blocks and zamba2's unstacked
    shared block as the reference does: float64 equal."""
    assert np.array_equal(TR.weight_salience(_port(jparams[arch]), 8), JR.weight_salience(jparams[arch], 8))


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_across_packages(jparams, arch, tmp_path):
    """The params written by each package read back bitwise by the other:
    the same leaf names (``blocks__mu`` stacked, ``shared__attn__wq`` not),
    manifests and tree hash."""
    jp, tp = jparams[arch], _port(jparams[arch])
    JS.save(str(tmp_path / "jax"), 1, jp)
    TS.save(str(tmp_path / "port"), 1, tp)
    got = TS.restore(str(tmp_path / "jax"), 1, tp)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(tp)))
    back = JS.restore(str(tmp_path / "port"), 1, jp)
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)))
    manifests = [json.load(open(tmp_path / d / "step_00000001" / "manifest.json")) for d in ("jax", "port")]
    assert manifests[0] == manifests[1]
    names = {n for n, _, _ in manifests[0]["leaves"]}
    assert ("blocks__mu" in names) if arch == RWKV else ("shared__attn__wq" in names and "blocks__mamba__A_log" in names)


@pytest.mark.parametrize("arch", ARCHS)
def test_reset_fn_zeroes_one_slot_of_every_cache_part(arch):
    """rwkv's ``S``, ``x_tm``, ``x_cm`` and zamba2's ``ssm`` and shared
    K/V/idx lose slot 1, on their batch axis, and nothing else, in place."""
    bundle = ModelBundle(ServerConfig(arch=arch, device="cpu", **BASE), lm=get_smoke_config(arch))
    cache = bundle.fresh_cache()
    assert set(cache) == ({"rwkv"} if arch == RWKV else {"mamba", "shared_attn"})
    ptrs = [t.data_ptr() for t in tree_leaves(cache)]
    for t in tree_leaves(cache):
        t.fill_(1)
    assert bundle.reset_fn(cache, 1) is cache
    assert [t.data_ptr() for t in tree_leaves(cache)] == ptrs
    for t in tree_leaves(cache):
        assert t.shape[0] == 4 and not t[1].any() and bool((t[[0, 2, 3]] == 1).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_the_recurrent_families(tmp_path, arch):
    """The training CLI at smoke size: protected twopass steps with a
    checkpoint, finite params."""
    state = TT.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2", "--seq", "32", "--steps", "2",
                     "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2", "--hyca-mode", "protected"])
    assert int(state["opt"]["step"]) == 2
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(state["params"]))
