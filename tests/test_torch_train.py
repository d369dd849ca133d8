"""The port's sequence forward, losses, optimizer and train step held against
the JAX package, with no mesh (the reference's mesh path is red: ROADMAP C2).

The JAX params (``init_params`` from a fixed key) reach the port through
numpy; gradients and updated params come back through
``params_to_numpy``, which restacks the layer lists, and are compared leaf
for leaf.  Inputs are made with numpy from seeds.

Tolerances.  In f32 (``LMConfig.dtype``) the two frameworks differ only by
summation order and libm rounding: logits and losses within 2e-5, each
gradient leaf within 1e-4 of its largest entry.  AdamW divides each
gradient by its own running magnitude, so an entry whose gradient is near
zero carries the frameworks' rounding difference into its step at a large
relative size: updated params are held within lr / 100.  In bf16 every op rounds to 8
mantissa bits and the two round at different places: logits within 2^-3
(mean 2^-6), the loss within 2e-2 and each gradient leaf within 0.1 of its
largest entry.  Faults sit on mantissa bits (f32: 20-22, bf16: 16-18), so
a stuck bit moves a value by a bounded amount and both sides stay finite
(a stuck exponent bit turns a one-ulp difference into a jump of the
value's size; ROADMAP C).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke_config as j_smoke
from repro.core import engine as JE
from repro.core.ftcontext import ProtectPolicy as JPolicy
from repro.core.ftcontext import build_ftcontext as j_build
from repro.core.redundancy import DPPUConfig as JDPPU
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import attention as JA
from repro.models import layers as JLay
from repro.models import lm as JL
from repro.optim import adamw as JO
from repro.optim import compression as JCmp
from repro.optim import schedules as JS
from repro.repair.retrain import RetrainConfig as JRetrainConfig
from repro.repair.retrain import _path_str
from repro.repair.retrain import grad_mask as j_grad_mask
from repro_torch.configs import get_smoke_config
from repro_torch.core import engine as TE
from repro_torch.core.ftcontext import ProtectPolicy, build_ftcontext
from repro_torch.core.redundancy import DPPUConfig as TDPPU
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as TT
from repro_torch.models import attention as TA
from repro_torch.models import layers as TLay
from repro_torch.models import lm as TL
from repro_torch.optim import adamw as TO
from repro_torch.optim import compression as TCmp
from repro_torch.optim import schedules as TS
from repro_torch.repair.retrain import RetrainConfig, grad_mask
from repro_torch.tree import tree_map

FAMILIES = {"dense": "qwen1.5-0.5b", "moe": "granite-moe-3b-a800m"}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
ROWS = COLS = 4
FAULT_BITS = {"f32": (22, 21, 20), "bf16": (18, 17, 16)}
# protected: the DPPU (capacity 1) repairs PE(0, 1); the other two corrupt
DISPATCHES = {
    "plain": ("protected", "plain", False),
    "twopass_protected": ("protected", "twopass", False),
    "twopass_unprotected": ("unprotected", "twopass", False),
    "twopass_plan": ("protected", "twopass", True),
}
LOGIT_TOL = {"f32": (2e-5, 2e-5), "bf16": (2.0**-3, 2.0**-6)}  # (max, mean)
LOSS_TOL = {"f32": 2e-5, "bf16": 2e-2}
GRAD_TOL = {"f32": 1e-4, "bf16": 0.1}  # of each leaf's largest |gradient|
PARAM_TOL = 1e-2  # of the learning rate, after AdamW steps


@pytest.fixture(scope="module")
def jparams():
    return {fam: JL.init_params(jax.random.key(0), j_smoke(arch)) for fam, arch in FAMILIES.items()}


def _cfgs(family, dtype="f32", **kw):
    jdt, tdt = DTYPES[dtype]
    arch = FAMILIES[family]
    return (dataclasses.replace(j_smoke(arch), dtype=jdt, **kw),
            dataclasses.replace(get_smoke_config(arch), dtype=tdt, **kw))


def _port(jp):
    return TL.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _batch(vocab, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels[0, :3] = -1  # masked positions
    return ({"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)})


def _ctxs(dispatch, dtype="f32"):
    """The same faulty array as a JAX and a port FTContext."""
    mode, disp, with_plan = DISPATCHES[dispatch]
    coords = [(0, 1), (1, 2), (2, 3)]
    fmap = np.zeros((ROWS, COLS), bool)
    for r, c in coords:
        fmap[r, c] = True
    js = JE.fault_state_from_map(fmap, max_faults=8)
    fpt = np.asarray(js.fpt)
    bits = np.zeros(8, np.int32)
    vals = np.zeros(8, np.int32)
    for i, (r, c) in enumerate(fpt[:3]):
        k = coords.index((int(r), int(c)))
        bits[i], vals[i] = FAULT_BITS[dtype][k], k % 2
    jst = JE.FaultState(jnp.asarray(fpt), jnp.asarray(bits), jnp.asarray(vals))
    tst = TE.FaultState(torch.from_numpy(fpt.copy()), torch.from_numpy(bits), torch.from_numpy(vals))
    jh = JE.HyCAConfig(ROWS, COLS, JDPPU(size=1, group_size=1), mode)
    th = TE.HyCAConfig(ROWS, COLS, TDPPU(size=1, group_size=1), mode)
    jp = tp = None
    if with_plan:
        col_map = np.array([2, 0, 3, 1], np.int32)
        prune = np.zeros((ROWS, COLS), bool)
        prune[1, 3] = prune[2, 0] = True
        jp = JE.RepairPlan(jnp.asarray(col_map), jnp.asarray(prune))
        tp = TE.RepairPlan(torch.from_numpy(col_map), torch.from_numpy(prune))
    return (j_build(jst, jh, dispatch=disp, plan=jp, policy=JPolicy()),
            build_ftcontext(tst, th, dispatch=disp, plan=tp, policy=ProtectPolicy()))


def _leafwise_max_err(jtree, ttree_np):
    """max over leaves of |Δ| / max(|reference leaf|)."""
    errs = jax.tree.map(lambda a, b: float(np.abs(np.asarray(a, np.float32) - b).max()
                                           / max(float(np.abs(np.asarray(a, np.float32)).max()), 1e-30)),
                        jtree, ttree_np)
    return max(jax.tree.leaves(errs))


# --------------------------------------------------------------------------- #
# forward, attention, losses
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("last_only", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_logits_match_jax(jparams, family, dtype, last_only):
    jc, tc = _cfgs(family, dtype)
    jb, tb = _batch(jc.vocab)
    jl, ja = JL.forward(jparams[family], jc, jb, last_only=last_only)
    tl, ta = TL.forward(_port(jparams[family]), tc, tb, last_only=last_only)
    assert tl.dtype == DTYPES[dtype][1] and tuple(tl.shape) == jl.shape
    d = np.abs(np.asarray(jl.astype(jnp.float32))[..., :jc.vocab] - tl.float().numpy()[..., :jc.vocab])
    tol, mean_tol = LOGIT_TOL[dtype]
    assert d.max() <= tol and d.mean() <= mean_tol, (d.max(), d.mean())
    assert np.all(tl.float().numpy()[..., jc.vocab:] <= -1e29)  # padded rows masked
    assert abs(float(ja) - float(ta)) <= 1e-5 * max(1.0, abs(float(ja)))


@pytest.mark.parametrize("q_block", [4, 8, 16])
def test_blockwise_causal_attention_matches_jax(q_block):
    """Query blocks smaller than the sequence: each block sees the whole K/V
    panel under the causal mask, in f32; GQA with 2 query heads a group."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 16, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    want = np.asarray(JA.blockwise_causal_attention(*(jnp.asarray(a) for a in (q, k, v)), 2, q_block))
    got = TA.blockwise_causal_attention(*(torch.from_numpy(a) for a in (q, k, v)), 2, q_block).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)
    with pytest.raises(ValueError, match="multiple of the query block"):
        TA.blockwise_causal_attention(*(torch.from_numpy(a) for a in (q, k, v)), 2, 6)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 5, 40)).astype(np.float32) * 3
    labels = rng.integers(0, 40, (3, 5)).astype(np.int32)
    labels[1, 2:] = -1
    want = float(JLay.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    lt = torch.from_numpy(logits).requires_grad_()
    got = TLay.cross_entropy(lt, torch.from_numpy(labels))
    assert abs(float(got) - want) <= 1e-6 * abs(want)
    jg = np.asarray(jax.grad(lambda a: JLay.cross_entropy(a, jnp.asarray(labels)))(jnp.asarray(logits)))
    got.backward()
    np.testing.assert_allclose(lt.grad.numpy(), jg, atol=1e-7)
    assert not lt.grad.numpy()[1, 2:].any()  # masked labels carry no gradient
    allmasked = torch.full((3, 5), -1, dtype=torch.int32)
    assert float(TLay.cross_entropy(torch.from_numpy(logits), allmasked)) == 0.0


@pytest.mark.parametrize("dispatch", [None, "twopass_protected", "twopass_unprotected"])
def test_streamed_cross_entropy_matches_jax(dispatch):
    """Vocab chunks with padded rows; on the fault path the label logit comes
    from the corrupted chunk panel.  Value and gradients against JAX."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 16)).astype(np.float32)
    table = (rng.standard_normal((64, 16)) * 0.3).astype(np.float32)
    labels = rng.integers(0, 60, (2, 6)).astype(np.int32)
    labels[0, 0] = -1
    jf, tf = _ctxs(dispatch) if dispatch else (None, None)

    def jloss(a, t):
        return JLay.streamed_cross_entropy(a, t, jnp.asarray(labels), 4, 60, ftc=jf)

    want, (jgx, jgt) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(table))
    xt, tt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(table).requires_grad_()
    got = TLay.streamed_cross_entropy(xt, tt, torch.from_numpy(labels), 4, 60, ftc=tf)
    got.backward()
    assert abs(float(got) - float(want)) <= 2e-6 * abs(float(want))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=1e-6)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jgt), atol=1e-6)
    # the chunked NLL is the dense one's
    dense = np.asarray(jnp.asarray(x) @ jnp.asarray(table).T).copy()
    dense[..., 60:] = -1e30
    if dispatch is None:
        assert abs(float(got) - float(JLay.cross_entropy(jnp.asarray(dense), jnp.asarray(labels)))) <= 1e-5
    if dispatch == "twopass_unprotected":  # the faults move the loss
        plain = TLay.streamed_cross_entropy(torch.from_numpy(x), torch.from_numpy(table),
                                            torch.from_numpy(labels), 4, 60)
        assert float(plain) != float(got)


# --------------------------------------------------------------------------- #
# loss_fn and its gradients
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("dispatch", sorted(DISPATCHES))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_grads_match_jax(jparams, family, dispatch, dtype):
    """``loss_fn`` and its gradients w.r.t. the f32 masters, against
    ``jax.value_and_grad(loss_fn)``: the masters are cast inside the
    differentiated function on both sides."""
    jc, tc = _cfgs(family, dtype)
    jb, tb = _batch(jc.vocab, seed=1)
    jf, tf = _ctxs(dispatch, dtype)
    (jloss, jm), jg = jax.value_and_grad(lambda p: JL.loss_fn(p, jc, jb, ftc=jf), has_aux=True)(jparams[family])
    leaves = tree_map(lambda a: a.requires_grad_(), _port(jparams[family]))
    tloss, tm = TL.loss_fn(leaves, tc, tb, ftc=tf)
    tloss.backward()
    tg = TL.params_to_numpy(tree_map(lambda a: a.grad, leaves))
    assert abs(float(jloss) - float(tloss)) <= LOSS_TOL[dtype] * max(1.0, abs(float(jloss)))
    assert abs(float(jm["aux"]) - float(tm["aux"])) <= LOSS_TOL[dtype] * max(1.0, abs(float(jm["aux"])))
    assert jax.tree.structure(jg) == jax.tree.structure(tg)
    err = _leafwise_max_err(jg, tg)
    assert err <= GRAD_TOL[dtype], err
    if family == "moe":  # the router learns through the gates, as in the reference
        assert np.abs(tg["blocks"]["moe"]["router"]).max() > 0


def test_protected_within_capacity_trains_as_off(jparams):
    """Faults the DPPU repairs move neither the loss nor any gradient bit:
    the two-pass engine with an empty fault table and with one repaired
    fault give the same loss and gradients, bit for bit."""
    jc, tc = _cfgs("dense")
    _, tb = _batch(jc.vocab, seed=2)
    hy = TE.HyCAConfig(ROWS, COLS, TDPPU(size=1, group_size=1), "protected")
    fpt = torch.tensor([[0, 1], [-1, -1]], dtype=torch.int32)
    one = TE.FaultState(fpt, torch.tensor([30, 0], dtype=torch.int32), torch.tensor([1, 0], dtype=torch.int32))
    out = []
    for st in (TE.empty_fault_state(2), one):
        leaves = tree_map(lambda a: a.requires_grad_(), _port(jparams["dense"]))
        loss, _ = TL.loss_fn(leaves, tc, tb, ftc=build_ftcontext(st, hy, dispatch="twopass"))
        loss.backward()
        out.append((loss.detach(), [a.grad for a in TO.tree_leaves(leaves)]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


class _CountMatmuls(TorchDispatchMode):
    """Counts the 2-D matmuls (aten.mm, aten.addmm) dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_on_equals_off(jparams, family):
    """Per-layer ``torch.utils.checkpoint`` recomputes exactly what it
    dropped: loss and gradients bitwise equal with remat off, on with
    ``remat_policy="full"`` and on with ``"dots"`` (the matmul outputs kept,
    the rest recomputed).  The backward of ``"full"`` recomputes the
    forward's 2-D matmuls, that of ``"dots"`` none of them."""
    _, tc = _cfgs(family)
    _, tb = _batch(tc.vocab, seed=3)
    _, tf = _ctxs("twopass_unprotected")
    out, backward_mms = [], []
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        leaves = tree_map(lambda a: a.requires_grad_(), _port(jparams[family]))
        loss, _ = TL.loss_fn(leaves, dataclasses.replace(tc, remat=remat, remat_policy=policy), tb, ftc=tf)
        with _CountMatmuls() as count:
            loss.backward()
        backward_mms.append(count.n)
        out.append((loss.detach(), [a.grad for a in TO.tree_leaves(leaves)]))
    for loss, grads in out[1:]:
        assert torch.equal(out[0][0], loss)
        assert all(torch.equal(a, b) for a, b in zip(out[0][1], grads))
    plain, full, dots = backward_mms
    assert full > plain and dots == plain, backward_mms
    with pytest.raises(ValueError, match="remat_policy"):
        TL.loss_fn(_port(jparams[family]), dataclasses.replace(tc, remat=True, remat_policy="none"), tb)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_dots_matches_jax(jparams, family):
    """``remat_policy="dots"`` (``jax.checkpoint_dots_with_no_batch_dims`` in
    the reference): loss and gradients against ``jax.value_and_grad`` of the
    reference under the same policy, within the f32 tolerances."""
    jc, tc = _cfgs(family, remat=True, remat_policy="dots")
    jb, tb = _batch(jc.vocab, seed=5)
    jf, tf = _ctxs("twopass_protected")
    (jloss, _), jg = jax.value_and_grad(lambda p: JL.loss_fn(p, jc, jb, ftc=jf), has_aux=True)(jparams[family])
    leaves = tree_map(lambda a: a.requires_grad_(), _port(jparams[family]))
    tloss, _ = TL.loss_fn(leaves, tc, tb, ftc=tf)
    tloss.backward()
    assert abs(float(jloss) - float(tloss.detach())) <= LOSS_TOL["f32"] * max(1.0, abs(float(jloss)))
    assert _leafwise_max_err(jg, TL.params_to_numpy(tree_map(lambda a: a.grad, leaves))) <= GRAD_TOL["f32"]


def test_streamed_loss_fn_matches_jax(jparams):
    """``loss_chunks``: the NLL streams over vocab chunks of the tied table,
    under the twopass context that protects the head."""
    jc, tc = _cfgs("dense", loss_chunks=4)
    jb, tb = _batch(jc.vocab, seed=4)
    jf, tf = _ctxs("twopass_unprotected")
    (jloss, _), jg = jax.value_and_grad(lambda p: JL.loss_fn(p, jc, jb, ftc=jf), has_aux=True)(jparams["dense"])
    leaves = tree_map(lambda a: a.requires_grad_(), _port(jparams["dense"]))
    tloss, _ = TL.loss_fn(leaves, tc, tb, ftc=tf)
    tloss.backward()
    assert abs(float(jloss) - float(tloss)) <= LOSS_TOL["f32"] * abs(float(jloss))
    assert _leafwise_max_err(jg, TL.params_to_numpy(tree_map(lambda a: a.grad, leaves))) <= GRAD_TOL["f32"]


def test_params_to_numpy_inverts_params_from_numpy(jparams):
    for fam in FAMILIES:
        tree = jax.tree.map(np.asarray, jparams[fam])
        back = TL.params_to_numpy(TL.params_from_numpy(tree, "cpu"))
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)))


# --------------------------------------------------------------------------- #
# optimizer, schedule, compression, data
# --------------------------------------------------------------------------- #
def test_cosine_warmup_matches_jax():
    for step in (0, 1, 3, 10, 50, 200, 2000):
        for warmup in (0, 1, 10):
            want = float(JS.cosine_warmup(step, peak_lr=1e-3, warmup=warmup, total=100))
            got = float(TS.cosine_warmup(torch.tensor(step, dtype=torch.int32), peak_lr=1e-3,
                                         warmup=warmup, total=100))
            assert abs(got - want) <= 1e-7 * max(want, 1e-3), (step, warmup, got, want)


def test_compress_matches_jax(jparams):
    """Top-k with error feedback, the threshold taken over the reference's
    stacked leaves (every layer of a ``blocks`` leaf at once); ties kept."""
    tree = jax.tree.map(np.asarray, jparams["moe"])
    rng = np.random.default_rng(6)
    grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
    grads["final_norm"][:] = 0.5  # all tied: every entry is kept
    ef = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.1).astype(np.float32), tree)
    ef["final_norm"][:] = 0.0
    js, je, jk = JCmp.compress(jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, ef), 0.1)
    ts, te, tk = TCmp.compress(TL.params_from_numpy(grads, "cpu"), TL.params_from_numpy(ef, "cpu"), 0.1)
    for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(TL.params_to_numpy(ts))):
        assert np.array_equal(np.asarray(a), b)
    for a, b in zip(jax.tree.leaves(je), jax.tree.leaves(TL.params_to_numpy(te))):
        assert np.array_equal(np.asarray(a), b)
    assert abs(float(jk) - float(tk)) <= 1e-6
    assert np.all(TL.params_to_numpy(ts)["final_norm"] == 0.5)
    assert TCmp.compressed_bytes(ts, 0.1) == JCmp.compressed_bytes(js, 0.1)


def test_adamw_update_matches_jax(jparams):
    tree = jax.tree.map(np.asarray, jparams["dense"])
    rng = np.random.default_rng(7)
    grads = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 3).astype(np.float32), tree)
    cfg = JO.AdamWConfig(lr=1e-3)
    jst = JO.adamw_init(jparams["dense"])
    tp = TL.params_from_numpy(tree, "cpu")
    tst = TO.adamw_init(tp)
    jnew, jst2 = JO.adamw_update(jax.tree.map(jnp.asarray, grads), jst, jparams["dense"], cfg, 1e-3)
    tnew, tst2 = TO.adamw_update(TL.params_from_numpy(grads, "cpu"), tst, tp, TO.AdamWConfig(lr=1e-3), 1e-3)
    assert abs(float(jst2["gnorm"]) - float(tst2["gnorm"])) <= 1e-6 * float(jst2["gnorm"])
    assert int(tst2["step"]) == 1 and tst2["step"].dtype == torch.int32
    for a, b in zip(jax.tree.leaves((jnew, jst2["m"], jst2["v"])),
                    jax.tree.leaves(tuple(TL.params_to_numpy(t) for t in (tnew, tst2["m"], tst2["v"])))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_synthetic_lm_batches_bitwise(family):
    jc, tc = _cfgs(family)
    for seed, batch, seq, step in ((0, 8, 16, 0), (3, 4, 32, 5)):
        jd = JSyntheticLM(JDataConfig(seed=seed, batch=batch, seq_len=seq), jc)
        td = SyntheticLM(DataConfig(seed=seed, batch=batch, seq_len=seq), tc)
        a, b = jd.batch(step), td.batch(step)
        assert a.keys() == b.keys()
        assert all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


# --------------------------------------------------------------------------- #
# the train step
# --------------------------------------------------------------------------- #
def _jax_step(params, opt, ef, batch, cfg, tc, ftc, mask):
    """The reference train step composed from its parts, with no mesh."""
    micro = jax.tree.map(lambda x: x.reshape(tc.n_micro, -1, *x.shape[1:]), batch)
    fwd = jax.tree.map(lambda a: a.astype(cfg.dtype), params) if tc.cast_once else params
    gsum = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
    lsum = jnp.zeros(())
    for i in range(tc.n_micro):
        mb = jax.tree.map(lambda a: a[i], micro)
        (_, m), g = jax.value_and_grad(lambda p: JL.loss_fn(p, cfg, mb, aux_weight=tc.aux_weight, ftc=ftc),
                                       has_aux=True)(fwd)
        gsum = jax.tree.map(lambda a, b: a + b.astype(jnp.float32), gsum, g)
        lsum = lsum + m["loss"]
    grads = jax.tree.map(lambda g: g / tc.n_micro, gsum)
    if mask is not None:
        grads = jax.tree.map(lambda g, m: g * m, grads, mask)
    if tc.grad_compress_ratio:
        grads, ef, _ = JCmp.compress(grads, ef, tc.grad_compress_ratio)
    lr = JS.cosine_warmup(opt["step"], peak_lr=tc.opt.lr, warmup=tc.warmup, total=tc.total_steps)
    new, opt = JO.adamw_update(grads, opt, params, JO.AdamWConfig(lr=tc.opt.lr), lr)
    if mask is not None:
        new = jax.tree.map(lambda a, b, m: jnp.where(m > 0, a, b), new, params, mask)
    return new, opt, ef, {"loss": lsum / tc.n_micro, "lr": lr, "gnorm": opt["gnorm"]}


STEP_CASES = {
    "plain_off": dict(dispatch=None, n_micro=1),
    "twopass_protected_micro2": dict(dispatch="twopass_protected", n_micro=2),
    "twopass_unprotected_cast_once": dict(dispatch="twopass_unprotected", n_micro=2, cast_once=True),
    "plan_grad_mask_compress": dict(dispatch="twopass_plan", n_micro=1, mask=True, compress=0.25),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_step_matches_composed_jax_step(jparams, family, case):
    """Two port train steps against two reference steps composed from
    ``loss_fn``, ``adamw_update``, ``cosine_warmup``, ``grad_mask`` and
    ``compress``: params, moments, error feedback and metrics.  The first
    step runs at lr 0 (warmup 1), the second at the peak."""
    spec = STEP_CASES[case]
    jc, tc_ = _cfgs(family)
    jf, tf = _ctxs(spec["dispatch"]) if spec["dispatch"] else (None, None)
    mode = "off" if tf is None else tf.hyca.mode
    tcfg = TT.TrainConfig(n_micro=spec["n_micro"], opt=TO.AdamWConfig(lr=1e-2), warmup=1, total_steps=10,
                          grad_compress_ratio=spec.get("compress", 0.0), hyca_mode=mode,
                          hyca_dispatch=tf.dispatch if tf else "twopass", cast_once=spec.get("cast_once", False))
    rc = RetrainConfig(trainable=("ffn", "moe/up"), layer_range=(1, 2))
    jmask = (j_grad_mask(jparams[family], JRetrainConfig(trainable=rc.trainable, layer_range=rc.layer_range))
             if spec.get("mask") else None)
    tp = _port(jparams[family])
    tmask = grad_mask(tp, rc) if spec.get("mask") else None
    state = {"params": tp, "opt": TO.adamw_init(tp)}
    if tcfg.grad_compress_ratio:
        state["ef"] = TCmp.ef_init(tp)
    hyca = tf.hyca if tf else None
    step = TT.make_train_step(tc_, tcfg, hyca=hyca, plan=tf.plan if tf else None, grad_mask=tmask)
    jp_, jopt, jef = jparams[family], JO.adamw_init(jparams[family]), JCmp.ef_init(jparams[family])
    for i in range(2):
        jb, tb = _batch(jc.vocab, b=4, s=8, seed=10 + i)
        jp_, jopt, jef, jm = _jax_step(jp_, jopt, jef, jb, jc, tcfg, jf, jmask)
        state, tm = step(state, tb, tf.state if tf else None)
        assert abs(float(jm["loss"]) - float(tm["loss"])) <= LOSS_TOL["f32"] * float(jm["loss"])
        assert abs(float(jm["lr"]) - float(tm["lr"])) <= 1e-9
        assert abs(float(jm["gnorm"]) - float(tm["gnorm"])) <= 1e-4 * float(jm["gnorm"])
    assert float(tm["lr"]) == pytest.approx(1e-2)
    got = TL.params_to_numpy(state["params"])
    for a, b in zip(jax.tree.leaves(jp_), jax.tree.leaves(got)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=PARAM_TOL * tcfg.opt.lr)
    for key in ("m", "v"):
        assert _leafwise_max_err(jopt[key], TL.params_to_numpy(state["opt"][key])) <= GRAD_TOL["f32"]
    assert int(state["opt"]["step"]) == 2
    # the step left the state it was given as it was
    assert all(np.array_equal(a, np.asarray(b)) for a, b in
               zip(jax.tree.leaves(TL.params_to_numpy(tp)), jax.tree.leaves(jparams[family])))
    if tmask is not None:  # frozen leaves bit for bit, trainable ones moved
        orig = jax.tree.map(np.asarray, jparams[family])
        flat = jax.tree_util.tree_flatten_with_path(orig)[0]
        moved = dict(zip((_path_str(p) for p, _ in flat), jax.tree.leaves(got)))
        for path, leaf in flat:
            name = _path_str(path)
            trainable = ("ffn" in name or "moe/up" in name) and name.startswith("blocks")
            if trainable:
                assert np.array_equal(moved[name][0], leaf[0]) and not np.array_equal(moved[name][1], leaf[1])
            else:
                assert np.array_equal(moved[name], leaf), name
    if tcfg.grad_compress_ratio:
        assert _leafwise_max_err(jef, TL.params_to_numpy(state["ef"])) <= GRAD_TOL["f32"]


def test_grad_mask_matches_jax(jparams):
    rc = RetrainConfig(trainable=("ffn",), layer_range=(1, 2))
    jm = jax.tree.map(np.asarray, j_grad_mask(jparams["dense"], JRetrainConfig(trainable=("ffn",),
                                                                               layer_range=(1, 2))))
    tm = grad_mask(_port(jparams["dense"]), rc)
    # the port's per-layer masks, stacked, broadcast to the reference's
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jm)[0],
                            jax.tree.leaves(TL.params_to_numpy(tm))):
        stacked = _path_str(path).startswith("blocks")
        assert b.shape == ((len(tm["blocks"]),) if stacked else ()) + (1,) * (a.ndim - stacked)
        assert np.array_equal(np.broadcast_to(a, b.shape), b), _path_str(path)


def test_fused_training_is_refused():
    """C5: the fused epilogue works on bit patterns and carries no gradient,
    so a fused protected or unprotected train step is refused; plain and
    twopass build."""
    _, tc = _cfgs("dense")
    for mode in ("protected", "unprotected"):
        with pytest.raises(ValueError, match="C5"):
            TT.make_train_step(tc, TT.TrainConfig(hyca_mode=mode, hyca_dispatch="fused"))
    TT.make_train_step(tc, TT.TrainConfig(hyca_mode="off", hyca_dispatch="fused"))
    TT.make_train_step(tc, TT.TrainConfig(hyca_mode="protected", hyca_dispatch="twopass"))


def test_reference_fused_dispatch_has_no_gradient():
    """C5 on the reference side: on its ``ref`` fused backend (the one it
    picks off a TPU) ``jax.grad`` through ``FTContext.matmul`` is zero,
    because ``apply_fault_epilogue`` bitcasts every output; on the Pallas
    backend the kernel cannot be transposed."""
    jf, _ = _ctxs("twopass_protected")
    fused = dataclasses.replace(jf, dispatch="fused")
    assert fused.fused_backend == "ref"
    rng = np.random.default_rng(8)
    x = jnp.asarray(rng.standard_normal((8, 16)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((16, 8)), jnp.float32)
    g = jax.grad(lambda a: fused.matmul(a, w, site="ffn").sum())(x)
    assert not np.any(np.asarray(g))
    g2 = jax.grad(lambda a: jf.matmul(a, w, site="ffn").sum())(x)
    assert np.any(np.asarray(g2))
    interpret = dataclasses.replace(fused, fused_backend="interpret")
    with pytest.raises(Exception):
        jax.grad(lambda a: interpret.matmul(a, w, site="ffn").sum())(x)


def test_train_cli_runs_and_resumes(tmp_path, monkeypatch):
    """``python -m repro_torch.launch.train`` on the CPU: protected twopass
    steps, a checkpoint every 2 steps, a resume that continues from the last
    one, and the metrics artifacts."""
    ckpt = tmp_path / "ckpt"
    out = tmp_path / "m.jsonl"
    args = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "8", "--ckpt-dir", str(ckpt),
            "--ckpt-every", "2", "--hyca-mode", "protected", "--metrics-out", str(out)]
    TT.main(args + ["--steps", "2"])
    from repro_torch.checkpoint.store import latest_step

    assert latest_step(str(ckpt)) == 2 and out.exists() and (tmp_path / "m.jsonl.prom").exists()
    state = TT.main(args + ["--steps", "4"])
    assert latest_step(str(ckpt)) == 4 and int(state["opt"]["step"]) == 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TT.main(["--smoke", "--steps", "1"])  # the default device is the card
