"""Where a bundle's params live: the f32 masters on the host, the working
copies on the device.

``ModelBundle`` draws its params piece by piece on the device
(``init_params(..., block_fn=...)``) and hands each f32 piece to the host
as soon as it is drawn, keeping a cast copy on the device: the streamed
init must equal ``init_params`` followed by ``cast_params`` bit for bit.
The masters' readers take them where they need them: the retrain hook
fine-tunes on the bundle's device and keeps the repaired masters on the
host; the remap salience streams each layer stack's column norms and must
equal the stacked norms and the reference's ``weight_salience`` bit for
bit.  Full-width deepseek-moe-16b is the model that forced the rule: its
working copies fit the card, masters and copies together do not, and its
retrain repair is refused before anything is allocated.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import lm as JL
from repro.repair import remap as JRemap
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch import hw
from repro_torch.models import lm as TL
from repro_torch.repair import remap as TRemap
from repro_torch.serving import FaultInjector, FaultTolerantServer, ModelBundle, ServerConfig
from repro_torch.serving import server as TS
from repro_torch.tree import STACKED, pick, stacked_leaves, tree_leaves

DEEPSEEK = "deepseek-moe-16b"
SERVE = dict(device="cpu", dispatch="fused", n_slots=4, smax=32, rows=8, cols=8, dppu_size=4, seed=0)
# six faults at step 2: the DPPU (4) repairs four columns, two are remapped
SIX = [(0, 1, 30, 1), (1, 2, 29, 0), (2, 3, 30, 1), (3, 4, 28, 1), (0, 6, 30, 1), (1, 7, 29, 1)]


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape or a.device != b.device:
        return False
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return torch.equal(a.view(ints), b.view(ints))
    return torch.equal(a, b)


def _pieces(lm) -> int:
    """The pieces ``init_params`` draws one at a time: every top-level entry
    but a layer stack, and every layer of a stack."""
    params = TL.init_params(torch.Generator(), lm, device="meta")
    return sum(len(v) if k in STACKED else 1 for k, v in params.items())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_streamed_init_equals_init_then_cast(arch, dtype):
    """The bundle's streamed init (each piece handed on as it is drawn: the
    f32 leaf to the host, a cast copy on the device) draws what
    ``init_params`` draws: its masters are ``init_params``'s leaves and its
    working copies ``cast_params``'s, bit for bit, in every family and both
    working dtypes; ``block_fn`` sees each piece once."""
    lm = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    want = TL.init_params(torch.Generator().manual_seed(5), lm)
    want_work = TL.cast_params(want, dtype)
    seen = []
    split = TS._host_and_work(dtype)
    pairs = TL.init_params(torch.Generator().manual_seed(5), lm, block_fn=lambda p: seen.append(p) or split(p))
    assert len(seen) == _pieces(lm)
    bundle = ModelBundle(ServerConfig(arch=arch, **dict(SERVE, seed=5)), lm=lm)
    for masters, work in ((pick(pairs, 0), pick(pairs, 1)), (bundle.params, bundle.work)):
        assert len(tree_leaves(masters)) == len(tree_leaves(want))
        assert all(_bits_equal(a, b) for a, b in zip(tree_leaves(masters), tree_leaves(want)))
        assert all(_bits_equal(a, b) for a, b in zip(tree_leaves(work), tree_leaves(want_work)))
        assert all(a.dtype == dtype for a in tree_leaves(work) if a.is_floating_point())


def test_bundle_keeps_masters_on_the_host_and_work_on_its_device():
    """Drawn or handed in, the masters are f32 on the host and the working
    copies in the model's dtype on the bundle's device; params handed in
    are cast from where they are, and a server starts on the bundle's."""
    lm = get_smoke_config("granite-moe-3b-a800m")
    assert lm.dtype == torch.bfloat16
    drawn = ModelBundle(ServerConfig(arch=lm.name, **SERVE), lm=lm)
    given = ModelBundle(ServerConfig(arch=lm.name, **SERVE), lm=lm,
                        params=TL.params_from_numpy(TL.params_to_numpy(drawn.params), "cpu"))
    for b in (drawn, given):
        assert all(a.device == TS.HOST and a.dtype == torch.float32 for a in tree_leaves(b.params))
        assert all(a.device == b.device and a.dtype == lm.dtype for a in tree_leaves(b.work))
        assert b.master_bytes == 4 * lm.n_params()
    assert all(_bits_equal(a, c) for a, c in zip(tree_leaves(drawn.work), tree_leaves(given.work)))
    srv = FaultTolerantServer(ServerConfig(arch=lm.name, mode="off", **SERVE), bundle=drawn)
    assert srv.master_params is drawn.params and srv.params is drawn.work


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_retrain_hook_fine_tunes_on_the_bundle_device(monkeypatch, dtype):
    """``repair="retrain"``: the hook hands ``retrain`` the masters on the
    bundle's device (a spy reads their device), keeps the repaired masters
    f32 on the host, and its working copies are cast on the device in the
    model's dtype; the bundle's masters are untouched."""
    lm = dataclasses.replace(get_smoke_config("qwen1.5-0.5b"), dtype=dtype)
    bundle = ModelBundle(ServerConfig(mode="off", **SERVE), lm=lm)
    before = [a.clone() for a in tree_leaves(bundle.params)]
    devices = []
    real = TS.retrain

    def spy(params, *args, **kw):
        devices.append({a.device for a in tree_leaves(params)})
        return real(params, *args, **kw)

    monkeypatch.setattr(TS, "retrain", spy)
    srv = FaultTolerantServer(ServerConfig(mode="protected", repair="retrain", retrain_steps=2, **SERVE),
                              bundle=bundle, injector=FaultInjector(8, 8, seed=1))
    for i in range(6):
        srv.submit(np.arange(4, dtype=np.int32) + i, 6)

    def hook(s):
        if s.step_idx == 2:
            for r, c, b, v in SIX:
                s.injector.inject_at(r, c, bit=b, val=v)
            s.manager.bist()

    srv.run(max_steps=64, on_step=hook)
    assert devices == [{bundle.device}] and srv.repair_events[0]["retrained"]
    assert all(a.device == TS.HOST and a.dtype == torch.float32 for a in tree_leaves(srv.master_params))
    assert all(a.device == bundle.device and a.dtype == dtype for a in tree_leaves(srv.params))
    assert srv.decode.params is srv.params and srv.params is not bundle.work
    moved = [not torch.equal(a, b) for a, b in zip(before, tree_leaves(srv.master_params))]
    assert any(moved) and not all(moved)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(bundle.params)))
    want = TL.cast_params(srv.master_params, dtype)
    assert all(_bits_equal(a, b) for a, b in zip(tree_leaves(srv.params), tree_leaves(want)))


def test_full_width_deepseek_retrain_is_refused_before_any_allocation(monkeypatch):
    """AdamW over deepseek-moe-16b's 16,375,728,128 f32 params needs 262 GB
    against the card's 80 GiB: a bundle or a server with ``repair="retrain"``
    refuses it with a ValueError naming the bytes, counted on ``meta``,
    before any param is drawn; at smoke size it serves."""
    full = get_config(DEEPSEEK)
    need = TS.RETRAIN_BYTES_PER_PARAM * full.n_params()
    assert need == 262_011_650_048
    monkeypatch.setattr(TS, "device_bytes", lambda device: hw.HBM_BYTES)

    def no_draw(*a, **kw):
        raise AssertionError("a param was drawn before the refusal")

    monkeypatch.setattr(TS, "init_params", no_draw)
    cfg = ServerConfig(arch=DEEPSEEK, repair="retrain", **SERVE)
    with pytest.raises(ValueError, match=f"{need:,} bytes .* {hw.HBM_BYTES:,}"):
        ModelBundle(cfg, lm=full)
    with pytest.raises(ValueError, match=f"{need:,} bytes"):
        FaultTolerantServer(cfg, bundle=types.SimpleNamespace(lm=full, device=torch.device("cpu")))
    # no retrain, or no budget: no refusal (the check returns before any count)
    TS.check_retrain_fits(dataclasses.replace(cfg, repair="remap"), full, torch.device("cpu"))
    TS.check_retrain_fits(dataclasses.replace(cfg, retrain_steps=0), full, torch.device("cpu"))
    TS.check_retrain_fits(cfg, get_smoke_config(DEEPSEEK), torch.device("cpu"))


def _stacked_salience(params, cols: int) -> np.ndarray:
    """The salience with every layer stack's leaf stacked first (the
    port's former reading, the reference's own)."""
    s = np.zeros(cols, np.float64)
    for _, leaves, stacked in stacked_leaves(params):
        a = np.stack([t.numpy() for t in leaves]) if stacked else leaves[0].numpy()
        if a.ndim >= 2 and np.issubdtype(a.dtype, np.floating):
            s += TRemap.fold_channel_salience(np.linalg.norm(a.reshape(-1, a.shape[-1]), axis=0), cols)
    return s


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", DEEPSEEK])
def test_streamed_salience_equals_stacked_and_reference(arch):
    """``weight_salience``, its stacks' column norms carried layer by layer,
    equals the stacked reading and the reference's ``weight_salience`` on
    the bridged smoke params bit for bit, and so does the bundle's."""
    cfg = dataclasses.replace(j_smoke(arch), dtype=jnp.float32)
    jparams = JL.init_params(jax.random.key(0), cfg)
    tparams = TL.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    got = TRemap.weight_salience(tparams, 8)
    assert np.array_equal(got, _stacked_salience(tparams, 8))
    assert np.array_equal(got, JRemap.weight_salience(jparams, 8))
    bundle = ModelBundle(ServerConfig(arch=arch, **SERVE), lm=get_smoke_config(arch), params=tparams)
    assert np.array_equal(bundle.salience, got)


@pytest.mark.parametrize("shape", [(3,), (64,), (40, 1), (300, 1), (300, 2), (33, 7), (4, 300, 5), (128, 1408)],
                         ids=str)
def test_column_norms_carried_over_layers_equal_the_stacked_norms(shape):
    """``_column_norms`` of five layers equals ``np.linalg.norm`` of their
    stack, bit for bit, whatever the width: a single column (which numpy
    reduces pairwise) as well as rows summed one after another."""
    rng = np.random.default_rng(len(shape) * 1000 + shape[-1])
    layers = [torch.from_numpy((rng.standard_normal(shape) * rng.uniform(0.1, 10)).astype(np.float32))
              for _ in range(5)]
    stack = np.stack([t.numpy() for t in layers])
    want = np.linalg.norm(stack.reshape(-1, stack.shape[-1]), axis=0)
    assert np.array_equal(TRemap._column_norms(layers).view(np.int32), want.view(np.int32))


def test_deepseek_byte_budget_on_meta():
    """Why the masters leave the card: deepseek-moe-16b's bf16 working
    copies (32.75 GB) fit ``launch/hw.py``'s 80 GiB, and f32 masters and
    copies together (98.3 GB) do not.  The streamed init's peak on the card
    is the working copies and one f32 piece (the largest, an MoE layer,
    2.35 GB; the largest leaf, the embedding or the untied head, 839 MB),
    under 40 GB."""
    lm = get_config(DEEPSEEK)
    biggest = []

    def piece(p):
        biggest.append(sum(a.numel() * 4 for a in tree_leaves(p)))
        return TL.cast_params(p, lm.dtype)

    work = TL.init_params(torch.Generator(), lm, device="meta", block_fn=piece)
    n = lm.n_params()
    work_bytes = sum(a.numel() * a.element_size() for a in tree_leaves(work))
    assert n == 16_375_728_128 and work_bytes == 2 * n == 32_751_456_256
    assert work_bytes < hw.HBM_BYTES < work_bytes + 4 * n
    assert max(biggest) == 2_351_448_064 and work_bytes + max(biggest) < 40e9
    assert max(a.numel() * 4 for a in tree_leaves(work)) == 102400 * 2048 * 4
