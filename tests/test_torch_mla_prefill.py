"""The MLA prefill core (``kernels/mla_prefill.py``): the plain version on
the CPU, bit for bit the loop ``mla_forward`` ran inline before the kernel;
the wrapper's checks, on ``meta``; and, on a card, the kernel (its bf16
instances and its f32 one) against the plain version, its causality, its
launches and its refusals.

Imports torch and the port only, so the card's tests run on the chip:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mla_prefill.py
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.dist.sharding import einsum, is_dtensor
from repro_torch.kernels import mla_prefill as MP
from repro_torch.models import attention as TA
from repro_torch.models.layers import merge_heads, split_heads
from repro_torch.obs.spans import ATTN_MLA

V3, MINICPM3 = "deepseek-v3", "minicpm3-4b"
V3_LAYOUT, MINICPM3_LAYOUT = (128, 64, 128), (64, 32, 64)
HEADS = {V3_LAYOUT: 128, MINICPM3_LAYOUT: 40}
# relative RMS error of the kernel against the f32 plain version: about two
# bf16 ulps (2^-8), the output's rounding to bf16 plus P's as the P.V operand
KERNEL_TOL = 5e-3
# the largest error of one output row (B, S, H) over its own norm
ROW_TOL = 2e-2
# the f32 instance against the f32 plain version: the same f32 arithmetic
# summed in another order (online, 32 lanes) and exp2 for exp, some f32 ulps
F32_TOL = 1e-5


def frozen_core(x, q_nope, q_rope, k_nope, k_rope, v, scale, qb):
    """``mla_forward``'s attention core as it ran inline before the kernel,
    frozen: the f32 casts, each query block over the keys up to its last
    row (the whole panel on DTensors), the -1e30 mask, ``torch.softmax``,
    the blocks cast to ``x``'s dtype."""
    s = x.shape[1]
    k_nope32, v32 = k_nope.to(torch.float32), v.to(torch.float32)
    k_rope32 = k_rope.to(torch.float32)
    kpos = torch.arange(s, device=x.device)
    neg = torch.full((), -1e30, device=x.device)
    outs = []
    for blk in range(s // qb):
        rows = slice(blk * qb, (blk + 1) * qb)
        keys = slice(0, s if is_dtensor(x) else (blk + 1) * qb)
        qpos = blk * qb + torch.arange(qb, device=x.device)
        sc = (einsum("bqhd,bshd->bqhs", q_nope[:, rows].to(torch.float32), k_nope32[:, keys])
              + einsum("bqhd,bsd->bqhs", q_rope[:, rows].to(torch.float32), k_rope32[:, keys])) * scale
        mask = kpos[None, keys] <= qpos[:, None]
        sc = torch.where(mask[None, :, None, :], sc, neg)
        wts = torch.softmax(sc, dim=-1)
        outs.append(einsum("bqhs,bshd->bqhd", wts, v32[:, keys]).to(x.dtype))
    return torch.cat(outs, dim=1)


def operands(layout, b, s, h, dtype=torch.bfloat16, device="cpu", seed=0, spread=1.0):
    """The core's operands in the layouts ``mla_forward`` hands over:
    q_nope a view of the (dn + dr)-wide query, k_nope and v views of one
    ``wkv_b`` output, q_rope and k_rope whole tensors; N(0, spread^2)
    (no values on ``meta``)."""
    dn, dr, dv = layout
    g = None if device == "meta" else torch.Generator(device=device).manual_seed(seed)

    def draw(*shape):
        if g is None:
            return torch.empty(shape, dtype=dtype, device=device)
        return (torch.randn(shape, generator=g, device=device) * spread).to(dtype)

    q, kv = draw(b, s, h, dn + dr), draw(b, s, h, dn + dv)
    return q[..., :dn], draw(b, s, h, dr), kv[..., :dn], draw(b, s, dr), kv[..., dn:]


def scale_of(arch):
    return get_config(arch).mla.softmax_scale


# --------------------------------------------------------------------------- #
# the CPU: the plain version, bit for bit the inline loop it replaced
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("layout", [V3_LAYOUT, MINICPM3_LAYOUT, (16, 8, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", [V3, MINICPM3])
def test_plain_version_is_the_inline_loop_bit_for_bit(layout, dtype, arch):
    """``mla_prefill_ref`` equals the frozen inline loop bit for bit at both
    MLA layouts and a smoke one, in f32 and bf16, at DeepSeek-V3's YaRN scale
    and MiniCPM3's plain one, for a query block below, at and above S."""
    scale = scale_of(arch)
    ops = operands(layout, 2, 32, 3, dtype, seed=len(layout) + layout[0])
    x = torch.empty((2, 32, 8), dtype=dtype)
    for q_block in (8, 32, 512):
        got = MP.mla_prefill_ref(*ops, scale, q_block=q_block)
        want = frozen_core(x, *ops, scale, min(q_block, 32))
        assert got.dtype == dtype and got.shape == (2, 32, 3, layout[2])
        assert torch.equal(got, want)


def test_plain_version_refuses_a_ragged_query_block():
    with pytest.raises(ValueError, match="multiple of the query block"):
        MP.mla_prefill_ref(*operands(MINICPM3_LAYOUT, 1, 24, 2), 0.1, q_block=16)


def frozen_mla_forward(x, p, cfg):
    """``mla_forward`` as it was before the kernel, with its core frozen."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    h, dn, dv = cfg.n_heads, cfg.d_nope, cfg.d_v
    q_nope, q_rope, c_kv, k_rope = TA._mla_qkr(x, p, cfg, positions)
    kv = split_heads(TA.site_matmul(None, "attn.qkv")(c_kv, p["wkv_b"]), h, dn + dv)
    qb = min(cfg.q_block, s)
    out = merge_heads(frozen_core(x, q_nope, q_rope, kv[..., :dn], k_rope, kv[..., dn:], cfg.softmax_scale, qb))
    return TA.site_matmul(None, "attn.out")(out, p["wo"])


@pytest.mark.parametrize("arch", [V3, MINICPM3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_forward_on_the_cpu_is_the_plain_version(arch, dtype):
    """On the CPU ``mla_forward`` runs the plain version inside its span,
    bit for bit the forward it was before the kernel, and launches
    nothing."""
    cfg = get_smoke_config(arch).mla
    p = {k: v.to(dtype) for k, v in TA.mla_init(torch.Generator().manual_seed(1), cfg, device="cpu").items()}
    x = (torch.randn((2, 32, cfg.d_model), generator=torch.Generator().manual_seed(2))).to(dtype)
    launches, spans = MP.mla_prefill.launches, ATTN_MLA.count
    got = TA.mla_forward(x, p, cfg)
    assert MP.mla_prefill.launches == launches and ATTN_MLA.count == spans + 1
    assert torch.equal(got, frozen_mla_forward(x, p, cfg))


@pytest.mark.parametrize("layout", [V3_LAYOUT, MINICPM3_LAYOUT])
def test_wrapper_on_the_cpu_is_the_plain_version(layout):
    ops = operands(layout, 1, 16, 2)
    launches = MP.mla_prefill.launches
    got = MP.mla_prefill(*ops, 0.125)
    assert MP.mla_prefill.launches == launches
    assert torch.equal(got, MP.mla_prefill_ref(*ops, 0.125))


def test_layouts_are_the_configs():
    """The kernel's template instances are the two MLA configs' head dims."""
    for arch in (V3, "deepseek-v3-ep32", MINICPM3):
        m = get_config(arch).mla
        assert (m.d_nope, m.d_rope, m.d_v) in MP.LAYOUTS
    assert set(MP.LAYOUTS) == {V3_LAYOUT, MINICPM3_LAYOUT}


# --------------------------------------------------------------------------- #
# the wrapper's checks, on meta tensors
# --------------------------------------------------------------------------- #
def meta_ops(layout=V3_LAYOUT, b=2, s=256, h=4, dtype=torch.bfloat16):
    return list(operands(layout, b, s, h, dtype, device="meta"))


def _padded_view(t):
    """``t`` as a view of a buffer whose last dim is 2 elements wider: a row
    pitch that is no multiple of 16 bytes."""
    wide = torch.empty((*t.shape[:-1], t.shape[-1] + 2), dtype=t.dtype, device=t.device)
    return wide[..., :t.shape[-1]]


REFUSALS = {
    "f32": (lambda o: [o[0].float()] + o[1:], TypeError, "one dtype"),
    "f16": (lambda o: [a.half() for a in o], TypeError, "bfloat16 or float32"),
    "f32_width": (lambda o: [a.float() for a in meta_ops((256, 64, 128))], ValueError, "up to 256"),
    "f32_inner_stride": (lambda o: [a.float() for a in o[:4]] + [o[4].float().transpose(-1, -2).contiguous()
                                                                 .transpose(-1, -2)], ValueError, "unit stride"),
    "smoke_layout": (lambda o: meta_ops((16, 8, 16)), ValueError, "layouts"),
    "v_width": (lambda o: o[:4] + [torch.empty((2, 256, 4, 64), dtype=torch.bfloat16, device="meta")],
                ValueError, "layouts"),
    "k_rope_per_head": (lambda o: o[:3] + [torch.empty((2, 256, 4, 64), dtype=torch.bfloat16, device="meta"), o[4]],
                        ValueError, r"\(B, S, dr\)"),
    "q_rope_heads": (lambda o: [o[0], torch.empty((2, 256, 2, 64), dtype=torch.bfloat16, device="meta")] + o[2:],
                     ValueError, "q_rope"),
    "v_length": (lambda o: o[:4] + [torch.empty((2, 128, 4, 128), dtype=torch.bfloat16, device="meta")],
                 ValueError, "v is"),
    "k_rope_length": (lambda o: o[:3] + [torch.empty((2, 128, 64), dtype=torch.bfloat16, device="meta"), o[4]],
                      ValueError, "k_rope is"),
    "inner_stride": (lambda o: [o[0].transpose(-1, -2).contiguous().transpose(-1, -2)] + o[1:],
                     ValueError, "unit stride"),
    "row_pitch": (lambda o: o[:4] + [_padded_view(o[4])], ValueError, "multiple of 8"),
    "grad": (lambda o: [o[0].detach().requires_grad_()] + o[1:], RuntimeError, "no backward"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    """The checks a CUDA call passes before its launch refuse each case."""
    make, err, match = REFUSALS[case]
    with pytest.raises(err, match=match):
        MP.check_operands(*make(meta_ops()))


@pytest.mark.parametrize("layout", [V3_LAYOUT, MINICPM3_LAYOUT])
def test_wrapper_takes_both_layouts_then_needs_a_card(layout):
    """Operands the kernel takes pass every check (the layout comes back),
    the ``mla_forward`` views included; off the card (here ``meta``) the
    wrapper computes the plain version's shapes and launches nothing."""
    ops = meta_ops(layout, h=HEADS[layout])
    assert MP.check_operands(*ops) == layout
    launches = MP.mla_prefill.launches
    got = MP.mla_prefill(*ops, 0.1)
    assert got.device.type == "meta" and tuple(got.shape) == (2, 256, HEADS[layout], layout[2])
    assert got.dtype == torch.bfloat16 and MP.mla_prefill.launches == launches


@pytest.mark.parametrize("layout", [V3_LAYOUT, MINICPM3_LAYOUT, (16, 8, 16), (160, 96, 256)])
def test_f32_instance_takes_any_width_up_to_its_limit(layout):
    """f32 operands of any (dn, dr, dv) with dn + dr and dv up to
    ``F32_MAX_D`` pass the checks, strides that TMA could not read
    included: the f32 instance reads through plain loads."""
    ops = [t.float() for t in meta_ops(layout, h=3)]
    ops[4] = _padded_view(ops[4])
    assert MP.check_operands(*ops) == layout


def test_grad_is_refused_only_where_autograd_records():
    ops = meta_ops()
    ops[4] = ops[4].detach().requires_grad_()
    with torch.no_grad():
        assert MP.check_operands(*ops) == V3_LAYOUT


# --------------------------------------------------------------------------- #
# the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rel_errors(got, want):
    """(relative RMS error over every value, the largest row's relative
    error), in f32."""
    got, want = got.float(), want.float()
    diff = got - want
    total = float(diff.norm() / want.norm())
    rows = float((diff.norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)).max())
    return total, rows


def hold(ops, scale):
    got = MP.mla_prefill(*ops, scale)
    torch.cuda.synchronize()
    want = MP.mla_prefill_ref(*ops, scale)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape and bool(torch.isfinite(got).all())
    total, rows = rel_errors(got, want)
    assert total <= KERNEL_TOL and rows <= ROW_TOL, (total, rows)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("layout,arch", [(V3_LAYOUT, V3), (MINICPM3_LAYOUT, MINICPM3)])
@pytest.mark.parametrize("b", [1, 2, 4])
@pytest.mark.parametrize("s", [128, 512, 1024, 4096])
def test_kernel_matches_the_plain_version(dev, layout, arch, b, s):
    launches = MP.mla_prefill.launches
    hold(operands(layout, b, s, HEADS[layout], device=dev, seed=b * s), scale_of(arch))
    assert MP.mla_prefill.launches == launches + 1


@pytest.mark.cuda
@pytest.mark.parametrize("layout,arch", [(V3_LAYOUT, V3), (MINICPM3_LAYOUT, MINICPM3)])
@pytest.mark.parametrize("s", [8, 200, 333])
def test_kernel_at_a_ragged_length(dev, layout, arch, s):
    """S that is no multiple of the 128-row tile: the last tile's rows past S
    are loaded as zeros and never stored."""
    hold(operands(layout, 2, s, HEADS[layout], device=dev, seed=s), scale_of(arch))


@pytest.mark.cuda
@pytest.mark.parametrize("layout,arch", [(V3_LAYOUT, V3), (MINICPM3_LAYOUT, MINICPM3)])
def test_kernel_rescales_as_the_running_max_grows(dev, layout, arch):
    """Scores of tens (operands of spread 3) and keys that grow with their
    position, so that every key tile raises the running max: the online
    softmax rescales its sums and outputs at every tile."""
    q_nope, q_rope, k_nope, k_rope, v = operands(layout, 2, 1024, HEADS[layout], device=dev, seed=5, spread=3.0)
    grow = torch.linspace(0.2, 2.0, 1024, device=dev)
    k_nope = (k_nope.float() * grow[None, :, None, None]).to(torch.bfloat16)
    k_rope = (k_rope.float() * grow[None, :, None]).to(torch.bfloat16)
    sc = torch.einsum("bqhd,bkhd->bhqk", q_nope[:, -128:].float(), k_nope.float()) * scale_of(arch)
    assert float(sc.abs().max()) > 50
    hold((q_nope, q_rope, k_nope, k_rope, v), scale_of(arch))


@pytest.mark.cuda
@pytest.mark.parametrize("layout,arch", [(V3_LAYOUT, V3), (MINICPM3_LAYOUT, MINICPM3)])
def test_kernel_is_causal(dev, layout, arch):
    """Keys and values past row i changed: output rows up to i unchanged,
    bit for bit; the rows after them change."""
    ops = operands(layout, 2, 1024, HEADS[layout], device=dev, seed=7)
    before = MP.mla_prefill(*ops, scale_of(arch))
    i = 300
    q_nope, q_rope, k_nope, k_rope, v = (t.clone() for t in ops)
    g = torch.Generator(device=dev).manual_seed(8)
    for t in (k_nope, k_rope, v):
        t[:, i + 1:] = torch.randn(t[:, i + 1:].shape, generator=g, device=dev).to(t.dtype)
    after = MP.mla_prefill(q_nope, q_rope, k_nope, k_rope, v, scale_of(arch))
    assert torch.equal(before[:, :i + 1], after[:, :i + 1])
    assert not torch.equal(before[:, i + 1:], after[:, i + 1:])


@pytest.mark.cuda
def test_one_launch_a_layer_over_a_deepseek_v3_prefill(dev):
    """``forward`` of ``deepseek-v3-ep32`` at its published widths (23
    layers, bf16 weights, all zero: only the launches are counted) on a
    plain CUDA batch: one ``mla_prefill`` launch a layer, each inside the
    ``attn.mla`` span."""
    from repro_torch.models import lm as TL
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_config("deepseek-v3-ep32"), dtype=torch.bfloat16)
    shapes = TL.init_params(torch.Generator(), cfg, device="meta")
    params = tree_map(lambda a: torch.zeros(a.shape, device=dev,
                                            dtype=torch.bfloat16 if a.is_floating_point() else a.dtype), shapes)
    tokens = torch.randint(0, cfg.vocab, (2, 256), generator=torch.Generator().manual_seed(0)).to(dev)
    launches, spans = MP.mla_prefill.launches, ATTN_MLA.count
    with torch.no_grad():
        logits, _ = TL.forward(params, cfg, {"tokens": tokens}, last_only=True)
    torch.cuda.synchronize()
    assert cfg.n_layers == 23 and bool(torch.isfinite(logits.float()).all())
    assert MP.mla_prefill.launches - launches == 23 and ATTN_MLA.count - spans == 23
    del params


@pytest.mark.cuda
def test_kernel_refusals_on_the_card(dev):
    """A CUDA call that autograd would record, the smoke configs' layout and
    a base off 16 bytes each raise before any launch."""
    ops = list(operands(V3_LAYOUT, 1, 128, 4, device=dev))
    launches = MP.mla_prefill.launches
    with pytest.raises(RuntimeError, match="no backward"):
        MP.mla_prefill(ops[0].detach().requires_grad_(), *ops[1:], 0.1)
    with pytest.raises(ValueError, match="layouts"):
        MP.mla_prefill(*operands((16, 8, 16), 1, 128, 4, device=dev), 0.1)
    shifted = torch.empty(ops[3].numel() + 4, dtype=torch.bfloat16, device=dev)[4:].view(ops[3].shape)
    with pytest.raises(ValueError, match="aligned"):
        MP.mla_prefill(*ops[:3], shifted, ops[4], 0.1)
    assert MP.mla_prefill.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("layout,arch", [(V3_LAYOUT, V3), (MINICPM3_LAYOUT, MINICPM3), ((16, 8, 16), MINICPM3)])
@pytest.mark.parametrize("s", [16, 200, 1024])
def test_f32_instance_matches_the_plain_version(dev, monkeypatch, layout, arch, s):
    """f32 operands take the f32 instance, one launch, f32 out, within
    F32_TOL of the plain version computed in f32 (cuBLAS without TF32)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    ops = operands(layout, 2, s, HEADS.get(layout, 8), dtype=torch.float32, device=dev, seed=s)
    launches = MP.mla_prefill.launches
    got = MP.mla_prefill(*ops, scale_of(arch))
    torch.cuda.synchronize()
    assert MP.mla_prefill.launches == launches + 1
    want = MP.mla_prefill_ref(*ops, scale_of(arch), q_block=s)
    assert got.dtype == torch.float32 and got.shape == want.shape
    total, rows = rel_errors(got, want)
    assert total <= F32_TOL and rows <= 10 * F32_TOL, (total, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_forward_on_the_card_launches_the_kernel(dev, monkeypatch, dtype):
    """``mla_forward`` on a CUDA tensor, f32 or bf16, launches the kernel
    once inside its span and gives no plain version a way in: the smoke
    layout, which the bf16 instances do not take, raises in bf16; in f32 it
    agrees with the CPU's forward."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(get_config(MINICPM3).mla, n_heads=8) if dtype == torch.bfloat16 \
        else get_smoke_config(MINICPM3).mla
    p = {k: v.to(dtype) for k, v in TA.mla_init(torch.Generator().manual_seed(1), cfg, device="cpu").items()}
    x = torch.randn((2, 256, cfg.d_model), generator=torch.Generator().manual_seed(2)).to(dtype)
    launches, spans = MP.mla_prefill.launches, ATTN_MLA.count
    with torch.no_grad():
        got = TA.mla_forward(x.to(dev), {k: v.to(dev) for k, v in p.items()}, cfg)
        want = TA.mla_forward(x, p, cfg)
    torch.cuda.synchronize()
    assert MP.mla_prefill.launches == launches + 1 and ATTN_MLA.count == spans + 2
    total, _ = rel_errors(got.cpu(), want)
    # in bf16 the core's KERNEL_TOL plus the projections' bf16 roundings,
    # which the CPU and cuBLAS may round apart
    assert total <= (F32_TOL if dtype == torch.float32 else 4 * KERNEL_TOL), total
    if dtype == torch.bfloat16:
        smoke = get_smoke_config(MINICPM3).mla
        ps = {k: v.to(dev, dtype) for k, v in TA.mla_init(torch.Generator().manual_seed(1), smoke, device="cpu").items()}
        with torch.no_grad(), pytest.raises(ValueError, match="layouts"):
            TA.mla_forward(torch.zeros((1, 16, smoke.d_model), dtype=dtype, device=dev), ps, smoke)
