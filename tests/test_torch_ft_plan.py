"""The launch plan of the port's ``ft_matmul`` kernels, and their bf16 store.

The plan (``kernels/ft_matmul.py::ft_plan``) decides the instantiation, the
strip width and the cluster split along K; it must be a fixed function of
the shape, ``w``'s dtype and ``w``'s layout, so that the kernel's sum order
never depends on the card or the fault masks.  The bf16 store is held
against the JAX Pallas kernels run in interpret mode at ``bm = bn = 1``
followed by ``.astype(bfloat16)``, on integer-valued operands where every
f32 accumulate is exact.
"""
import importlib.util
import inspect
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.core.ftcontext import build_ftcontext as j_build
from repro.core.redundancy import DPPUConfig as JDPPU
from repro.kernels import ft_matmul as JFM
from repro_torch.core import engine as TE
from repro_torch.core import ftcontext as TF
from repro_torch.core.redundancy import DPPUConfig as TDPPU
from repro_torch.kernels import ft_matmul as TFM

ROWS, COLS = 4, 4
# bit 31 and bit 30 stuck-at-1 and -0 among them: outputs with exponent bits
# forced to all ones are inf or NaN, which the bf16 store must carry
FAULTS = [(0, 0, 31, 1), (2, 0, 30, 1), (1, 1, 31, 0), (3, 2, 30, 0), (0, 3, 5, 1), (1, 3, 20, 1)]

# (name, E, M, K, N, layout, split, bn) of every main-path shape of
# chip_smoke.py: DECODE_SHAPES (E = 1) and EXPERT_SHAPES, bf16 weights
PLANS = [
    ("qkv_1024x1024", 1, 4, 1024, 1024, "n_fast", 4, 64),
    ("out_1024x1024", 1, 4, 1024, 1024, "n_fast", 4, 64),
    ("up_gate_1024x2816", 1, 4, 1024, 2816, "n_fast", 2, 64),
    ("down_2816x1024", 1, 4, 2816, 1024, "n_fast", 4, 64),
    ("head_1024x152064", 1, 4, 1024, 152064, "k_fast", 1, 32),
    ("q_out_1536x1536", 1, 4, 1536, 1536, "n_fast", 4, 64),
    ("kv_1536x512", 1, 4, 1536, 512, "n_fast", 8, 64),
    ("router_1536x48", 1, 4, 1536, 48, "n_fast", 8, 64),
    ("head_1536x49408", 1, 4, 1536, 49408, "k_fast", 1, 32),
    ("gate_up_48x1536x512", 48, 4, 1536, 512, "n_fast", 1, 64),
    ("down_48x512x1536", 48, 4, 512, 1536, "n_fast", 1, 64),
    # the attention families: granite-8b and llava-next-mistral-7b share
    # their layers' shapes; their untied heads at K = 4096 do not fit the
    # K-fast kernel's x stage (KFAST_X_BYTES) and take the scalar one
    ("q_out_4096x4096", 1, 4, 4096, 4096, "n_fast", 1, 64),
    ("kv_4096x1024", 1, 4, 4096, 1024, "n_fast", 4, 64),
    ("gate_up_4096x14336", 1, 4, 4096, 14336, "n_fast", 1, 64),
    ("down_14336x4096", 1, 4, 14336, 4096, "n_fast", 1, 64),
    ("head_4096x49152", 1, 4, 4096, 49152, "scalar", 1, 64),
    ("head_4096x32000", 1, 4, 4096, 32000, "scalar", 1, 64),
    ("q_out_3072x3072", 1, 4, 3072, 3072, "n_fast", 2, 64),
    ("kv_3072x256", 1, 4, 3072, 256, "n_fast", 8, 64),
    ("up_3072x12288", 1, 4, 3072, 12288, "n_fast", 1, 64),
    ("down_12288x3072", 1, 4, 12288, 3072, "n_fast", 2, 64),
    ("head_3072x49152", 1, 4, 3072, 49152, "k_fast", 1, 32),
    ("wq_a_2560x768", 1, 4, 2560, 768, "n_fast", 8, 64),
    ("wq_b_768x3840", 1, 4, 768, 3840, "n_fast", 2, 64),
    ("wkv_a_2560x288", 1, 4, 2560, 288, "n_fast", 8, 64),
    ("wo_2560x2560", 1, 4, 2560, 2560, "n_fast", 2, 64),
    ("gate_up_2560x6400", 1, 4, 2560, 6400, "n_fast", 1, 64),
    ("down_6400x2560", 1, 4, 6400, 2560, "n_fast", 2, 64),
    ("head_2560x73472", 1, 4, 2560, 73472, "k_fast", 1, 32),
    ("qkvo_384x384", 1, 4, 384, 384, "n_fast", 4, 64),
    ("cross_kv_6000x384x384", 1, 6000, 384, 384, "n_fast", 1, 64),
    ("up_384x1536", 1, 4, 384, 1536, "n_fast", 4, 64),
    ("down_1536x384", 1, 4, 1536, 384, "n_fast", 8, 64),
    ("head_384x51968", 1, 4, 384, 51968, "k_fast", 1, 32),
    # the recurrent families: rwkv6-7b's decay LoRA pair (w_b's plan reads
    # w's dtype; its x is f32 on the path) and its untied head at K = 4096,
    # scalar as granite-8b's; zamba2-1.2b's in_proj, out_proj, the shared
    # block and the tied head
    ("rkvgo_ffr_4096x4096", 1, 4, 4096, 4096, "n_fast", 1, 64),
    ("w_a_4096x64", 1, 4, 4096, 64, "n_fast", 8, 64),
    ("w_b_64x4096", 1, 4, 64, 4096, "n_fast", 1, 64),
    ("ffk_4096x14336", 1, 4, 4096, 14336, "n_fast", 1, 64),
    ("ffv_14336x4096", 1, 4, 14336, 4096, "n_fast", 1, 64),
    ("head_4096x65536", 1, 4, 4096, 65536, "scalar", 1, 64),
    ("in_proj_2048x8384", 1, 4, 2048, 8384, "n_fast", 1, 64),
    ("out_proj_4096x2048", 1, 4, 4096, 2048, "n_fast", 2, 64),
    ("qkvo_2048x2048", 1, 4, 2048, 2048, "n_fast", 2, 64),
    ("gate_up_2048x8192", 1, 4, 2048, 8192, "n_fast", 1, 64),
    ("down_8192x2048", 1, 4, 8192, 2048, "n_fast", 2, 64),
    ("head_2048x32000", 1, 4, 2048, 32000, "k_fast", 1, 32),
    # deepseek-moe-16b: its attention shares zamba2's qkvo_2048x2048; the
    # dense first layer at K = 10944, the two shared experts as one FFN of
    # 2816, the router over 64 experts, the untied head (K-fast: x is
    # 2048 x 4 x 4 B = 32 KiB), the 64 routed experts of 1408
    ("dense_gate_up_2048x10944", 1, 4, 2048, 10944, "n_fast", 1, 64),
    ("dense_down_10944x2048", 1, 4, 10944, 2048, "n_fast", 2, 64),
    ("shared_gate_up_2048x2816", 1, 4, 2048, 2816, "n_fast", 2, 64),
    ("shared_down_2816x2048", 1, 4, 2816, 2048, "n_fast", 2, 64),
    ("router_2048x64", 1, 4, 2048, 64, "n_fast", 8, 64),
    ("head_2048x102400", 1, 4, 2048, 102400, "k_fast", 1, 32),
    ("gate_up_64x2048x1408", 64, 4, 2048, 1408, "n_fast", 1, 64),
    ("down_64x1408x2048", 64, 4, 1408, 2048, "n_fast", 1, 64),
]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _weight(name: str, e: int, k: int, n: int, dtype=torch.bfloat16) -> torch.Tensor:
    """The weight as the serving path hands it: the head reads the tied
    (vocab, d) table through its transposed view, the experts an (E, K, N)
    stack, every other site a row-major (K, N) matrix."""
    if name.startswith("head"):
        return torch.empty((n, k), dtype=dtype).T
    return torch.empty((e, k, n) if e > 1 else (k, n), dtype=dtype)


def test_plans_cover_every_main_path_shape():
    """The table above lists exactly chip_smoke.py's main-path shapes."""
    cs = _chip_smoke()
    want = {(s[0], 1, s[1], s[2], s[3]) for arch in cs.DECODE_SHAPES.values() for s in arch}
    want |= {s[:5] for arch in cs.EXPERT_SHAPES.values() for s in arch}
    assert {p[:5] for p in PLANS} == want


def _full_width(cs, arch: str):
    """``arch``'s full-width config and its bf16 working params on ``meta``
    (shapes only), and a protected fused context on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import cast_params, init_params

    lm = get_config(arch)
    params = cast_params(init_params(torch.Generator(), lm, device="meta"), lm.dtype)
    return lm, params, cs._prefill_ctx("protected", [], "fused", "cpu")


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-moe-3b-a800m", "granite-8b", "starcoder2-3b",
                                  "minicpm3-4b", "llava-next-mistral-7b", "whisper-tiny", "rwkv6-7b",
                                  "zamba2-1.2b", "deepseek-moe-16b"])
def test_decode_shapes_are_the_decode_steps(arch):
    """chip_smoke.py's DECODE_SHAPES and EXPERT_SHAPES, (M, K, N) and
    launches, are the full-width decode step's protected calls as recorded
    on ``meta``: the K that the kernel checks, the timings and PLANS read
    is the path's own, not only the ledger's (M, N)."""
    cs = _chip_smoke()
    lm, params, ctx = _full_width(cs, arch)
    assert cs.decode_shapes(lm, ctx, params) == cs.table_shapes(cs.DECODE_SHAPES[arch], cs.EXPERT_SHAPES[arch])


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-moe-3b-a800m", "minicpm3-4b",
                                  "llava-next-mistral-7b", "whisper-tiny", "rwkv6-7b", "zamba2-1.2b",
                                  "deepseek-moe-16b"])
def test_prefill_shapes_are_the_prefills(arch):
    """chip_smoke.py's PREFILL_SHAPES and PREFILL_EXPERT_SHAPES are the
    full-width fused prefill's protected calls at PREFILL's (B, S), with
    llava's patches and whisper's frames, as recorded on ``meta``."""
    cs = _chip_smoke()
    lm, params, ctx = _full_width(cs, arch)
    batch = cs.prefill_batch(lm, "meta")
    assert cs.prefill_shapes(lm, ctx, params, batch) == cs.table_shapes(
        cs.PREFILL_SHAPES[arch], cs.PREFILL_EXPERT_SHAPES[arch])


@pytest.mark.parametrize("name,e,m,k,n,layout,split,bn", PLANS, ids=[p[0] for p in PLANS])
def test_plan_of_each_decode_shape(name, e, m, k, n, layout, split, bn):
    """Instantiation, cluster split and strip width at each main-path shape:
    the dense projections split K up to eight ways while a call has fewer
    than 64 blocks (8-44 strips alone would leave most of the card idle),
    the expert stacks fill the card without a split, and the heads'
    transposed tables take the K-fast kernel up to K = 3072."""
    w = _weight(name, e, k, n)
    x = torch.empty((e, m, k) if e > 1 else (m, k), dtype=torch.bfloat16)
    assert TFM.w_layout(w) == layout
    plan = TFM.plan_of(x, w)
    assert plan == TFM.FTPlan(layout, split, bn)
    assert plan == TFM.ft_plan(e, m, n, k, torch.bfloat16, layout)
    if layout != "k_fast":
        # each rank still reads at least MIN_SLICE_BYTES of w, and the
        # cluster is never above the portable size
        assert 1 <= split <= TFM.MAX_SPLIT
        assert -(-k // split) * TFM.STRIP * 2 >= TFM.MIN_SLICE_BYTES or split == 1


def test_plan_is_the_same_whatever_the_device_or_masks(monkeypatch):
    """The plan reads the shape, dtype and layout alone: the same call on a
    tensor of another device, with other mask grids or with another
    reported SM count gets the same plan, so the sum order cannot move."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda *a, **kw: pytest.fail("the plan must not ask the card"))
    for name, e, m, k, n, *_ in PLANS:
        w = _weight(name, e, k, n)
        x = torch.empty((e, m, k) if e > 1 else (m, k), dtype=torch.bfloat16)
        plans = {TFM.plan_of(x, w), TFM.plan_of(x.to("meta"), w.to("meta")),
                 TFM.ft_plan(e, m, n, k, w.dtype, TFM.w_layout(w))}
        assert len(plans) == 1, (name, plans)
    # nothing else reaches it: no mask grid, no device property
    assert list(inspect.signature(TFM.ft_plan).parameters) == ["e", "m", "n", "k", "dtype", "layout"]
    assert list(inspect.signature(TFM.plan_of).parameters) == ["x", "w"]


@pytest.mark.parametrize("case", ["row_pitch_33", "base_offset", "step_2", "k_fast_pitch_70", "n_not_whole_vectors",
                                  "k_fast_too_deep"])
def test_misaligned_and_general_strides_take_the_scalar_instantiation(case):
    """Layouts 16-byte loads cannot read: a row pitch that is not a multiple
    of 16 bytes (n = 33 bf16 is 66 bytes), a base 2 bytes past an aligned
    one, a stride-2 view, a transposed table with a 140-byte pitch, a width
    that is not whole vectors, and a K-fast view whose x would not fit the
    kernel's shared memory.  Their split follows the same rule."""
    if case == "row_pitch_33":
        w = torch.empty((70, 33), dtype=torch.bfloat16)
    elif case == "base_offset":
        w = torch.empty((64, 129), dtype=torch.bfloat16)[:, 1:]
        assert w.data_ptr() % 16 == 2
    elif case == "step_2":
        w = torch.empty((128, 128), dtype=torch.bfloat16)[::2, ::2]
    elif case == "k_fast_pitch_70":
        w = torch.empty((33, 70), dtype=torch.bfloat16).T
    elif case == "n_not_whole_vectors":
        w = torch.empty((64, 136), dtype=torch.float32)[:, :130]
    else:
        w = torch.empty((1000, 4096), dtype=torch.bfloat16).T
    assert TFM.w_layout(w) == "scalar"
    k, n = w.shape
    plan = TFM.plan_of(torch.empty((4, k), dtype=torch.bfloat16), w)
    assert plan.layout == "scalar"
    assert plan.split == TFM.ft_plan(1, 4, n, k, w.dtype, "n_fast").split and plan.bn == TFM.STRIP


def test_aligned_layouts_take_the_16_byte_instantiations():
    """The complements of the cases above: aligned row-major weights of both
    dtypes (a 1000-wide bf16 row is 2000 bytes, 16-byte aligned) and
    transposed tables whose row pitch is whole vectors, at a ragged K."""
    assert TFM.w_layout(torch.empty((1000, 1000), dtype=torch.bfloat16)) == "n_fast"
    assert TFM.w_layout(torch.empty((1000, 1000), dtype=torch.float32)) == "n_fast"
    assert TFM.w_layout(torch.empty((3000, 1000), dtype=torch.bfloat16).T) == "k_fast"
    assert TFM.w_layout(torch.empty((6, 1536, 512), dtype=torch.bfloat16)) == "n_fast"
    # an expert stride that is not whole vectors
    stack = torch.empty((6 * (70 * 512 + 1),), dtype=torch.bfloat16).as_strided((6, 70, 512), (70 * 512 + 1, 512, 1))
    assert TFM.w_layout(stack) == "scalar"
    with pytest.raises(ValueError, match="layout"):
        TFM.ft_plan(1, 4, 64, 64, torch.bfloat16, "tma")


def _faults():
    fpt = np.full((8, 2), -1, np.int32)
    bits = np.zeros(8, np.int32)
    vals = np.zeros(8, np.int32)
    for i, (r, c, b, v) in enumerate(sorted(FAULTS, key=lambda f: (f[1], f[0]))):
        fpt[i], bits[i], vals[i] = (r, c), b, v
    js = JE.FaultState(jnp.asarray(fpt), jnp.asarray(bits), jnp.asarray(vals))
    ts = TE.FaultState(torch.from_numpy(fpt), torch.from_numpy(bits), torch.from_numpy(vals))
    return js, ts


def _bf16_equal(want_f32: np.ndarray, got: torch.Tensor) -> None:
    """``got`` (bf16) against JAX's f32 result cast to bf16: bitwise on every
    element that is not NaN, NaN exactly where JAX has NaN.  NaN payloads
    differ between the two casts on the CPU: JAX keeps the sign and quiets
    the payload (0x7fc0 / 0xffc0), torch's CPU cast writes 0xffff (seen on
    torch 2.13 for the CPU).  On the card the kernel's store and torch's
    cast are the same instruction (tests/test_torch_cuda.py)."""
    want = np.asarray(jnp.asarray(want_f32).astype(jnp.bfloat16)).view(np.uint16)
    got_bits = got.view(torch.int16).numpy().view(np.uint16)
    nan_w = (want & 0x7F80) == 0x7F80
    nan_w &= (want & 0x7F) != 0
    nan_g = np.isnan(got.float().numpy())
    assert np.array_equal(nan_w, nan_g)
    assert np.array_equal(want[~nan_w], got_bits[~nan_g])


@pytest.mark.parametrize("mode", ["protected", "unprotected"])
def test_ft_matmul_ref_bf16_store_matches_pallas_interpret(mode):
    js, ts = _faults()
    jc = JE.HyCAConfig(ROWS, COLS, JDPPU(size=2, group_size=2), mode)
    tc = TE.HyCAConfig(ROWS, COLS, TDPPU(size=2, group_size=2), mode)
    m, k, n = 8, 32, 16
    rng = np.random.default_rng(3)
    x = rng.integers(-8, 8, (m, k)).astype(np.float32)
    w = rng.integers(-8, 8, (k, n)).astype(np.float32)
    # out[2, 0] = 1 and out[2, 4] = 1.5 on PE(2, 0), whose bit 30 is stuck
    # at 1 when unprotected: 1 becomes inf and 1.5 a NaN
    x[2] = 0
    x[2, 0] = 1
    w[0, 0], w[0, 4] = 1, 1.5
    jftc = j_build(js, jc, dispatch="fused", fused_block=(8, 128, 128))
    bit, val, eff, prune = jftc._kernel_grids(None)
    pmask = jftc._prune_mask(None, prune, 1, 1, m, n)
    want = np.asarray(JFM.ft_matmul(jnp.asarray(x), jnp.asarray(w), bit, val, eff, pmask,
                                    bm=1, bn=1, bk=k, rows=ROWS, cols=COLS, interpret=True))
    and_g, or_g = TF.build_ftcontext(ts, tc, dispatch="fused").mask_grids(None)
    got = TFM.ft_matmul(torch.from_numpy(x), torch.from_numpy(w), and_g, or_g, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    _bf16_equal(want, got)
    if mode == "unprotected":
        assert np.isnan(want[2, 4]) and np.isinf(want[2, 0])


@pytest.mark.parametrize("m", [3, 12])
def test_ft_matmul_batched_ref_bf16_store_matches_pallas_interpret(m):
    js, ts = _faults()
    rows, cols, e, k, n = ROWS, COLS, 3, 16, 8
    jc = JE.HyCAConfig(rows, cols, JDPPU(size=2, group_size=2), "unprotected")
    tc = TE.HyCAConfig(rows, cols, TDPPU(size=2, group_size=2), "unprotected")
    rng = np.random.default_rng(m)
    x = rng.integers(-8, 8, (e, m, k)).astype(np.float32)
    w = rng.integers(-8, 8, (e, k, n)).astype(np.float32)
    jftc = j_build(js, jc, dispatch="fused")
    bit, val, eff, prune = jftc._kernel_grids(None)
    pmask = jftc._prune_mask(None, prune, 1, 1, m, n)
    want = np.asarray(JFM.ft_matmul_batched(jnp.asarray(x), jnp.asarray(w), bit, val, eff, pmask,
                                            bm=1, bn=1, bk=k, rows=rows, cols=cols, interpret=True))
    and_g, or_g = TF.build_ftcontext(ts, tc, dispatch="fused").mask_grids(None)
    got = TFM.ft_matmul_batched(torch.from_numpy(x), torch.from_numpy(w), and_g, or_g, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (e, m, n)
    _bf16_equal(want, got)


def test_wrappers_refuse_other_store_dtypes():
    keep = torch.full((ROWS, COLS), -1, dtype=torch.int32)
    with pytest.raises(TypeError, match="out_dtype"):
        TFM.ft_matmul(torch.ones((2, 3)), torch.ones((3, 4)), keep, keep, out_dtype=torch.float16)
    with pytest.raises(TypeError, match="out_dtype"):
        TFM.ft_matmul_batched(torch.ones((2, 2, 3)), torch.ones((2, 3, 4)), keep, keep, out_dtype=torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_dispatch_hands_out_dtype_to_the_kernels(monkeypatch, dtype):
    """``FTContext.matmul`` and ``.einsum`` under ``fused`` ask the kernel
    wrappers for the operands' dtype (bf16 stays bf16, f32 stays f32), so
    the kernel stores it and the ``.to(x.dtype)`` after the call is a no-op."""
    _, ts = _faults()
    tc = TE.HyCAConfig(ROWS, COLS, TDPPU(size=2, group_size=2), "protected")
    ftc = TF.build_ftcontext(ts, tc, dispatch="fused")
    asked = []

    def spy(real):
        def call(*a, **kw):
            asked.append(kw.get("out_dtype"))
            return real(*a, **kw)
        return call

    monkeypatch.setattr(TF, "ft_matmul", spy(TFM.ft_matmul))
    monkeypatch.setattr(TF, "ft_matmul_batched", spy(TFM.ft_matmul_batched))
    x = torch.ones((2, 3, 8), dtype=dtype)
    out = ftc.matmul(x, torch.ones((8, 5), dtype=dtype), site="attn.qkv")
    assert out.dtype == dtype and out.shape == (2, 3, 5)
    xe = torch.ones((4, 3, 1, 8), dtype=dtype)
    out = ftc.einsum("becd,edf->becf", xe, torch.ones((3, 8, 6), dtype=dtype), site="moe.expert")
    assert out.dtype == dtype and out.shape == (4, 3, 1, 6)
    assert asked == [dtype, dtype]
