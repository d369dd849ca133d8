"""The port's CUDA kernels against their plain versions, on a card.

Imports torch and the port only (the card's machine has no JAX), so it runs
there with ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Without a card it skips.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS
from repro_torch.core import engine as TE
from repro_torch.kernels import dppu_recompute as TDR
from repro_torch.kernels import ft_matmul as TFM

# (row, col, stuck bit, stuck value) on a 4x4 array, bit 31 included
FAULTS = [(0, 0, 31, 1), (2, 0, 20, 1), (1, 1, 31, 0), (3, 2, 27, 0), (0, 3, 5, 1)]


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    """Both CUDA kernels against their plain versions: bitwise on
    integer-valued operands (every partial sum exact), bf16 and f32 (f32 with
    entries bf16 cannot hold), with a strided and a contiguous ``w``, ragged
    shapes included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    fpt = torch.tensor([[r, c] for r, c, _, _ in sorted(FAULTS, key=lambda f: (f[1], f[0]))], dtype=torch.int32)
    bits = torch.tensor([b for *_, b, _ in sorted(FAULTS, key=lambda f: (f[1], f[0]))], dtype=torch.int32)
    vals = torch.tensor([v for *_, v in sorted(FAULTS, key=lambda f: (f[1], f[0]))], dtype=torch.int32)
    hyca = TE.HyCAConfig(4, 4, mode="unprotected")
    meta = TE.fault_meta_grid(TE.FaultState(fpt, bits, vals).to(dev), hyca)
    and_g, or_g = TE.fault_mask_grids(meta)
    g = torch.Generator(device=dev).manual_seed(0)
    launches = TFM.ft_matmul.launches
    for m, k, n in ((4, 1024, 1024), (3, 1000, 1000), (5, 70, 33)):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randint(-4, 5, (m, k), generator=g, device=dev).to(dtype)
            if dtype == torch.float32:
                # ±(1 + 2^-8) is exact in f32 but not in bf16, and every
                # partial sum stays exact: rounding x to bf16 would show
                frac = torch.rand((m, k), generator=g, device=dev) < 0.25
                x = torch.where(frac, torch.sign(x + 0.5) * (1 + 2**-8), x)
            table = torch.randint(-4, 5, (n, k), generator=g, device=dev).to(dtype)
            for w in (table.T, table.T.contiguous()):
                got = TFM.ft_matmul(x, w, and_g, or_g)
                want = TFM.ft_matmul_ref(x, w, and_g, or_g)
                assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert TFM.ft_matmul.launches == launches + 12
    px = torch.randint(-4, 8, (2, 8), generator=g, device=dev, dtype=torch.int32)
    pw = torch.randint(-4, 8, (8, 16), generator=g, device=dev, dtype=torch.int32)
    ar = TE._int_matmul(px, pw)
    ar[0, 3] ^= 1 << 30
    got = TDR.probe_check(px, pw, ar)
    assert torch.equal(got, TDR.probe_check_ref(px, pw, ar, window=8).to(torch.int32))
    assert int(got.sum()) == 1


@pytest.mark.cuda
def test_batched_kernel_matches_plain_version_on_the_card():
    """``ft_matmul_batched`` against its plain version: bitwise on
    integer-valued operands, bf16 and f32, at M not a multiple of the array's
    rows (the PE row restarts per expert), with x read as a strided view of
    the (b, e, c, d) dispatch layout; bad shapes raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    fpt = torch.tensor([[r, c] for r, c, _, _ in sorted(FAULTS, key=lambda f: (f[1], f[0]))], dtype=torch.int32)
    bits = torch.tensor([b for *_, b, _ in sorted(FAULTS, key=lambda f: (f[1], f[0]))], dtype=torch.int32)
    vals = torch.tensor([v for *_, v in sorted(FAULTS, key=lambda f: (f[1], f[0]))], dtype=torch.int32)
    hyca = TE.HyCAConfig(4, 4, mode="unprotected")
    and_g, or_g = TE.fault_mask_grids(TE.fault_meta_grid(TE.FaultState(fpt, bits, vals).to(dev), hyca))
    g = torch.Generator(device=dev).manual_seed(0)
    launches = TFM.ft_matmul_batched.launches
    for e, m, k, n in ((6, 3, 256, 96), (5, 5, 70, 33)):
        for dtype in (torch.bfloat16, torch.float32):
            # (b=m, e, c=1, k) dispatch layout, viewed as (e, m, k) without a copy
            xb = torch.randint(-4, 5, (m, e, 1, k), generator=g, device=dev).to(dtype)
            x = xb.transpose(0, 1).reshape(e, m, k)
            assert not x.is_contiguous()
            w = torch.randint(-4, 5, (e, k, n), generator=g, device=dev).to(dtype)
            got = TFM.ft_matmul_batched(x, w, and_g, or_g)
            want = TFM.ft_matmul_batched_ref(x, w, and_g, or_g)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert TFM.ft_matmul_batched.launches == launches + 4
    with pytest.raises(ValueError, match=r"\(E, M, K\)"):
        TFM.ft_matmul_batched(torch.ones((2, 3, 4), device=dev), torch.ones((3, 4, 5), device=dev), and_g, or_g)


@pytest.mark.cuda
@pytest.mark.parametrize("bm,bn", [(1, 1), (128, 128), (128, 256)])
def test_two_pass_kernels_match_plain_versions_on_the_card(bm, bn):
    """``os_array_matmul`` and ``dppu_recompute`` against their plain
    versions: bitwise on integer-valued f32, bf16 and int8 operands, with a
    contiguous and a transposed ``w``, at fault-placement tiles smaller than,
    equal to and wider than the kernels' 128 x 128 block.  On random operands
    a recomputed tile equals the faulty array's fault-free output bit for bit
    (both kernels sum K in one order)."""
    from repro_torch.kernels import os_array_matmul as TOS

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    rows = cols = 4
    bit = torch.tensor([[31, 0, 5, 1], [30, 2, 9, 0], [0, 30, 12, 3], [4, 4, 31, 22]], dtype=torch.int32, device=dev)
    val = torch.tensor([[1, 0, 1, 1], [0, 1, 0, 0], [1, 1, 0, 1], [0, 0, 0, 1]], dtype=torch.int32, device=dev)
    faulty = torch.rand((rows, cols), generator=g, device=dev) < 0.5
    m, k, n = 256, 200, 512
    gm, gn = m // bm, n // bn
    fpt = torch.tensor([[gm - 1, 0], [-1, -1], [0, gn - 1], [gm // 2, gn // 2]], dtype=torch.int32)
    launches = (TOS.os_array_matmul.launches, TDR.dppu_recompute.launches)
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        x = torch.randint(-4, 5, (m, k), generator=g, device=dev).to(dtype)
        table = torch.randint(-4, 5, (n, k), generator=g, device=dev).to(dtype)
        for w in (table.T, table.T.contiguous()):
            got = TOS.os_array_matmul(x, w, bit, val, faulty, bm=bm, bn=bn, bk=k, rows=rows, cols=cols)
            want = TOS.os_array_matmul_plain(x, w, bit, val, faulty, bm=bm, bn=bn)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
            tiles = TDR.dppu_recompute(x, w, fpt, bm=bm, bn=bn, bk=k)
            assert torch.equal(tiles.view(torch.int32),
                               TDR.dppu_recompute_plain(x, w, fpt, bm=bm, bn=bn).view(torch.int32))
    assert (TOS.os_array_matmul.launches, TDR.dppu_recompute.launches) == (launches[0] + 6, launches[1] + 6)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((k, n), generator=g, device=dev).to(torch.bfloat16)
    clean = TOS.os_array_matmul(x, w, bit, val, torch.zeros_like(faulty), bm=bm, bn=bn, bk=k, rows=rows, cols=cols)
    tiles = TDR.dppu_recompute(x, w, fpt, bm=bm, bn=bn, bk=k)
    for f, (ti, tj) in enumerate(fpt.clamp_min(0).tolist()):
        assert torch.equal(tiles[f], clean[ti * bm:(ti + 1) * bm, tj * bn:(tj + 1) * bn])


@pytest.mark.cuda
def test_bf16_tensor_core_path_ragged_and_bitwise_on_the_card():
    """The bf16 path (TMA + wgmma) at M and N not multiples of 128 and K not a
    multiple of its 64-deep stage, for both layouts of ``w`` (row-major and
    the transposed view of a table): bitwise against the plain versions on
    integer-valued operands, and on random operands every recomputed tile
    bitwise equal to the fault-free array's output there, at placements
    smaller than, equal to and wider than the 64 x 128 wgmma piece."""
    from repro_torch.kernels import os_array_matmul as TOS

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    rows = cols = 4
    bit = torch.randint(0, 32, (rows, cols), generator=g, device=dev, dtype=torch.int32)
    val = torch.randint(0, 2, (rows, cols), generator=g, device=dev, dtype=torch.int32)
    faulty = torch.rand((rows, cols), generator=g, device=dev) < 0.5
    healthy = torch.zeros_like(faulty)
    for (m, k, n), (bm, bn) in (((192, 72, 200), (8, 8)), ((320, 136, 264), (1, 1)), ((256, 200, 384), (128, 128)),
                                ((320, 72, 520), (40, 104))):
        gm, gn = m // bm, n // bn
        fpt = torch.tensor([[gm - 1, gn - 1], [-1, -1], [0, gn - 1], [gm // 2, gn // 3], [gm - 1, 0]],
                           dtype=torch.int32)
        for kind in ("integer", "random"):
            if kind == "integer":
                x = torch.randint(-4, 5, (m, k), generator=g, device=dev).to(torch.bfloat16)
                table = torch.randint(-4, 5, (n, k), generator=g, device=dev).to(torch.bfloat16)
            else:
                x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
                table = torch.randn((n, k), generator=g, device=dev).to(torch.bfloat16)
            for w in (table.T, table.T.contiguous()):
                got = TOS.os_array_matmul(x, w, bit, val, faulty, bm=bm, bn=bn, bk=k, rows=rows, cols=cols)
                tiles = TDR.dppu_recompute(x, w, fpt, bm=bm, bn=bn, bk=k)
                if kind == "integer":
                    want = TOS.os_array_matmul_plain(x, w, bit, val, faulty, bm=bm, bn=bn)
                    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
                    want = TDR.dppu_recompute_plain(x, w, fpt, bm=bm, bn=bn)
                    assert torch.equal(tiles.view(torch.int32), want.view(torch.int32))
                    continue
                clean = TOS.os_array_matmul(x, w, bit, val, healthy, bm=bm, bn=bn, bk=k, rows=rows, cols=cols)
                for f, (ti, tj) in enumerate(fpt.clamp_min(0).tolist()):
                    assert torch.equal(tiles[f].view(torch.int32),
                                       clean[ti * bm:(ti + 1) * bm, tj * bn:(tj + 1) * bn].view(torch.int32))
    # N = 202: a ragged width that only the table's K-major layout reaches
    x = torch.randint(-4, 5, (192, 72), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randint(-4, 5, (202, 72), generator=g, device=dev).to(torch.bfloat16).T
    got = TOS.os_array_matmul(x, w, bit, val, faulty, bm=2, bn=2, bk=72, rows=rows, cols=cols)
    want = TOS.os_array_matmul_plain(x, w, bit, val, faulty, bm=2, bn=2)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_bf16_layouts_tma_cannot_read_raise_on_the_card():
    """A bf16 operand that TMA cannot describe raises ``ValueError`` naming
    the stride or base; it is never sent down another path.  The same
    operands in f32 run on the CUDA cores through their strides."""
    from repro_torch.kernels import os_array_matmul as TOS

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    grids = [torch.zeros((2, 2), dtype=torch.int32, device=dev)] * 2 + [torch.zeros((2, 2), dtype=torch.bool, device=dev)]
    x = torch.ones((64, 100), dtype=torch.bfloat16, device=dev)       # row stride 200 bytes
    w = torch.ones((100, 128), dtype=torch.bfloat16, device=dev)
    launches = (TOS.os_array_matmul.launches, TDR.dppu_recompute.launches)
    fpt = torch.tensor([[0, 0]], dtype=torch.int32)
    for xa, wa, what in ((x, w, "stride 100"),
                         (torch.ones((64, 136), dtype=torch.bfloat16, device=dev)[:, 1:65],
                          torch.ones((64, 128), dtype=torch.bfloat16, device=dev), "base"),
                         (torch.ones((64, 64), dtype=torch.bfloat16, device=dev),
                          torch.ones((128, 128), dtype=torch.bfloat16, device=dev)[::2, ::2], "unit stride")):
        with pytest.raises(ValueError, match=what):
            TOS.os_array_matmul(xa, wa, *grids, bm=64, bn=64, bk=1, rows=2, cols=2)
        with pytest.raises(ValueError, match=what):
            TDR.dppu_recompute(xa, wa, fpt, bm=64, bn=64, bk=1)
    assert (TOS.os_array_matmul.launches, TDR.dppu_recompute.launches) == launches
    out = TOS.os_array_matmul(x.float(), w.float(), *grids, bm=64, bn=64, bk=1, rows=2, cols=2)
    assert torch.equal(out, torch.full((64, 128), 100.0, device=dev))


def _grids_with_exponent_faults(dev):
    """4x4 mask grids with bit 30 stuck-at-1 on PE(1, 2) and bit 31 stuck at
    both values elsewhere: outputs in [1, 2) on PE(1, 2) become inf or NaN."""
    faults = FAULTS + [(1, 2, 30, 1), (3, 3, 31, 1)]
    faults.sort(key=lambda f: (f[1], f[0]))
    fpt = torch.tensor([[r, c] for r, c, _, _ in faults], dtype=torch.int32)
    bits = torch.tensor([b for *_, b, _ in faults], dtype=torch.int32)
    vals = torch.tensor([v for *_, v in faults], dtype=torch.int32)
    meta = TE.fault_meta_grid(TE.FaultState(fpt, bits, vals).to(dev), TE.HyCAConfig(4, 4, mode="unprotected"))
    return TE.fault_mask_grids(meta)


@pytest.mark.cuda
def test_ft_matmul_plans_match_the_plain_versions_on_the_card():
    """Every instantiation and split of the redesigned kernels against the
    plain versions, bitwise on integer-valued operands: split shapes (the
    cluster reduction), an unsplit expert stack, M = 37 (ten row tiles), a
    66-byte row pitch (the scalar instantiation), and the K-fast head layout
    at K = 1000, which ends inside a step; bf16 (tensor cores) and f32 (CUDA
    cores)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    and_g, or_g = _grids_with_exponent_faults(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    seen = set()
    for m, k, n, head in ((4, 1024, 1024, False), (4, 2816, 1024, False), (37, 1024, 1024, False),
                          (5, 70, 33, False), (4, 1000, 3000, True), (3, 1000, 1000, False)):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randint(-4, 5, (m, k), generator=g, device=dev).to(dtype)
            table = torch.randint(-4, 5, (n, k), generator=g, device=dev).to(dtype)
            w = table.T if head else table.T.contiguous()
            plan = TFM.plan_of(x, w)
            seen.add((plan.layout, plan.split > 1))
            got = TFM.ft_matmul(x, w, and_g, or_g)
            want = TFM.ft_matmul_ref(x, w, and_g, or_g)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (m, k, n, dtype, plan)
    for e, m, k, n in ((48, 4, 1536, 512), (4, 37, 512, 256), (3, 5, 70, 33)):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randint(-4, 5, (m, e, 1, k), generator=g, device=dev).to(dtype).transpose(0, 1).reshape(e, m, k)
            w = torch.randint(-4, 5, (e, k, n), generator=g, device=dev).to(dtype)
            plan = TFM.plan_of(x, w)
            seen.add((plan.layout, plan.split > 1))
            got = TFM.ft_matmul_batched(x, w, and_g, or_g)
            want = TFM.ft_matmul_batched_ref(x, w, and_g, or_g)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (e, m, k, n, dtype, plan)
    assert {("n_fast", True), ("n_fast", False), ("k_fast", False), ("scalar", False)} <= seen


@pytest.mark.cuda
def test_ft_matmul_gives_the_same_bits_twice_on_the_card():
    """The sum order is fixed by the plan and the code: the same call twice
    gives the same bits on random operands, split or not, and the fault-free
    and faulted calls (the same kernel with other masks) differ exactly by
    the epilogue."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    and_g, or_g = _grids_with_exponent_faults(dev)
    keep, zero = torch.full_like(and_g, -1), torch.zeros_like(or_g)
    g = torch.Generator(device=dev).manual_seed(4)
    for m, k, n, head in ((4, 1024, 1024, False), (4, 1536, 512, False), (4, 1024, 8192, True)):
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        table = (torch.randn((n, k), generator=g, device=dev) * 0.02).to(torch.bfloat16)
        w = table.T if head else table.T.contiguous()
        first = TFM.ft_matmul(x, w, keep, zero)
        again = TFM.ft_matmul(x, w, keep, zero)
        assert torch.equal(first.view(torch.int32), again.view(torch.int32))
        faulted = TFM.ft_matmul(x, w, and_g, or_g)
        assert torch.equal(faulted.view(torch.int32), TE.apply_mask_grids(first, and_g, or_g).view(torch.int32))
    x = torch.randn((4, 48, 1, 1536), generator=g, device=dev).to(torch.bfloat16).transpose(0, 1).reshape(48, 4, 1536)
    w = (torch.randn((48, 1536, 512), generator=g, device=dev) * 0.02).to(torch.bfloat16)
    first = TFM.ft_matmul_batched(x, w, and_g, or_g)
    assert torch.equal(first.view(torch.int32), TFM.ft_matmul_batched(x, w, and_g, or_g).view(torch.int32))


@pytest.mark.cuda
def test_bf16_store_is_the_f32_output_cast_on_the_card():
    """``out_dtype=torch.bfloat16`` stores the f32 output (epilogue applied)
    rounded to bf16, bit for bit against ``.to(torch.bfloat16)`` of the f32
    output on the card, on every instantiation, faulted outputs on bits 30
    and 31 included.  NaN payloads: the kernel rounds with
    ``__float2bfloat16_rn`` and PyTorch's cast on the card does the same, so
    they agree bit for bit, NaNs included.  On the CPU PyTorch's cast writes
    another NaN pattern (``tests/test_torch_ft_plan.py``), so a NaN is held
    there by position only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    and_g, or_g = _grids_with_exponent_faults(dev)
    g = torch.Generator(device=dev).manual_seed(5)
    nans = 0
    for m, k, n, head in ((4, 1024, 1024, False), (5, 70, 33, False), (4, 1000, 3000, True)):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((m, k), generator=g, device=dev).to(dtype)
            table = (torch.randn((n, k), generator=g, device=dev) * 0.05).to(dtype)
            w = table.T if head else table.T.contiguous()
            f32 = TFM.ft_matmul(x, w, and_g, or_g)
            b16 = TFM.ft_matmul(x, w, and_g, or_g, out_dtype=torch.bfloat16)
            cast = f32.to(torch.bfloat16)
            assert b16.dtype == torch.bfloat16
            assert torch.equal(b16.view(torch.int16), cast.view(torch.int16))
            assert torch.equal(torch.isnan(b16.cpu()), torch.isnan(f32.cpu().to(torch.bfloat16)))
            nans += int(torch.isnan(f32).sum())
    x = torch.randn((48, 4, 512), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((48, 512, 256), generator=g, device=dev) * 0.05).to(torch.bfloat16)
    f32 = TFM.ft_matmul_batched(x, w, and_g, or_g)
    b16 = TFM.ft_matmul_batched(x, w, and_g, or_g, out_dtype=torch.bfloat16)
    assert torch.equal(b16.view(torch.int16), f32.to(torch.bfloat16).view(torch.int16))
    nans += int(torch.isnan(f32).sum())
    assert nans > 0  # the stuck exponent bit made NaNs, and they were held


# (E, M, K, N) of the tile kernel's checks: the benchmark's prefill shapes
# (tests/test_torch_ft_plan.py::PREFILL_PLANS; E = 1 an ft_matmul call), then
# ragged M, N and K: a last row tile of 65 rows (one in its second
# warpgroup), a 48-column router, K ending inside a 64-deep stage (within
# each expert for the batched calls), and M = 960, whose last tile holds one
# warpgroup's rows only
TILE_SHAPES = [
    (1, 8192, 1536, 1536), (1, 8192, 1536, 512), (1, 8192, 1536, 48), (48, 2048, 1536, 512), (48, 2048, 512, 1536),
    (1, 8192, 2048, 2048), (1, 8192, 2048, 10944), (1, 8192, 10944, 2048), (1, 8192, 2048, 2816),
    (1, 8192, 2816, 2048), (1, 8192, 2048, 64), (64, 960, 2048, 1408), (64, 960, 1408, 2048),
    (1, 193, 200, 136), (1, 300, 70, 40), (3, 200, 100, 136), (5, 200, 1000, 8), (2, 960, 72, 264),
]


def _tile_call(e, x, w, and_g, or_g, **kw):
    if e == 1:
        return TFM.ft_matmul(x[0], w[0], and_g, or_g, **kw), TFM.ft_matmul_ref(x[0], w[0], and_g, or_g, **kw)
    return TFM.ft_matmul_batched(x, w, and_g, or_g, **kw), TFM.ft_matmul_batched_ref(x, w, and_g, or_g, **kw)


@pytest.mark.cuda
def test_tile_kernel_matches_the_plain_versions_on_the_card():
    """The tile plan (``M >= M_TILE`` rows per expert, bf16) against the
    plain versions with TF32 off: bitwise on integer-valued operands (every
    partial sum exact) at the benchmark's prefill shapes and at ragged M, N
    and K, with a 4x4 and a 32x32 fault map; one launch a call, each counted
    as a tile launch.  On random operands within the f32 rounding of a
    K-long sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    grids4 = _grids_with_exponent_faults(dev)
    meta = TE.fault_meta_grid(TE.FaultState(torch.tensor([[3, 5], [31, 30]], dtype=torch.int32),
                                            torch.tensor([30, 31], dtype=torch.int32),
                                            torch.tensor([1, 0], dtype=torch.int32)).to(dev),
                              TE.HyCAConfig(32, 32, mode="unprotected"))
    grids32 = TE.fault_mask_grids(meta)
    counts = (TFM.ft_matmul.launches, TFM.ft_matmul.tile_launches,
              TFM.ft_matmul_batched.launches, TFM.ft_matmul_batched.tile_launches)
    calls = {1: 0, 3: 0}
    for i, (e, m, k, n) in enumerate(TILE_SHAPES):
        and_g, or_g = grids32 if i % 2 else grids4
        x = torch.randint(-4, 5, (e, m, k), generator=g, device=dev).to(torch.bfloat16)
        w = torch.randint(-4, 5, (e, k, n), generator=g, device=dev).to(torch.bfloat16)
        assert TFM.plan_of(x if e > 1 else x[0], w if e > 1 else w[0]) == TFM.TILE_PLAN
        for out_dtype in (torch.float32, torch.bfloat16):
            got, want = _tile_call(e, x, w, and_g, or_g, out_dtype=out_dtype)
            calls[1 if e == 1 else 3] += 1
            assert torch.equal(got.view(torch.int16), want.view(torch.int16)), (e, m, k, n, out_dtype)
        if m * k * n * e <= 2**35:
            xr = torch.randn((e, m, k), generator=g, device=dev).to(torch.bfloat16)
            wr = (torch.randn((e, k, n), generator=g, device=dev) * 0.05).to(torch.bfloat16)
            keep, zero = torch.full_like(and_g, -1), torch.zeros_like(or_g)
            got, want = _tile_call(e, xr, wr, keep, zero)
            calls[1 if e == 1 else 3] += 1
            scale = torch.matmul(xr.float().abs(), wr.float().abs())
            scale = scale[0] if e == 1 else scale
            assert bool(((got - want).abs() <= 2.0**-20 * k * scale).all()), (e, m, k, n)
    after = (TFM.ft_matmul.launches, TFM.ft_matmul.tile_launches,
             TFM.ft_matmul_batched.launches, TFM.ft_matmul_batched.tile_launches)
    assert [a - b for a, b in zip(after, counts)] == [calls[1], calls[1], calls[3], calls[3]]


@pytest.mark.cuda
def test_tile_kernel_reads_strided_and_unaligned_x_on_the_card():
    """An ``x`` the TMA map cannot read as it lies (a 140-byte row pitch,
    a base 2 bytes past an aligned one, a stride along K; an expert stack
    with a 282-byte row pitch) is copied first, and gives the contiguous
    ``x``'s bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    and_g, or_g = _grids_with_exponent_faults(dev)
    g = torch.Generator(device=dev).manual_seed(12)
    w = (torch.randn((70, 136), generator=g, device=dev) * 0.05).to(torch.bfloat16)
    base = torch.randn((300, 141), generator=g, device=dev).to(torch.bfloat16)
    for x in (base[:, :70], base[:, 1:71], base[:, ::2][:, :70], base[:, :140:2]):
        assert TFM.plan_of(x, w) == TFM.TILE_PLAN
        want = TFM.ft_matmul(x.contiguous(), w, and_g, or_g)
        assert torch.equal(TFM.ft_matmul(x, w, and_g, or_g).view(torch.int32), want.view(torch.int32))
    x = torch.randn((6, 256, 141), generator=g, device=dev).to(torch.bfloat16)[..., :136]
    we = (torch.randn((6, 136, 264), generator=g, device=dev) * 0.05).to(torch.bfloat16)
    assert TFM.plan_of(x, we) == TFM.TILE_PLAN
    want = TFM.ft_matmul_batched(x.contiguous(), we, and_g, or_g)
    assert torch.equal(TFM.ft_matmul_batched(x, we, and_g, or_g).view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_tile_kernel_gives_the_same_bits_twice_and_its_bf16_store_is_the_f32_cast_on_the_card():
    """The tile kernel's sum order is fixed: the same call twice gives the
    same bits on random operands; the faulted call is the fault-free one
    with the epilogue applied (the same kernel, other masks); and its bf16
    store is its f32 output rounded, NaNs from stuck exponent bits
    included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    and_g, or_g = _grids_with_exponent_faults(dev)
    keep, zero = torch.full_like(and_g, -1), torch.zeros_like(or_g)
    g = torch.Generator(device=dev).manual_seed(13)
    nans = 0
    for e, m, k, n in ((1, 2048, 2048, 2816), (1, 300, 1000, 136), (64, 240, 1408, 512), (3, 200, 100, 136)):
        x = torch.randn((e, m, k), generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn((e, k, n), generator=g, device=dev) * 0.05).to(torch.bfloat16)
        x, w = (x[0], w[0]) if e == 1 else (x, w)
        fn = TFM.ft_matmul if e == 1 else TFM.ft_matmul_batched
        first = fn(x, w, keep, zero)
        assert torch.equal(first.view(torch.int32), fn(x, w, keep, zero).view(torch.int32))
        faulted = fn(x, w, and_g, or_g)
        row_res = None if e == 1 else (torch.arange(m, device=dev) % 4)[None, :, None]
        assert torch.equal(faulted.view(torch.int32),
                           TE.apply_mask_grids(first, and_g, or_g, row_residue=row_res).view(torch.int32))
        b16 = fn(x, w, and_g, or_g, out_dtype=torch.bfloat16)
        assert torch.equal(b16.view(torch.int16), faulted.to(torch.bfloat16).view(torch.int16))
        nans += int(torch.isnan(faulted).sum())
    assert nans > 0


@pytest.mark.cuda
def test_tile_kernel_in_a_cuda_graph_replays_as_eager_on_the_card():
    """Tile-plan calls of both wrappers captured in one CUDA graph: a
    replay on new operands written in place equals the eager calls bit for
    bit; the capture counts nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    and_g, or_g = _grids_with_exponent_faults(dev)
    g = torch.Generator(device=dev).manual_seed(14)
    x = torch.randn((1024, 512), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((512, 768), generator=g, device=dev) * 0.05).to(torch.bfloat16)
    xe = torch.randn((8, 256, 512), generator=g, device=dev).to(torch.bfloat16)
    we = (torch.randn((8, 512, 384), generator=g, device=dev) * 0.05).to(torch.bfloat16)

    def body():
        return (TFM.ft_matmul(x, w, and_g, or_g, out_dtype=torch.bfloat16),
                TFM.ft_matmul_batched(xe, we, and_g, or_g, out_dtype=torch.bfloat16))

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize(dev)
    before = (TFM.ft_matmul.tile_launches, TFM.ft_matmul_batched.tile_launches)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = body()
    TFM.ft_matmul.tile_launches, TFM.ft_matmul_batched.tile_launches = before
    for seed in (15, 16):
        g.manual_seed(seed)
        x.copy_(torch.randn(x.shape, generator=g, device=dev))
        xe.copy_(torch.randn(xe.shape, generator=g, device=dev))
        graph.replay()
        torch.cuda.synchronize(dev)
        for got, want in zip(outs, body()):
            assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 32])
def test_decode_row_counts_keep_the_strip_kernel_on_the_card(m):
    """At M = 4 and M = 32 rows (per expert) the wrappers launch the strip
    kernel of their plan as before: no tile launch, the explicit strip plan's
    bits, and the plain version's on integer-valued operands."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    and_g, or_g = _grids_with_exponent_faults(dev)
    g = torch.Generator(device=dev).manual_seed(17)
    tiles = (TFM.ft_matmul.tile_launches, TFM.ft_matmul_batched.tile_launches)
    for k, n in ((1536, 1536), (2048, 1408), (1536, 48)):
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn((k, n), generator=g, device=dev) * 0.05).to(torch.bfloat16)
        plan = TFM.plan_of(x, w)
        assert plan.bn == TFM.STRIP
        got = TFM.ft_matmul(x, w, and_g, or_g, out_dtype=torch.bfloat16)
        assert torch.equal(got.view(torch.int16),
                           TFM.ft_matmul(x, w, and_g, or_g, out_dtype=torch.bfloat16, plan=plan).view(torch.int16))
        xi = torch.randint(-4, 5, (m, k), generator=g, device=dev).to(torch.bfloat16)
        wi = torch.randint(-4, 5, (k, n), generator=g, device=dev).to(torch.bfloat16)
        assert torch.equal(TFM.ft_matmul(xi, wi, and_g, or_g).view(torch.int32),
                           TFM.ft_matmul_ref(xi, wi, and_g, or_g).view(torch.int32))
    xe = torch.randint(-4, 5, (m, 48, 1, 1536), generator=g, device=dev).to(torch.bfloat16).transpose(0, 1)
    xe = xe.reshape(48, m, 1536)
    we = torch.randint(-4, 5, (48, 1536, 512), generator=g, device=dev).to(torch.bfloat16)
    assert TFM.plan_of(xe, we).bn == TFM.STRIP
    assert torch.equal(TFM.ft_matmul_batched(xe, we, and_g, or_g).view(torch.int32),
                       TFM.ft_matmul_batched_ref(xe, we, and_g, or_g).view(torch.int32))
    assert (TFM.ft_matmul.tile_launches, TFM.ft_matmul_batched.tile_launches) == tiles


@pytest.mark.cuda
def test_probe_check_pair_matches_plain_version_on_the_card():
    """The pair kernel against its plain version (the OR of two
    ``probe_check_ref`` calls, the second on ``-pw``), bitwise, on small
    probe operands and on full-range int32 ones whose products and sums wrap
    mod 2^32, with stuck-at faults on every accumulator bit; one launch a
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    launches = TDR.probe_check_pair.launches
    for lo, hi in ((-4, 8), (-2**31, 2**31 - 1)):
        px = torch.randint(lo, hi, (3, 8), generator=g, device=dev, dtype=torch.int32)
        pw = torch.randint(lo, hi, (8, 16), generator=g, device=dev, dtype=torch.int32)
        ar, ar_neg = TE._int_matmul(px, pw), TE._int_matmul(px, -pw)
        for bit in range(32):
            for t in (ar, ar_neg):
                i, j = bit % 3, (5 * bit) % 16
                t[i, j] ^= int(np.uint32(1 << bit).view(np.int32))
        got = TDR.probe_check_pair(px, pw, ar, ar_neg)
        want = TDR.probe_check_pair_ref(px, pw, ar, ar_neg, window=8).to(torch.int32)
        assert torch.equal(got, want) and int(got.sum()) > 0
    assert TDR.probe_check_pair.launches == launches + 2


@pytest.mark.cuda
@pytest.mark.parametrize("arch,dispatch", [("qwen1.5-0.5b", "fused"), ("granite-moe-3b-a800m", "fused"),
                                           ("qwen1.5-0.5b", "plain"), ("granite-8b", "fused"),
                                           ("starcoder2-3b", "fused"), ("minicpm3-4b", "fused"),
                                           ("llava-next-mistral-7b", "fused"), ("whisper-tiny", "fused"),
                                           ("rwkv6-7b", "fused"), ("zamba2-1.2b", "fused")])
def test_captured_step_equals_eager_across_a_swap_on_the_card(arch, dispatch):
    """The smoke config served with the step captured as a CUDA graph and
    with the eager step, in each mode, with a fault injected mid-run (a
    fault-state swap after the capture): every step's logits and every token
    bitwise equal, one capture a server, and the launch counters after the
    warm-up step and N replays equal (N + 1) times the launches the capture
    recorded, which is what the eager run counts a step (none under
    ``plain``, which captures plain matmuls); the same for the tile
    launches, which only whisper's cross-attention K/V over its encoder
    frames makes at decode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.serving import FaultInjector, FaultTolerantServer, ModelBundle, ServerConfig

    cfg = ServerConfig(arch=arch, device="cuda", dispatch=dispatch, n_slots=4, smax=32, rows=4, cols=4,
                       dppu_size=4, seed=0)
    bundle = ModelBundle(cfg, lm=get_smoke_config(arch))
    gen = torch.Generator().manual_seed(3)
    trace = [torch.randint(0, 512, (4,), generator=gen).numpy() for _ in range(6)]
    kernels = (TFM.ft_matmul, TFM.ft_matmul_batched)
    for mode in ("off", "protected", "unprotected"):
        runs = {}
        for capture in (True, False):
            inj = FaultInjector(4, 4, seed=1)
            inj.inject_at(0, 1, bit=30, val=1)
            srv = FaultTolerantServer(dataclasses.replace(cfg, mode=mode), bundle=bundle, injector=inj,
                                      capture=capture)
            for p in trace:
                srv.submit(p, 6)
            logits, swaps = [], []
            for k in kernels:
                k.launches = k.tile_launches = 0
            while srv.queue.depth() or srv.scheduler.active:
                if srv.step_idx == 3:
                    inj.inject_at(1, 2, bit=29, val=1)
                swaps.append(bundle.swaps)
                srv.step()
                logits.append(srv.decode.logits.clone())
            runs[capture] = (srv, logits, swaps, [getattr(k, c) for c in TFM.COUNTERS for k in kernels])
        (gs, gl, gsw, gn), (es, el, _, en) = runs[True], runs[False]
        steps = len(gl)
        assert all(torch.equal(a.view(torch.int16), b.view(torch.int16)) for a, b in zip(gl, el))
        assert gs.completions_by_rid().keys() == es.completions_by_rid().keys()
        assert all(np.array_equal(gs.completions_by_rid()[r], es.completions_by_rid()[r])
                   for r in es.completions_by_rid())
        assert gs.decode.captures == 1 and gs.decode.replays == steps - 1 and es.decode.captures == 0
        if mode != "off":
            assert gsw[-1] > gsw[1]  # a fault-state swap after the capture
        per_step = [gs.decode.deltas[(k, c)] for c in TFM.COUNTERS for k in kernels]
        assert gn == en == [steps * n for n in per_step] and (per_step[0] > 0) == (dispatch == "fused")
        assert (sum(per_step[2:]) > 0) == (arch == "whisper-tiny" and dispatch == "fused")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-moe-3b-a800m"])
def test_plan_swap_and_counters_in_the_captured_step_on_the_card(arch):
    """A remap server with counters and series, its step captured and eager:
    6 faults appear at step 2 and a BIST confirms them, so the repair plan is
    swapped into the context after the capture.  Every step's logits and
    every token bitwise equal, one capture, the mask grids rewritten in
    place at the same addresses, and the counters and series equal between
    the two runs; ``protected_calls`` counts each batched launch once per
    expert."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.serving import FaultInjector, FaultTolerantServer, ModelBundle, ServerConfig

    cfg = ServerConfig(arch=arch, device="cuda", dispatch="fused", n_slots=4, smax=32, rows=8, cols=8,
                       dppu_size=4, seed=0, mode="protected", repair="remap", counters=True, series=True)
    lm = get_smoke_config(arch)
    bundle = ModelBundle(dataclasses.replace(cfg, mode="off"), lm=lm)
    gen = torch.Generator().manual_seed(3)
    trace = [torch.randint(0, 512, (4,), generator=gen).numpy() for _ in range(6)]
    six = [(0, 1, 30, 1), (1, 2, 29, 0), (2, 3, 30, 1), (3, 4, 28, 1), (0, 6, 30, 1), (1, 7, 29, 1)]
    kernels = (TFM.ft_matmul, TFM.ft_matmul_batched)
    runs = {}
    for capture in (True, False):
        srv = FaultTolerantServer(cfg, bundle=bundle, injector=FaultInjector(8, 8, seed=1), capture=capture)
        for p in trace:
            srv.submit(p, 6)
        logits, ptrs = [], []
        for k in kernels:
            k.launches = 0
        while srv.queue.depth() or srv.scheduler.active:
            if srv.step_idx == 2:
                for r, c, b, v in six:
                    srv.injector.inject_at(r, c, bit=b, val=v)
                srv.manager.bist()
            srv.step()
            logits.append(srv.decode.logits.clone())
            ptrs.append([g.data_ptr() for _, grids in bundle.ftc._grids for g in grids])
        runs[capture] = (srv, logits, ptrs, [k.launches for k in kernels])
    (gs, gl, gp, gn), (es, el, _, en) = runs[True], runs[False]
    assert [e["step"] for e in gs.repair_events] == [2] and gs.repair_events == es.repair_events
    assert gs.plan is not bundle.identity_plan and gs.manager.quality_fraction == 0.75
    assert all(torch.equal(a.view(torch.int16), b.view(torch.int16)) for a, b in zip(gl, el))
    assert gs.completions_by_rid().keys() == es.completions_by_rid().keys()
    assert all(np.array_equal(gs.completions_by_rid()[r], es.completions_by_rid()[r]) for r in es.completions_by_rid())
    assert gs.decode.captures == 1 and gs.decode.replays == len(gl) - 1
    assert all(p == gp[0] for p in gp)
    assert gs.counters_host() == es.counters_host()
    assert all(np.array_equal(gs.series_host()[k], es.series_host()[k]) for k in es.series_host())
    c = gs.counters_host()
    assert c["steps"] == len(gl) and c["pruned_elems"] > 0 and gn == en
    experts = lm.moe.n_padded if lm.moe else 1
    assert c["protected_calls"] == gn[0] + experts * gn[1]


@pytest.mark.cuda
def test_retrain_server_recaptures_once_and_its_sibling_serves_as_before_on_the_card():
    """``repair="retrain"`` on the smoke config: six faults at step 2, the
    plan and the fine-tune there, then the server's own working params; its
    captured step recaptures once (2 captures) and equals the eager step bit
    for bit; a sibling on the same bundle serves bitwise what it served
    before the retrain, with one capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.serving import FaultInjector, FaultTolerantServer, ModelBundle, ServerConfig

    cfg = ServerConfig(arch="qwen1.5-0.5b", device="cuda", dispatch="fused", n_slots=4, smax=32, rows=8, cols=8,
                       dppu_size=4, seed=0, mode="protected")
    bundle = ModelBundle(dataclasses.replace(cfg, mode="off"), lm=get_smoke_config("qwen1.5-0.5b"))
    gen = torch.Generator().manual_seed(3)
    trace = [torch.randint(0, 512, (4,), generator=gen).numpy() for _ in range(6)]
    six = [(0, 1, 30, 1), (1, 2, 29, 0), (2, 3, 30, 1), (3, 4, 28, 1), (0, 6, 30, 1), (1, 7, 29, 1)]

    def serve(repair, capture=None):
        srv = FaultTolerantServer(dataclasses.replace(cfg, repair=repair, retrain_steps=2), bundle=bundle,
                                  injector=FaultInjector(8, 8, seed=1), capture=capture)
        for p in trace:
            srv.submit(p, 6)
        logits = []
        while srv.queue.depth() or srv.scheduler.active:
            if srv.step_idx == 2:
                for r, c, b, v in six:
                    srv.injector.inject_at(r, c, bit=b, val=v)
                srv.manager.bist()
            srv.step()
            logits.append(srv.decode.logits.clone())
        return srv, logits

    before, before_logits = serve("remap")
    rt, rt_logits = serve("retrain")
    eager, eager_logits = serve("retrain", capture=False)
    after, after_logits = serve("remap")
    assert rt.repair_events[0]["retrained"] and rt.decode.captures == 2 and eager.decode.captures == 0
    assert rt.params is not bundle.work and rt.decode.params is rt.params
    # fine-tuned on the card from the host masters; the repaired masters back on the host
    from repro_torch.tree import tree_leaves

    assert rt.retrain_reports[0]["device"].startswith("cuda")
    assert all(a.device.type == "cpu" and a.dtype == torch.float32 for a in tree_leaves(rt.master_params))
    assert all(a.device.type == "cuda" for a in tree_leaves(rt.params))
    assert all(torch.equal(a.view(torch.int16), b.view(torch.int16)) for a, b in zip(rt_logits, eager_logits))
    assert before.decode.captures == after.decode.captures == 1
    assert all(torch.equal(a.view(torch.int16), b.view(torch.int16)) for a, b in zip(before_logits, after_logits))
    assert all(np.array_equal(before.completions_by_rid()[r], after.completions_by_rid()[r])
               for r in before.completions_by_rid())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fused_prefill_on_the_card(arch):
    """``forward(last_only=True)`` on the smoke config in f32 under
    ``fused`` on the card, with llava's patches and whisper's frames: one
    ``ft_matmul`` launch a protected matmul and one ``ft_matmul_batched`` a
    protected einsum, as ``chip_smoke.prefill_shapes`` records the prefill's
    calls on ``meta``; protected with faults the DPPU repairs bitwise the
    fault-free array, unprotected different, and the card within 1e-4 of
    the same prefill on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses
    import importlib.util
    from pathlib import Path

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.ftcontext import build_ftcontext
    from repro_torch.models import lm as TL

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    params = TL.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16), generator=gen)}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn((2, cfg.n_patches, cfg.d_vision), generator=gen) * 0.02
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((2, cfg.enc_len, cfg.d_model), generator=gen) * 0.02
    hyca = TE.HyCAConfig(4, 4, mode="protected")
    two = [(0, 1, 22, 1), (2, 3, 21, 0)]  # mantissa bits: the unprotected values stay finite

    def ctx(faults, mode, dev):
        fpt = torch.tensor([[r, c] for r, c, _, _ in faults] + [[-1, -1]], dtype=torch.int32)
        bits = torch.tensor([b for *_, b, _ in faults] + [0], dtype=torch.int32)
        vals = torch.tensor([v for *_, v in faults] + [0], dtype=torch.int32)
        return build_ftcontext(TE.FaultState(fpt, bits, vals).to(dev), dataclasses.replace(hyca, mode=mode),
                               dispatch="fused")

    def prefill(faults, mode, dev):
        with torch.no_grad():
            return TL.forward(TL.tree_map(lambda a: a.to(dev), params), cfg,
                              {k: v.to(dev) for k, v in batch.items()}, ftc=ctx(faults, mode, dev), last_only=True)[0]

    shapes = cs.prefill_shapes(cfg, ctx([], "protected", "cpu"), params, batch)
    kernels = (TFM.ft_matmul, TFM.ft_matmul_batched)
    counts = [k.launches for k in kernels]
    off = prefill([], "protected", "cuda")
    assert [k.launches - c for k, c in zip(kernels, counts)] == [
        sum(n for key, n in shapes.items() if key[0] == k.__name__) for k in kernels]
    assert torch.equal(off.view(torch.int32), prefill(two, "protected", "cuda").view(torch.int32))
    bad = prefill(two, "unprotected", "cuda")
    assert not torch.equal(off.view(torch.int32), bad.view(torch.int32))
    cpu = prefill(two, "unprotected", "cpu")
    assert float((bad.cpu() - cpu).abs()[..., :cfg.vocab].max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols,model", [(32, 32, "clustered"), (12, 40, "random")])
def test_campaign_evaluator_on_the_card_equals_the_cpu(rows, cols, model):
    """The batched repair evaluator on the card: every scheme's (ff,
    surviving columns), HyCA under repair="remap" too, equal to the CPU's and
    to the per-config numpy loop's, config by config; ``run_campaign`` on
    the card equal to the numpy engine field for field."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import campaign as cp
    from repro_torch.core.redundancy import DPPUConfig

    spec = cp.CampaignSpec(rows=rows, cols=cols, fault_model=model, n_configs=400, dppu=DPPUConfig(size=cols))
    for i, per in enumerate((0.01, 0.04)):
        point = cp.sample_point(spec, per, seed=cp.point_seed(0, i))
        for scheme, repair in (("RR", "none"), ("CR", "none"), ("DR", "none"), ("HyCA", "none"), ("HyCA", "remap")):
            aux = point.hyca_caps if scheme == "HyCA" else point.spare_faulty[scheme]
            outs = [cp.evaluate_batched(torch.from_numpy(point.maps).to(d), torch.from_numpy(aux).to(d),
                                        scheme=scheme, repair=repair) for d in ("cuda", "cpu")]
            ff, surv = cp.evaluate_reference(point, scheme, repair)
            for got_ff, got_surv in outs:
                assert np.array_equal(got_ff.cpu().numpy(), ff) and np.array_equal(got_surv.cpu().numpy(), surv)
    card = cp.run_campaign(spec, (0.01, 0.04))
    ref = cp.run_campaign(spec, (0.01, 0.04), engine="reference")
    assert [r.as_dict() for r in card.results] == [r.as_dict() for r in ref.results]


@pytest.mark.cuda
def test_hyca_matmul_batched_and_device_samplers_on_the_card():
    """``hyca_matmul_batched`` on the card over full-range int8 operands:
    equal to the CPU's and to the per-config ``hyca_matmul``, protected,
    unprotected and with remap plans; the clustered device sampler keeps
    every map's exact count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import campaign as cp
    from repro_torch.core.fault_models import random_fault_maps
    from repro_torch.core.redundancy import DPPUConfig

    rng = np.random.default_rng(0)
    maps = random_fault_maps(rng, 24, 16, 16, 0.06)
    states = {d: cp.batched_fault_states(maps, seed=3, device=d) for d in ("cuda", "cpu")}
    sal = rng.random(16).astype(np.float32)
    plans = {d: cp.batched_repair_plans(states[d], sal, rows=16, cols=16, capacity=8, device=d) for d in states}
    assert torch.equal(plans["cuda"].col_map.cpu(), plans["cpu"].col_map)
    x = torch.from_numpy(rng.integers(-128, 128, (24, 70, 300)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (300, 48)).astype(np.int8))
    for mode in ("protected", "unprotected"):
        cfg = TE.HyCAConfig(16, 16, DPPUConfig(size=8, group_size=8), mode)
        for use_plans in (False, True):
            out = {d: TE.hyca_matmul_batched(x.to(d), w.to(d), states[d], cfg=cfg,
                                             plans=plans[d] if use_plans else None) for d in states}
            assert torch.equal(out["cuda"].cpu(), out["cpu"])
            for i in (0, 23):
                plan = TE.RepairPlan(plans["cuda"].col_map[i], plans["cuda"].prune[i]) if use_plans else None
                one = TE.hyca_matmul(x[i].cuda(), w.cuda(), cp.take_config(states["cuda"], i), cfg=cfg, plan=plan)
                assert torch.equal(out["cuda"][i], one)
    m = cp.device_clustered_maps(5, 300, 16, 16, 0.05)
    g = torch.Generator(device="cuda").manual_seed(5)
    assert torch.equal(m.reshape(300, -1).sum(1), (torch.rand((300, 256), generator=g, device="cuda") < 0.05).sum(1))


def _fleet_cfg(device: str, dispatch: str = "fused", **kw):
    from repro_torch.serving import ChaosSpec, FleetConfig, ServerConfig, TrafficSpec

    return FleetConfig(
        n_replicas=3, n_spares=2, spare_policy="pool", n_regions=1, steps=48, seed=0,
        chaos=ChaosSpec(per=0.3, at_step=10, seed=3),
        traffic=TrafficSpec(request_rate=0.8, sla_steps=12, seed=5),
        server=ServerConfig(n_slots=2, smax=32, mode="protected", scan_block=2, rows=4, cols=4, dppu_size=2,
                            dispatch=dispatch, device=device),
        **kw,
    )


@pytest.mark.cuda
def test_run_fleet_fused_captured_on_the_card_equals_the_cpu():
    """``run_fleet`` of smoke-size qwen servers under ``dispatch="fused"`` on
    the card (every server's step captured, the spares' too) gives the CPU
    run's report key for key; every replica step launches the step's
    ft_matmul calls and one probe_check_pair."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.serving import run_fleet

    pair = TDR.probe_check_pair
    n_mm, n_pair = TFM.ft_matmul.launches, pair.launches
    card = run_fleet(_fleet_cfg("cuda"))
    n_mm, n_pair = TFM.ft_matmul.launches - n_mm, pair.launches - n_pair
    cpu = run_fleet(_fleet_cfg("cpu"))
    assert {k: card[k] for k in card} == {k: cpu[k] for k in card}
    assert card["replacements"] >= 1
    replica_steps = sum(r["scan_steps"] for r in card["replica_summaries"])
    assert n_pair >= replica_steps > 0 and n_mm > 0 and n_mm % n_pair == 0


@pytest.mark.cuda
def test_run_vfleet_on_the_card_captured_equals_eager_and_the_cpu():
    """``run_vfleet`` on the card: the captured tick equals the eager tick on
    every key (wearout included: both draw from the same generator), the
    card equals the CPU at fault rate 0, and one build serves a rate sweep."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from repro_torch.serving import run_vfleet
    from repro_torch.serving import vfleet as vf

    for rate in (0.0, 0.05):
        cfg = _fleet_cfg("cuda", fault_rate=rate, chunk_steps=20, series=True)
        got = run_vfleet(cfg)
        eager = run_vfleet(cfg, capture=False)
        for k in got:
            if k == "series":
                assert all(np.array_equal(got[k][c], eager[k][c]) for c in got[k])
            elif k != "sim_wall_s":
                assert got[k] == eager[k], k
        if rate == 0:
            cpu = run_vfleet(dataclasses.replace(cfg, server=dataclasses.replace(cfg.server, device="cpu")))
            assert {k: got[k] for k in got if k not in ("sim_wall_s", "series")} == \
                   {k: cpu[k] for k in got if k not in ("sim_wall_s", "series")}
    n0 = len(vf._TRACES)
    for rate in (0.01, 0.2):
        run_vfleet(_fleet_cfg("cuda", fault_rate=rate, chunk_steps=20, series=True))
    assert len(vf._TRACES) == n0


@pytest.mark.cuda
def test_hyca_matmul_batched_per_config_w_on_the_card():
    """``hyca_matmul_batched`` with one w a config on the card equals the
    CPU's, int8 operands, remap plans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import campaign as cp
    from repro_torch.core.fault_models import random_fault_maps
    from repro_torch.core.redundancy import DPPUConfig

    rng = np.random.default_rng(1)
    maps = random_fault_maps(rng, 8, 16, 16, 0.08)
    states = {d: cp.batched_fault_states(maps, seed=3, device=d) for d in ("cuda", "cpu")}
    sal = rng.random(16).astype(np.float32)
    plans = {d: cp.batched_repair_plans(states[d], sal, rows=16, cols=16, capacity=8, device=d) for d in states}
    x = torch.from_numpy(rng.integers(-128, 128, (70, 300)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (8, 300, 48)).astype(np.int8))
    cfg = TE.HyCAConfig(16, 16, DPPUConfig(size=8, group_size=8), "protected")
    out = {d: TE.hyca_matmul_batched(x.to(d), w.to(d), states[d], cfg=cfg, plans=plans[d], x_axis=None, w_axis=0)
           for d in states}
    assert torch.equal(out["cuda"].cpu(), out["cpu"])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bundle_keeps_masters_on_the_host_on_the_card(arch):
    """A bundle on the card: its f32 masters on the host and its working
    copies on the card are, bit for bit, ``init_params`` drawn from the
    card's generator and ``cast_params`` on the card; while it is built the
    card holds the working copies and one f32 piece at most, never the f32
    tree."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm as TL
    from repro_torch.serving import ModelBundle, ServerConfig
    from repro_torch.tree import tree_leaves

    lm = get_smoke_config(arch)
    cfg = ServerConfig(arch=arch, device="cuda", dispatch="fused", n_slots=4, smax=32, rows=4, cols=4, seed=3)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bundle = ModelBundle(cfg, lm=lm)
    torch.cuda.synchronize()
    after, peak = torch.cuda.memory_allocated() - base, torch.cuda.max_memory_allocated() - base
    want = TL.init_params(torch.Generator(device="cuda").manual_seed(3), lm)
    work = TL.cast_params(want, lm.dtype)

    def same(a, b):
        ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
        return a.dtype == b.dtype and torch.equal(a.view(ints), b.view(ints))

    assert all(a.device.type == "cpu" and same(a, b.cpu()) for a, b in zip(tree_leaves(bundle.params),
                                                                          tree_leaves(want)))
    assert all(a.device.type == "cuda" and same(a, b) for a, b in zip(tree_leaves(bundle.work), tree_leaves(work)))

    # the caching allocator's blocks: 512-byte multiples
    def alloc(leaves, size=None):
        return sum(-(-a.numel() * (size or a.element_size()) // 512) * 512 for a in leaves)

    work_alloc = alloc(tree_leaves(bundle.work))
    pieces = [v[0] if k in ("blocks", "dense_blocks") else v for k, v in want.items()]
    biggest = max(alloc(tree_leaves(p), 4) for p in pieces)
    assert after < work_alloc + 2**20  # no f32 master stays on the card (the context's tables: under 1 MiB)
    assert peak <= work_alloc + 2 * biggest + 2**20  # one f32 piece at a time, and one leaf's draw
