"""The port's CUDA kernels against their plain versions, on a card.

Imports torch and the port only (the card's machine has no JAX), so it runs
there with ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Without a card it skips.
"""
import pytest
import torch

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
