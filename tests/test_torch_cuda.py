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
