"""ABFT syndrome checks for checksum-augmented matmul.

The checksum *carry* lives in the engine
(:func:`repro_torch.core.engine.abft_checksums` rides the lanes through the
same stuck-at epilogue as the data); this module owns the *decision*:
compare the carried lanes against sums recomputed from the produced output
and flag the columns/rows whose syndromes are non-zero.

Two-sided scheme (Huang–Abraham, adapted to the PE-residue drain):

  * **column syndrome** — ``chk_row = colsum(x) @ w`` vs ``out.sum(axis=0)``.
    Both sides read the same weights, so this side is blind to weight-memory
    flips; it catches MAC/accumulator corruption.
  * **row syndrome** — ``chk_col = x @ wc`` with ``wc = abft_encode(w)``
    stored at weight-load time vs ``out.sum(axis=-1)``.  A weight bit flipped
    after encode breaks the stored invariant.

int32 accumulation is associative mod 2^32, so integer syndromes are exactly
zero when fault-free: sums are taken in int32 and wrap as the accumulator
does (``torch.sum`` of int32 would promote to int64).  Float sums
reassociate, so float syndromes use a relative threshold scaled by the
recomputed row/col magnitude.  A NaN syndrome compares False against that
threshold and is not flagged, exactly as in the reference.
"""
from __future__ import annotations

import torch


def _sum_i32(t: torch.Tensor, dim: int) -> torch.Tensor:
    return t.to(torch.int64).sum(dim=dim).to(torch.int32)


def abft_flags(
    o: torch.Tensor,
    chk_row: torch.Tensor | None,
    chk_col: torch.Tensor | None,
    *,
    rtol: float = 1e-4,
    atol: float = 1e-5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Column and row flags of a batch of outputs ``o`` (B, M, N) against
    carried lanes ``chk_row`` (B, ..., N) and ``chk_col`` (B, ..., M) (either
    may be None): ``(col_flags (B, N), row_flags (B, M))``.  The leading axis
    is the coverage campaign's config axis; :func:`abft_check` is B = 1."""
    b, m, n = o.shape
    exact = not o.dtype.is_floating_point
    pref = torch.int32 if exact else torch.float32
    o = o.to(pref)

    def flags(carried, dim):
        if exact:
            return carried.to(pref) != _sum_i32(o, dim)
        syndrome = carried.to(pref) - o.sum(dim=dim)
        return syndrome.abs() > rtol * o.abs().sum(dim=dim) + atol

    col_flags = torch.zeros((b, n), dtype=torch.bool, device=o.device)
    if chk_row is not None:
        col_flags = flags(chk_row.reshape(b, -1)[:, :n], 1)
    row_flags = torch.zeros((b, m), dtype=torch.bool, device=o.device)
    if chk_col is not None:
        row_flags = flags(chk_col.reshape(b, -1)[:, :m], 2)
    return col_flags, row_flags


def abft_check(
    out: torch.Tensor,
    chk_row: torch.Tensor | None = None,
    chk_col: torch.Tensor | None = None,
    *,
    rtol: float = 1e-4,
    atol: float = 1e-5,
) -> dict:
    """Compare carried checksum lanes against sums of the produced ``out``.

    ``out`` is (..., M, N) (leading dims fold into M, like the engine's
    checksum shapes); ``chk_row`` is the carried (1, N) column checksum and
    ``chk_col`` the carried (M, 1) row checksum; either may be None (that
    side is not checked).  Returns a dict of tensors on ``out``'s device:

      * ``col_flags`` (N,) bool — column syndromes over threshold,
      * ``row_flags`` (M,) bool — row syndromes over threshold,
      * ``detected``  ()  bool — any flag set.

    Integer dtypes are exact (syndrome != 0); float dtypes flag
    ``|syndrome| > rtol * magnitude + atol``, the magnitude being the
    recomputed absolute sums."""
    out2 = out.reshape(1, -1, out.shape[-1])
    col, row = abft_flags(
        out2,
        None if chk_row is None else chk_row.reshape(1, -1),
        None if chk_col is None else chk_col.reshape(1, -1),
        rtol=rtol, atol=atol,
    )
    return {"col_flags": col[0], "row_flags": row[0], "detected": col.any() | row.any()}
