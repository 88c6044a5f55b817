"""K1: winnowing of haloed sequence rows (counterpart of
``fastani_tpu/ops/pallas_winnow.py::winnow_rows``).

``winnow_rows`` launches the CUDA kernel (``csrc/winnow.cu``) on a CUDA
tensor; on a CPU tensor it runs ``winnow_rows_plain``, the same function in
plain PyTorch.  Semantics are those of ``ops/minimizer.py::winnow_model`` in
the JAX package (the reference's deque, commonFunc.hpp:92-167), with the
emit selection carried across consecutive rows of one contig.
"""

from __future__ import annotations

import torch

from fastani_tpu_torch.ops import cuda, hashing
from fastani_tpu_torch.ops.xputils import UMAX, last_event_value, shift_right

_NONE = -3            # "no event"; selections are >= 0, the fresh seed is -2
_SMEM_LIMIT = 232448  # dynamic shared memory a block may use on Hopper


def winnow_rows(rows: torch.Tensor, ctg: torch.Tensor, base: torch.Tensor,
                true_len: torch.Tensor, k: int, w: int):
    """Winnow a batch of segment rows.

    rows: (R, W) uint8 bytes covering global positions
        [base[r] - (w-1), base[r] - (w-1) + W) of contig ctg[r] (zero
        outside the contig).  Rows of one contig are consecutive and ordered.
    ctg, base, true_len: (R,) int32 contig id, first scored position,
        contig length.

    Returns (emit (R, seg) bool, hash (R, seg) int64 holding u32, wpos
    (R, seg) int32) for the scored positions base[r] + i, i < seg =
    W - (w-1) - (k-1); hash is the window's canonical minimum hash.
    """
    R, W = rows.shape
    seg = W - (w - 1) - (k - 1)
    if seg <= 0:
        raise ValueError(f"row width {W} too small for k={k}, w={w}")
    ar = torch.arange(seg, dtype=torch.int32, device=rows.device)
    wpos = base[:, None] + ar[None, :] - (w - 1)
    if rows.device.type == "cpu":
        emit, h = winnow_rows_plain(rows, ctg, base, true_len, k, w)
        return emit, h, wpos
    ctg, base, true_len = (t.to(torch.int32).contiguous()
                           for t in (ctg, base, true_len))
    cuda.require_cuda("winnow_rows", rows, ctg, base, true_len)
    if rows.dtype != torch.uint8:
        raise ValueError("winnow_rows: rows must be uint8")
    npos = W - k + 1
    r16 = lambda x: (x + 15) // 16 * 16
    smem = r16(W) + 5 * r16(npos) + 4 * 512
    if smem > _SMEM_LIMIT:
        raise ValueError(f"winnow_rows: row width {W} needs {smem} bytes "
                         f"of shared memory (limit {_SMEM_LIMIT})")
    emit = torch.empty((R, seg), dtype=torch.uint8, device=rows.device)
    h = torch.empty((R, seg), dtype=torch.int64, device=rows.device)
    if R:
        scratch = torch.empty((3, R), dtype=torch.int32, device=rows.device)
        err = cuda.lib("winnow").fa_winnow_rows(
            rows.data_ptr(), ctg.data_ptr(), base.data_ptr(),
            true_len.data_ptr(), R, W, k, w, emit.data_ptr(), h.data_ptr(),
            scratch[0].data_ptr(), scratch[1].data_ptr(),
            scratch[2].data_ptr(), cuda.stream())
        cuda.check(err, "winnow")
        cuda.LAUNCHES["winnow"] += 1
    return emit.bool(), h, wpos


def _pairmin(ah, ap, bh, bp):
    """Lexicographic min of (hash asc, position desc) pairs."""
    take = (bh < ah) | ((bh == ah) & (bp > ap))
    return torch.where(take, bh, ah), torch.where(take, bp, ap)


def winnow_rows_plain(rows: torch.Tensor, ctg: torch.Tensor,
                      base: torch.Tensor, true_len: torch.Tensor, k: int,
                      w: int):
    """Plain PyTorch version of the K1 kernel: returns (emit, hash)."""
    R, W = rows.shape
    halo = w - 1
    n = W - k + 1                       # k-mer starts; scored: [halo, n)
    base = base.to(torch.int64)
    x = hashing.upper(rows)
    hf = hashing.kmer_hashes(x, k)
    hb = hashing.kmer_hashes(hashing.revcomp(x), k).flip(-1)
    g = torch.arange(n, device=rows.device)[None, :] + base[:, None] - halo
    valid = ((hf != hb) & (g >= 0)
             & (g <= true_len.to(torch.int64)[:, None] - k))
    key_h = torch.where(valid, torch.minimum(hf, hb), UMAX)
    key_p = torch.where(valid, g, -1)
    # rightmost argmin over the trailing w-window: sparse-table doubling
    wh, wp = key_h, key_p
    span = 1
    while span * 2 <= w:
        wh, wp = _pairmin(wh, wp, shift_right(wh, span, UMAX),
                          shift_right(wp, span, -1))
        span *= 2
    if span < w:
        wh, wp = _pairmin(wh, wp, shift_right(wh, w - span, UMAX),
                          shift_right(wp, w - span, -1))
    wh, sel = wh[:, halo:], wp[:, halo:]
    event = valid[:, halo:] & (g[:, halo:] >= w - 1)
    # emit on change vs the previous event's selection: within the row by
    # last-event propagation, across rows from the nearest earlier row of
    # the same contig that had an event (-2 for a fresh contig)
    last, _ = last_event_value(event, sel, _NONE)
    row_last = last[:, -1]
    ridx = torch.arange(R, device=rows.device)
    prev_row = torch.where(row_last != _NONE, ridx, -1).cummax(0).values
    prev_row = torch.cat([prev_row.new_full((1,), -1), prev_row[:-1]])
    pr = prev_row.clamp(min=0)
    same = (prev_row >= 0) & (ctg[pr] == ctg)
    carry = torch.where(same, row_last[pr], torch.full_like(row_last, -2))
    prev_sel = shift_right(last, 1, _NONE)
    prev_sel = torch.where(prev_sel == _NONE, carry[:, None], prev_sel)
    emit = event & (sel != prev_sel)
    return emit, wh
