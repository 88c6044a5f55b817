"""K1: winnowing of haloed sequence rows (counterpart of
``fastani_tpu/ops/pallas_winnow.py::winnow_rows``).

``winnow_rows`` launches the CUDA kernel (``csrc/winnow.cu``) on a CUDA
tensor; on a CPU tensor it runs ``winnow_rows_plain``, the same function in
plain PyTorch.  Semantics are those of ``ops/minimizer.py::winnow_model`` in
the JAX package (the reference's deque, commonFunc.hpp:92-167), with the
emit selection carried across consecutive rows of one contig.  Hashes leave
as int32 words holding the u32 bits; the positions, which the Pallas kernel
also wrote, are an iota that ``positions`` makes for the callers that use
them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from fastani_tpu_torch.ops import cuda, hashing
from fastani_tpu_torch.ops.xputils import (UMAX, last_event_value,
                                           shift_right, u32_as_i32)

_NONE = -3            # "no event"; selections are >= 0, the fresh seed is -2
TILE_MAX = 2048       # scored positions a block of the kernel takes
_SMEM_LIMIT = 232448  # dynamic shared memory a block may use on Hopper


def tile_geometry(seg: int, tile_max: int = TILE_MAX) -> Tuple[int, int]:
    """(tile, n_tiles): a row of ``seg`` scored positions cut into n_tiles
    tiles of ``tile`` positions (a multiple of 32; the last may be
    shorter), as even as the multiple allows."""
    n_tiles = -(-seg // tile_max)
    per = -(-seg // n_tiles)
    tile = -(-per // 32) * 32
    return tile, -(-seg // tile)


def positions(base: torch.Tensor, seg: int, w: int) -> torch.Tensor:
    """(R, seg) int32 global k-mer start of each scored position of the
    rows whose first scored position is base[r] (the winnow's wpos)."""
    ar = torch.arange(seg, dtype=torch.int32, device=base.device)
    return base.to(torch.int32)[:, None] + ar[None, :] - (w - 1)


def winnow_rows(rows: torch.Tensor, ctg: torch.Tensor, base: torch.Tensor,
                true_len: torch.Tensor, k: int, w: int,
                tile_max: int = TILE_MAX):
    """Winnow a batch of segment rows.

    rows: (R, W) uint8 bytes covering global positions
        [base[r] - (w-1), base[r] - (w-1) + W) of contig ctg[r] (zero
        outside the contig).  Rows of one contig are consecutive and ordered.
    ctg, base, true_len: (R,) int32 contig id, first scored position,
        contig length.

    Returns (emit (R, seg) bool, hash (R, seg) int32 words holding the
    u32 bits) for the scored positions base[r] + i, i < seg = W - (w-1) -
    (k-1); hash is the window's canonical minimum hash, and an emitted
    minimizer's position is ``positions(base, seg, w)``.  The kernel cuts
    each row into tiles of at most ``tile_max`` positions
    (``tile_geometry``).
    """
    R, W = rows.shape
    seg = W - (w - 1) - (k - 1)
    if seg <= 0:
        raise ValueError(f"row width {W} too small for k={k}, w={w}")
    if rows.device.type == "cpu":
        return winnow_rows_plain(rows, ctg, base, true_len, k, w)
    ctg, base, true_len = (t.to(torch.int32).contiguous()
                           for t in (ctg, base, true_len))
    cuda.require_cuda("winnow_rows", rows, ctg, base, true_len)
    if rows.dtype != torch.uint8:
        raise ValueError("winnow_rows: rows must be uint8")
    if not 1 <= k <= 16:
        raise ValueError(f"winnow_rows: k={k} outside 1..16")
    tile, n_tiles = tile_geometry(seg, tile_max)
    lib = cuda.lib("winnow")
    smem = lib.fa_winnow_smem(tile, k, w)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"winnow_rows: a tile of {tile} positions at w={w} "
                         f"needs {smem} bytes of shared memory (limit "
                         f"{_SMEM_LIMIT})")
    # the kernel writes 0/1 bytes: the bool tensor's own storage
    emit = torch.empty((R, seg), dtype=torch.bool, device=rows.device)
    h = torch.empty((R, seg), dtype=torch.int32, device=rows.device)
    if R:
        scratch = torch.empty((3, R * n_tiles), dtype=torch.int32,
                              device=rows.device)
        err = lib.fa_winnow_tiles(
            rows.data_ptr(), ctg.data_ptr(), base.data_ptr(),
            true_len.data_ptr(), R, W, k, w, tile, emit.data_ptr(),
            h.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
            scratch[2].data_ptr(), cuda.stream())
        cuda.check(err, "winnow")
        cuda.LAUNCHES["winnow"] += 1
    return emit, h


def _pairmin(ah, ap, bh, bp):
    """Lexicographic min of (hash asc, position desc) pairs."""
    take = (bh < ah) | ((bh == ah) & (bp > ap))
    return torch.where(take, bh, ah), torch.where(take, bp, ap)


def winnow_rows_plain(rows: torch.Tensor, ctg: torch.Tensor,
                      base: torch.Tensor, true_len: torch.Tensor, k: int,
                      w: int):
    """Plain PyTorch version of the K1 kernel: returns (emit, hash int32
    words)."""
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
    return emit, u32_as_i32(wh)
