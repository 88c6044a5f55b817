"""K2: stable per-row compaction (counterpart of
``fastani_tpu/ops/pallas_compact.py::compact_rows``).

Flagged elements of each payload move to the front of their row in their
original order; slots past the row's flagged count take the payload's
fill.  ``compact_rows`` launches ``csrc/compact.cu`` on CUDA tensors and
runs ``compact_rows_plain`` (a prefix count plus a scatter) on CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from fastani_tpu_torch.ops import cuda

_MAX_PAYLOADS = 4
_MAX_THREADS = 256     # a block's threads; each takes 16 flags a tile
_BLOCKS = 2048         # blocks a launch spreads few long rows over


def compact_geometry(R: int, n: int) -> Tuple[int, int]:
    """(threads, chunks) of the kernel's launch: blocks just wide enough
    for a row at 16 flags a thread (at most 256 threads), and each row cut
    into ``chunks`` blocks of whole tiles when there are too few rows to
    fill the card (one block a row from 2048 rows up)."""
    groups = -(-n // 16)
    threads = min(_MAX_THREADS, max(32, -(-groups // 32) * 32))
    tiles = -(-n // (16 * threads))
    return threads, max(1, min(tiles, _BLOCKS // max(R, 1)))


def compact_rows(flags: torch.Tensor,
                 payloads: Sequence[Tuple[torch.Tensor, int]],
                 width: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """Stable per-row compaction of ``payloads`` by ``flags``.

    flags: (R, n) bool.  payloads: (tensor (R, n) int32/int64, fill) pairs,
    at most four.  Returns one (R, width) tensor per payload (width
    defaults to n): row r holds its flagged values in order at
    [0, min(cnt_r, width)), the fill beyond.
    """
    R, n = flags.shape
    width = n if width is None else int(width)
    if not 1 <= len(payloads) <= _MAX_PAYLOADS:
        raise ValueError(f"compact_rows takes 1-{_MAX_PAYLOADS} payloads")
    for a, _ in payloads:
        if a.shape != flags.shape or a.dtype not in (torch.int32, torch.int64):
            raise ValueError("compact_rows: payloads must be (R, n) int32/int64")
    if flags.device.type == "cpu":
        return compact_rows_plain(flags, payloads, width)
    if flags.dtype != torch.bool:
        raise ValueError(f"compact_rows: bool flags expected, got {flags.dtype}")
    f8 = flags.contiguous().view(torch.uint8)      # the same bytes, no copy
    ins = [a.contiguous() for a, _ in payloads]
    cuda.require_cuda("compact_rows", f8, *ins)
    outs = [torch.empty((R, width), dtype=a.dtype, device=a.device)
            for a in ins]
    if R and width:
        npay = len(ins)
        threads, chunks = compact_geometry(R, n)
        counts = (torch.empty(R * chunks, dtype=torch.int32, device=f8.device)
                  if chunks > 1 else None)
        in_p = (ctypes.c_void_p * _MAX_PAYLOADS)(*[a.data_ptr() for a in ins])
        out_p = (ctypes.c_void_p * _MAX_PAYLOADS)(*[o.data_ptr() for o in outs])
        esz = (ctypes.c_int * _MAX_PAYLOADS)(*[a.element_size() for a in ins])
        fill = (ctypes.c_longlong * _MAX_PAYLOADS)(*[int(f) for _, f in payloads])
        err = cuda.lib("compact").fa_compact_rows(
            f8.data_ptr(), R, n, width, threads, chunks, npay, in_p, out_p,
            esz, fill, None if counts is None else counts.data_ptr(),
            cuda.stream())
        cuda.check(err, "compact")
        cuda.LAUNCHES["compact"] += 1
    return tuple(outs)


def compact_rows_plain(flags: torch.Tensor,
                       payloads: Sequence[Tuple[torch.Tensor, int]],
                       width: int) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the K2 kernel: the rank of each flagged
    element is its inclusive prefix count minus one; elements whose rank is
    past ``width`` (and unflagged ones) scatter into a dropped extra slot."""
    R, n = flags.shape
    rank = torch.cumsum(flags.to(torch.int64), dim=-1) - 1
    dst = torch.where(flags & (rank < width), rank, width)
    cnt = flags.sum(dim=-1, keepdim=True)
    col = torch.arange(width, device=flags.device)[None, :]
    outs = []
    for a, fill in payloads:
        out = torch.full((R, width + 1), int(fill), dtype=a.dtype,
                         device=a.device)
        out.scatter_(1, dst, a)
        out = out[:, :width]
        outs.append(torch.where(col < cnt, out, torch.full_like(out, int(fill))))
    return tuple(outs)
