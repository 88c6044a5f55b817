"""K3 and K4: per-row ascending u32 sorts (counterpart of
``fastani_tpu/ops/pallas_sort.py``: ``sort_rows_u32`` and
``sort_rows_u32_kv``).

On CUDA tensors the wrappers launch ``csrc/sort.cu``; on CPU tensors they
run the plain PyTorch version, a bitonic network as vectorized
compare-exchange stages.  Rows of any width up to the limit work: the
network pads with UMAX to a power of two and only the first n columns come
back.  On the card both take int32 words holding u32 bit patterns (UMAX is
-1) and raise on other dtypes; their plain versions take int32 or int64,
treat both as u32 and answer in the dtype they were given.  K4 is stable
(it sorts ``key << 32 | column`` composites), so its payload is a true
permutation even on tied keys.
"""

from __future__ import annotations

import torch

from fastani_tpu_torch.ops import cuda
from fastani_tpu_torch.ops.xputils import UMAX, u32_as_i32

MAX_KEYS = 32768       # 128 KB of u32 keys in one block's shared memory
MAX_KV = 16384         # 128 KB of 64-bit composites


def _pow2(n: int) -> int:
    return max(2, 1 << (n - 1).bit_length())


def _bitonic(x: torch.Tensor) -> torch.Tensor:
    """Ascending bitonic sort of each row (row width a power of two)."""
    R, N = x.shape
    size = 2
    while size <= N:
        stride = size // 2
        while stride >= 1:
            v = x.view(R, N // (2 * stride), 2, stride)
            a, b = v[:, :, 0, :], v[:, :, 1, :]
            blk = torch.arange(N // (2 * stride), device=x.device)
            asc = (((blk * 2 * stride) & size) == 0)[None, :, None]
            mn, mx = torch.minimum(a, b), torch.maximum(a, b)
            x = torch.stack([torch.where(asc, mn, mx),
                             torch.where(asc, mx, mn)], dim=2).reshape(R, N)
            stride //= 2
        size *= 2
    return x


def sort_rows_u32(x: torch.Tensor) -> torch.Tensor:
    """Ascending per-row sort of (R, n) u32 keys; on the card int32 words
    holding u32 bit patterns, in and out."""
    R, n = x.shape
    if n > MAX_KEYS:
        raise ValueError(f"sort_rows_u32: width {n} > {MAX_KEYS}")
    if x.device.type == "cpu":
        return sort_rows_u32_plain(x)
    if x.dtype != torch.int32:
        raise ValueError(f"sort_rows_u32: int32 words expected on the card, "
                         f"got {x.dtype}")
    x = x.contiguous()
    cuda.require_cuda("sort_rows_u32", x)
    out = torch.empty_like(x)
    if R and n:
        err = cuda.lib("sort").fa_sort_rows_u32(
            x.data_ptr(), out.data_ptr(), R, n, cuda.stream())
        cuda.check(err, "sort")
        cuda.LAUNCHES["sort"] += 1
    return out


def sort_rows_u32_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: int32 or int64 words, both read as u32; the
    output keeps the input dtype."""
    R, n = x.shape
    N = _pow2(n)
    pad = torch.full((R, N - n), UMAX, dtype=torch.int64, device=x.device)
    out = _bitonic(torch.cat([x.to(torch.int64) & UMAX, pad], dim=1))[:, :n]
    return u32_as_i32(out) if x.dtype == torch.int32 else out


def sort_rows_u32_kv(keys: torch.Tensor, payload: torch.Tensor):
    """Stable ascending per-row sort of (R, n) u32 keys with a u32 payload
    permuted alongside.  Returns (sorted_keys, payload).  On the card both
    are int32 words holding u32 bit patterns, in and out."""
    R, n = keys.shape
    if n > MAX_KV:
        raise ValueError(f"sort_rows_u32_kv: width {n} > {MAX_KV}")
    if payload.shape != keys.shape:
        raise ValueError("sort_rows_u32_kv: payload shape differs from keys")
    if keys.device.type == "cpu":
        return sort_rows_u32_kv_plain(keys, payload)
    if keys.dtype != torch.int32 or payload.dtype != torch.int32:
        raise ValueError(f"sort_rows_u32_kv: int32 words expected on the "
                         f"card, got {keys.dtype} / {payload.dtype}")
    keys = keys.contiguous()
    payload = payload.contiguous()
    cuda.require_cuda("sort_rows_u32_kv", keys, payload)
    ko = torch.empty_like(keys)
    po = torch.empty_like(payload)
    if R and n:
        err = cuda.lib("sort").fa_sort_rows_u32_kv(
            keys.data_ptr(), payload.data_ptr(), ko.data_ptr(), po.data_ptr(),
            R, n, cuda.stream())
        cuda.check(err, "sort_kv")
        cuda.LAUNCHES["sort_kv"] += 1
    return ko, po


def sort_rows_u32_kv_plain(keys: torch.Tensor, payload: torch.Tensor):
    """Plain version of K4: int32 or int64 words, both read as u32; the
    outputs keep the input dtypes."""
    R, n = keys.shape
    N = _pow2(n)
    col = torch.arange(N, dtype=torch.int64, device=keys.device)
    k = torch.cat([keys.to(torch.int64) & UMAX,
                   torch.full((R, N - n), UMAX, dtype=torch.int64,
                              device=keys.device)], dim=1)
    # u64 composite key << 32 | column, sign bit flipped so int64 order is
    # the unsigned order
    comp = ((k << 32) | col[None, :]) ^ (-(1 << 63))
    comp = _bitonic(comp)[:, :n] ^ (-(1 << 63))
    ko = (comp >> 32) & UMAX
    po = torch.gather(payload, 1, comp & UMAX)
    return (u32_as_i32(ko) if keys.dtype == torch.int32 else ko), po
