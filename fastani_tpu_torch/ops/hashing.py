"""MurmurHash3 x64_128 (low 32 bits, seed 42) of k-mers, in PyTorch
(counterpart of ``fastani_tpu/ops/hashing.py``).

The reference hashes each k-mer's raw ASCII bytes with MurmurHash3_x64_128
(seed 42) and keeps the low 32 bits of h1 (src/map/include/commonFunc.hpp:
71-81).  k <= 16, so a k-mer is one 16-byte block: k == 16 runs the single
body round, k < 16 only the tail round.

u64 arithmetic runs in int64: multiplies and adds wrap to the same bits,
and every right shift is made logical with a mask (torch has no uint64
shifts on the CPU).  Hashes come back as int64 tensors holding u32 values.
This is the arithmetic the CUDA winnow kernel (csrc/winnow.cu) performs in
native ``uint64_t``.
"""

from __future__ import annotations

import numpy as np
import torch

SEED = 42  # commonFunc.hpp:32

_M64 = (1 << 64) - 1


def _s64(c: int) -> int:
    """u64 constant as the int64 with the same bits."""
    c &= _M64
    return c - (1 << 64) if c >= (1 << 63) else c


_C1 = _s64(0x87C37B91114253D5)
_C2 = _s64(0x4CF5AD432745937F)
_F1 = _s64(0xFF51AFD7ED558CCD)
_F2 = _s64(0xC4CEB9FE1A85EC53)
_A1 = 0x52DCE729
_A2 = 0x38495AB5
_LOW32 = 0xFFFFFFFF


def _shr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _shr(x, 64 - r)


def _fmix64(h: torch.Tensor) -> torch.Tensor:
    h = h ^ _shr(h, 33)
    h = h * _F1
    h = h ^ _shr(h, 33)
    h = h * _F2
    return h ^ _shr(h, 33)


def _finalize(h1: torch.Tensor, h2: torch.Tensor, length: int) -> torch.Tensor:
    h1 = h1 ^ length
    h2 = h2 ^ length
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    return (h1 + h2) & _LOW32


def murmur3_low32_block16(w1: torch.Tensor, w2: torch.Tensor,
                          seed: int = SEED) -> torch.Tensor:
    """Low 32 bits of murmur3 x64_128 of 16-byte keys given as their two
    little-endian u64 words (int64 bit patterns)."""
    h1 = torch.full_like(w1, seed)
    h2 = torch.full_like(w1, seed)
    k1 = _rotl(w1 * _C1, 31) * _C2
    h1 = _rotl(h1 ^ k1, 27) + h2
    h1 = h1 * 5 + _A1
    k2 = _rotl(w2 * _C2, 33) * _C1
    h2 = _rotl(h2 ^ k2, 31) + h1
    h2 = h2 * 5 + _A2
    return _finalize(h1, h2, 16)


def murmur3_low32_tail(w1: torch.Tensor, w2: torch.Tensor, length: int,
                       seed: int = SEED) -> torch.Tensor:
    """Low 32 bits for keys shorter than 16 bytes (the tail-only path;
    bytes past ``length`` are zero in the words)."""
    h1 = torch.full_like(w1, seed)
    h2 = torch.full_like(w1, seed)
    if length > 8:
        h2 = h2 ^ (_rotl(w2 * _C2, 33) * _C1)
    h1 = h1 ^ (_rotl(w1 * _C1, 31) * _C2)
    return _finalize(h1, h2, length)


def _pack_words(seq: torch.Tensor, k: int, n_out: int):
    """The two little-endian u64 words of seq[..., i:i+k] for i < n_out."""
    b = seq.to(torch.int64)
    w1 = torch.zeros(seq.shape[:-1] + (n_out,), dtype=torch.int64,
                     device=seq.device)
    w2 = torch.zeros_like(w1)
    for j in range(k):
        v = b[..., j: j + n_out] << (8 * (j % 8))
        if j < 8:
            w1 = w1 | v
        else:
            w2 = w2 | v
    return w1, w2


def kmer_hashes(seq: torch.Tensor, k: int, seed: int = SEED) -> torch.Tensor:
    """Hashes of all k-mers along the last axis: out[..., i] = H(seq[..., i:i+k]).

    seq: uint8 tensor (..., L); returns int64 (..., L-k+1) holding u32."""
    n_out = seq.shape[-1] - k + 1
    if n_out <= 0:
        return torch.zeros(seq.shape[:-1] + (0,), dtype=torch.int64,
                           device=seq.device)
    w1, w2 = _pack_words(seq, k, n_out)
    if k == 16:
        return murmur3_low32_block16(w1, w2, seed)
    return murmur3_low32_tail(w1, w2, k, seed)


# byte-level reverse complement (commonFunc.hpp:37-54: A<->T, C<->G, all
# other bytes unchanged) and uppercase (makeUpperCase, commonFunc.hpp:57-66)

def _tables():
    rc = torch.arange(256, dtype=torch.uint8)
    for a, b in ((b"A", b"T"), (b"T", b"A"), (b"C", b"G"), (b"G", b"C")):
        rc[a[0]] = b[0]
    up = torch.arange(256, dtype=torch.int32)
    up[ord("a"): ord("z") + 1] -= 32
    return rc, up.to(torch.uint8)


def complement(seq: torch.Tensor) -> torch.Tensor:
    rc, _ = _tables()
    return rc.to(seq.device)[seq.long()]


def revcomp(seq: torch.Tensor) -> torch.Tensor:
    return complement(seq).flip(-1)


def upper(seq: torch.Tensor) -> torch.Tensor:
    _, up = _tables()
    return up.to(seq.device)[seq.long()]


_UPPER_NP = np.arange(256, dtype=np.uint8)
_UPPER_NP[ord("a"): ord("z") + 1] -= 32


def upper_np(seq: np.ndarray) -> np.ndarray:
    """Host uppercase of a uint8 array (the reader's bytes, before upload)."""
    return _UPPER_NP[seq]
