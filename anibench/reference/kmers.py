"""k-mer hashing and winnowed minimizers, in NumPy.

FastANI hashes each k-mer's bytes with MurmurHash3_x64_128 (seed 42) and
keeps the low 32 bits of h1 (FastANI's commonFunc.hpp:71-81).  A position
counts only where the forward and reverse-complement hashes differ; its
canonical hash is the smaller of the two.  At each such position i >= w-1,
the window [i-w+1, i] selects its rightmost minimum, and a minimizer
(hash, wpos = i-w+1) is emitted whenever that selection differs from the
one at the previous such position (commonFunc.hpp:92-167).

The hash is a frozen copy of the NumPy MurmurHash3 of the JAX package
(``fastani_tpu/ops/hashing.py``); the winnowing is written here as a
sliding minimum over (hash, -position) keys.
"""

from __future__ import annotations

import numpy as np

SEED = 42

_C1 = np.uint64(0x87C37B91114253D5)
_C2 = np.uint64(0x4CF5AD432745937F)
_F1 = np.uint64(0xFF51AFD7ED558CCD)
_F2 = np.uint64(0xC4CEB9FE1A85EC53)
_M5 = np.uint64(5)
_A1 = np.uint64(0x52DCE729)
_A2 = np.uint64(0x38495AB5)

_UPPER = np.arange(256, dtype=np.uint8)
_UPPER[ord("a"):ord("z") + 1] -= 32
_RC = np.arange(256, dtype=np.uint8)
for _a, _b in (("A", "T"), ("T", "A"), ("C", "G"), ("G", "C")):
    _RC[ord(_a)] = ord(_b)

_KEY_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)
_LOW32 = np.uint64(0xFFFFFFFF)


def upper(seq: np.ndarray) -> np.ndarray:
    return _UPPER[np.asarray(seq, dtype=np.uint8)]


def revcomp(seq: np.ndarray) -> np.ndarray:
    """Reverse complement along the last axis (only A, C, G, T change)."""
    return _RC[np.asarray(seq, dtype=np.uint8)][..., ::-1]


def _rotl(x, r: int):
    return (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def _fmix(h):
    h ^= h >> np.uint64(33)
    h *= _F1
    h ^= h >> np.uint64(33)
    h *= _F2
    h ^= h >> np.uint64(33)
    return h


def _words(seq: np.ndarray) -> np.ndarray:
    """w[..., i] = the little-endian u64 of seq[..., i:i+8] (zeros past the
    end), for every i < L + 8."""
    lead, L = seq.shape[:-1], seq.shape[-1]
    pad = np.zeros(lead + (L + 16,), np.uint8)
    pad[..., :L] = seq
    flat = pad.reshape(-1)
    n = flat.size - 8
    out = np.zeros(flat.size, np.uint64)
    for o in range(8):
        m = (n - o + 7) // 8
        out[o:o + 8 * m:8] = np.frombuffer(flat[o:o + 8 * m].tobytes(), "<u8")
    return out.reshape(lead + (L + 16,))


def murmur3_low32(seq: np.ndarray, k: int) -> np.ndarray:
    """Low 32 bits of MurmurHash3_x64_128 (seed 42) of every k-mer
    seq[..., i:i+k], 1 <= k <= 16."""
    if not 1 <= k <= 16:
        raise ValueError(f"k-mer length {k} outside 1..16")
    seq = np.asarray(seq, dtype=np.uint8)
    n = seq.shape[-1] - k + 1
    w = _words(seq)
    lo = w[..., :n]
    hi = w[..., 8:8 + n]
    if k < 8:
        lo = lo & np.uint64((1 << (8 * k)) - 1)
    if k < 16:
        hi = hi & np.uint64((1 << (8 * max(k - 8, 0))) - 1)
    with np.errstate(over="ignore"):
        h1 = np.full(lo.shape, np.uint64(SEED))
        h2 = np.full(lo.shape, np.uint64(SEED))
        if k == 16:
            k1 = lo * _C1
            k1 = _rotl(k1, 31)
            k1 *= _C2
            h1 ^= k1
            h1 = _rotl(h1, 27)
            h1 += h2
            h1 = h1 * _M5 + _A1
            k2 = hi * _C2
            k2 = _rotl(k2, 33)
            k2 *= _C1
            h2 ^= k2
            h2 = _rotl(h2, 31)
            h2 += h1
            h2 = h2 * _M5 + _A2
        else:
            if k > 8:
                k2 = hi * _C2
                k2 = _rotl(k2, 33)
                k2 *= _C1
                h2 ^= k2
            k1 = lo * _C1
            k1 = _rotl(k1, 31)
            k1 *= _C2
            h1 ^= k1
        ln = np.uint64(k)
        h1 ^= ln
        h2 ^= ln
        h1 += h2
        h2 += h1
        h1 = _fmix(h1)
        h2 = _fmix(h2)
        h1 += h2
    return (h1 & _LOW32).astype(np.uint32)


def kmer_hashes(seq: np.ndarray, k: int) -> np.ndarray:
    """out[..., i] = hash of seq[..., i:i+k]."""
    seq = np.asarray(seq, dtype=np.uint8)
    if seq.shape[-1] < k:
        return np.zeros(seq.shape[:-1] + (0,), dtype=np.uint32)
    return murmur3_low32(seq, k)


def _sliding_min(key: np.ndarray, w: int) -> np.ndarray:
    """out[..., i] = min(key[..., max(0, i-w+1) : i+1]), by doubling:
    the window is covered by blocks of the powers of two in w."""
    pows = {1: key}
    p = 1
    while 2 * p <= w:
        cur = pows[p].copy()
        cur[..., p:] = np.minimum(pows[p][..., p:], pows[p][..., :-p])
        p *= 2
        pows[p] = cur
    out, off = pows[p].copy(), p
    for q in sorted(pows, reverse=True):
        if off + q <= w:
            if off < out.shape[-1]:
                out[..., off:] = np.minimum(out[..., off:],
                                            pows[q][..., :-off])
            off += q
    return out


def canonical(rows: np.ndarray, k: int):
    """(valid, hash) of every k-mer of each row: valid where the forward
    and reverse-complement hashes differ, hash the smaller of the two."""
    rows = np.atleast_2d(np.asarray(rows, dtype=np.uint8))
    hf = kmer_hashes(rows, k)
    hb = kmer_hashes(revcomp(rows), k)[..., ::-1]
    return hf != hb, np.minimum(hf, hb)


def winnow_canonical(valid: np.ndarray, h: np.ndarray, w: int):
    """Minimizers of each row from its k-mers' ``canonical`` (valid, hash)
    ((n_rows, n) each).  Returns (row, hash u32, wpos) of every emitted
    minimizer, in row then position order."""
    n_rows, n = h.shape
    if n <= 0:
        z = np.zeros(0, np.int64)
        return z, z.astype(np.uint32), z
    idx = np.arange(n, dtype=np.uint64)
    # (hash asc, position desc): the deque keeps the newest of equal hashes
    key = np.where(valid, (h.astype(np.uint64) << np.uint64(32))
                   | (_LOW32 - idx), _KEY_MAX)
    win = _sliding_min(key, w)
    ev_r, ev_i = np.nonzero(valid & (np.arange(n) >= w - 1))
    sel = win[ev_r, ev_i]
    first = np.ones(len(sel), bool)
    first[1:] = (sel[1:] != sel[:-1]) | (ev_r[1:] != ev_r[:-1])
    sel, ev_r, ev_i = sel[first], ev_r[first], ev_i[first]
    return (ev_r.astype(np.int64), (sel >> np.uint64(32)).astype(np.uint32),
            (ev_i - (w - 1)).astype(np.int64))


def winnow(rows: np.ndarray, k: int, w: int):
    """Minimizers of each row of ``rows`` ((n_rows, L) uppercased bytes,
    every row a whole sequence): ``winnow_canonical`` of its k-mers."""
    rows = np.atleast_2d(np.asarray(rows, dtype=np.uint8))
    if rows.shape[-1] < max(k, w):
        z = np.zeros(0, np.int64)
        return z, z.astype(np.uint32), z
    return winnow_canonical(*canonical(rows, k), w)
