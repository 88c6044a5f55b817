"""Mash statistics of FastANI's mapper (map_stats.hpp:36-257): Jaccard and
mash distance, the binomial confidence bound, the minimum L1 hits and the
identity of a shared-sketch count.

The scalar functions are frozen copies of the JAX package's
``fastani_tpu/ops/stats.py``, with its float32 rounding points; the bound's
search over x is evaluated for all counts c of one sketch size s at once
(``sketch_tables``), with the same ``scipy.stats.binom.sf`` per element.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.stats import binom

_f32 = np.float32


def j2md(j: float, k: int) -> np.float32:
    j = _f32(j)
    if j == 0:
        return _f32(1.0)
    if j == 1:
        return _f32(0.0)
    denom = _f32(_f32(1) + j)
    return _f32((-1.0 / k) * math.log(2.0 * float(j) / float(denom)))


def md2j(d: float, k: int) -> np.float32:
    d = _f32(d)
    kd = _f32(np.int32(k) * d)
    return _f32(1.0 / (2.0 * math.exp(float(kd)) - 1.0))


def md_lower_bound(d: float, s: int, k: int, ci: float) -> np.float32:
    """The scalar search (map_stats.hpp:79-111), for tests."""
    q2 = (1.0 - ci) / 2.0
    j = md2j(d, k)
    x = max(int(math.ceil(s * float(j))), 1)
    while x <= s:
        if float(binom.sf(x - 1, s, float(j))) < q2:
            x -= 1
            break
        x += 1
    return j2md(_f32(_f32(x) / s), k)


def estimate_minimum_hits(s: int, k: int, perc_identity: float) -> int:
    jaccard = md2j(_f32(1.0 - perc_identity / 100.0), k)
    return int(math.ceil(1.0 * s * float(jaccard)))


def _lower_bounds(s: int, k: int, ci: float = 0.9) -> np.ndarray:
    """md_lower_bound(j2md(c / s), s, k, ci) for every c in 0..s."""
    q2 = (1.0 - ci) / 2.0
    js = np.array([md2j(j2md(_f32(1.0 * c / s), k), k) for c in range(s + 1)],
                  np.float32)
    x = np.arange(1, s + 1)
    sf = binom.sf(x[None, :] - 1, s, js.astype(np.float64)[:, None])
    x0 = np.maximum(np.ceil(s * js.astype(np.float64)).astype(np.int64), 1)
    hit = (sf < q2) & (x[None, :] >= x0[:, None])
    first = np.where(hit.any(axis=1), hit.argmax(axis=1) + 1, s + 1)
    xs = np.where(hit.any(axis=1), first - 1, s + 1)
    xs = np.where(x0 > s, x0, xs)
    return np.array([j2md(_f32(_f32(int(xv)) / s), k) for xv in xs],
                    np.float32)


_TABLES: dict = {}


def sketch_tables(s: int, k: int, perc_identity: float):
    """For sketch size s: (identity[c], identity upper bound[c]) float32
    for c in 0..s (computeMap.hpp:375-381) and the L1 minimum hits,
    max(1, estimateMinimumHitsRelaxed) (map_stats.hpp:142-167)."""
    key = (s, k, perc_identity)
    if key not in _TABLES:
        lower = _lower_bounds(s, k)
        ident = np.zeros(s + 1, np.float32)
        upper = np.zeros(s + 1, np.float32)
        for c in range(s + 1):
            mash = j2md(_f32(1.0 * c / s), k)
            ident[c] = _f32(_f32(100) * _f32(_f32(1) - mash))
            upper[c] = _f32(_f32(100) * _f32(_f32(1) - lower[c]))
        first = estimate_minimum_hits(s, k, perc_identity)
        hits = first
        for i in range(min(first, s), -1, -1):
            if _f32(100.0 * (1.0 - float(lower[i]))) >= perc_identity:
                hits = i
            else:
                break
        _TABLES[key] = (ident, upper, max(1, hits))
    return _TABLES[key]
