"""Mash statistics (counterpart of ``fastani_tpu/ops/stats.py``).

Host-side NumPy/SciPy replication of the reference's statistical layer
(reference: src/map/include/map_stats.hpp:36-257) with the same float32 /
float64 promotion points, so identity values match bit for bit.

``identity_tables`` holds the JAX package's ``identity_lut`` for every
sketch size at once: it runs the reference's per-(s, c) confidence-interval
search for all entries together, evaluating the binomial survival function
for every still-searching entry in one vectorized ``binom.sf`` call per
search step, with the transcendental steps in ``math.log``/``math.exp`` per
element exactly as the scalar functions do.  The values are those of the
scalar functions below (the tests hold them equal); the tables for
s <= 320 take a second instead of a minute, so no disk cache is needed.
"""

from __future__ import annotations

import functools
import math

import numpy as np
from scipy.stats import binom

_f32 = np.float32


def j2md(j: float, k: int) -> np.float32:
    """Jaccard estimate -> mash distance (map_stats.hpp:44-54)."""
    j = _f32(j)
    if j == 0:
        return _f32(1.0)
    if j == 1:
        return _f32(0.0)
    denom = _f32(_f32(1) + j)
    return _f32((-1.0 / k) * math.log(2.0 * float(j) / float(denom)))


def md2j(d: float, k: int) -> np.float32:
    """Mash distance -> jaccard estimate (map_stats.hpp:62-66)."""
    d = _f32(d)
    kd = _f32(np.int32(k) * d)
    return _f32(1.0 / (2.0 * math.exp(float(kd)) - 1.0))


def _binom_sf(x_minus_1, p, n):
    """P(X >= x) for X ~ Binom(n, p) — gsl_cdf_binomial_Q(x-1, p, n)."""
    return binom.sf(x_minus_1, n, p)


def md_lower_bound(d: float, s: int, k: int, ci: float) -> np.float32:
    """Lower bound on mash distance d within confidence interval ``ci``
    (map_stats.hpp:79-111, including the post-loop ``x--`` and the
    x = s+1 fall-through)."""
    q2 = (1.0 - ci) / 2.0
    j = md2j(d, k)
    x = max(int(math.ceil(s * float(j))), 1)
    while x <= s:
        if float(_binom_sf(x - 1, float(j), s)) < q2:
            x -= 1
            break
        x += 1
    jaccard = _f32(_f32(x) / s)
    return j2md(jaccard, k)


def estimate_minimum_hits(s: int, k: int, perc_identity: float) -> int:
    """Minimum shared sketches for the target identity (map_stats.hpp:120-131)."""
    mash_dist = _f32(1.0 - perc_identity / 100.0)
    jaccard = md2j(mash_dist, k)
    return int(math.ceil(1.0 * s * float(jaccard)))


def estimate_minimum_hits_relaxed(s: int, k: int, perc_identity: float) -> int:
    """Relaxed minimum using the 90% CI upper bound (map_stats.hpp:142-167)."""
    first = estimate_minimum_hits(s, k, perc_identity)
    result = first
    for i in range(first, -1, -1):
        jaccard = _f32(1.0 * i / s)
        d = j2md(jaccard, k)
        d_lower = md_lower_bound(d, s, k, 0.9)
        id_upper = _f32(100.0 * (1.0 - float(d_lower)))
        if id_upper >= perc_identity:
            result = i
        else:
            break
    return result


def estimate_pvalue(s: int, k: int, alphabet_size: int, identity: float,
                    length_query: int, length_reference: int) -> float:
    """Random-match p-value model (map_stats.hpp:179-213)."""
    kmer_space = float(alphabet_size) ** k
    px = py = 1.0 / (1.0 + kmer_space / length_query)
    r = px * py / (px + py - px * py)
    x = estimate_minimum_hits_relaxed(s, k, identity)
    cdf_complement = 1.0 if x == 0 else float(_binom_sf(x - 1, r, s))
    return length_reference * cdf_complement


def recommended_window_size(p_value_cutoff: float, k: int,
                            alphabet_size: int, identity: float,
                            length_query: int, length_reference: int) -> int:
    """Smallest sketch rate meeting the p-value cutoff (map_stats.hpp:226-256);
    24 for the reference defaults."""
    potential = [1, 2, 5] + list(range(10, length_query, 10))
    optimal = None
    for e in potential:
        if estimate_pvalue(e, k, alphabet_size, identity, length_query,
                           length_reference) <= p_value_cutoff:
            optimal = e
            break
    if optimal is None:
        raise ValueError("no sketch size satisfies the p-value cutoff")
    w = int(2.0 * length_query / optimal)
    return min(max(w, 1), length_query)


# ---------------------------------------------------------------------------
# Lookup tables (vectorized over all (s, c) entries)
# ---------------------------------------------------------------------------


def _j2md_vec(j: np.ndarray, k: int) -> np.ndarray:
    """j2md over a float32 array (same rounding points, math.log per entry)."""
    j = j.astype(np.float32)
    denom = (_f32(1) + j).astype(np.float32)
    out = np.empty(j.shape, np.float32)
    for i, (jv, dv) in enumerate(zip(j.tolist(), denom.tolist())):
        if jv == 0:
            out[i] = 1.0
        elif jv == 1:
            out[i] = 0.0
        else:
            out[i] = _f32((-1.0 / k) * math.log(2.0 * jv / dv))
    return out


def _md2j_vec(d: np.ndarray, k: int) -> np.ndarray:
    kd = (np.int32(k) * d.astype(np.float32)).astype(np.float32)
    return np.array([_f32(1.0 / (2.0 * math.exp(v) - 1.0)) for v in kd.tolist()],
                    np.float32)


def _md_lower_bound_vec(d: np.ndarray, s: np.ndarray, k: int,
                        ci: float) -> np.ndarray:
    """md_lower_bound for many (d, s) pairs: the x-search advances every
    unfinished entry by one step per vectorized binom.sf call."""
    q2 = (1.0 - ci) / 2.0
    j = _md2j_vec(d, k)
    jf = j.astype(np.float64)
    s = s.astype(np.int64)
    x = np.maximum(np.ceil(s * jf).astype(np.int64), 1)
    done = np.zeros(len(x), bool)
    while True:
        act = np.nonzero(~done & (x <= s))[0]
        if not len(act):
            break
        sf = _binom_sf(x[act] - 1, jf[act], s[act])
        hit = sf < q2
        x[act[hit]] -= 1
        done[act[hit]] = True
        x[act[~hit]] += 1
    jac = (x.astype(np.float32) / s.astype(np.float32)).astype(np.float32)
    return _j2md_vec(jac, k)


def _identity_entries(k: int, s_all: np.ndarray, c_all: np.ndarray):
    """(identity, upper bound) float32 for each (s, c) entry:
    computeMap.hpp:375-381 (mash = j2md(c/s); lower = md_lower_bound(mash,
    s, k, 0.9); identity = 100*(1-mash); upper = 100*(1-lower))."""
    jac = np.array([_f32(1.0 * c / s) for c, s in zip(c_all.tolist(),
                                                       s_all.tolist())],
                   np.float32)
    mash = _j2md_vec(jac, k)
    lower = _md_lower_bound_vec(mash, s_all, k, 0.9)
    ident = (_f32(100) * (_f32(1) - mash).astype(np.float32)).astype(np.float32)
    upper = (_f32(100) * (_f32(1) - lower).astype(np.float32)).astype(np.float32)
    return ident, upper


@functools.lru_cache(maxsize=None)
def identity_tables(k: int, s_max: int):
    """(ident, upper) float32 (s_max+1, s_max+1) tables indexed [s, c]
    (entries with c > s, and row 0, are zero)."""
    s_all = np.concatenate([np.full(s + 1, s, np.int64)
                            for s in range(1, s_max + 1)])
    c_all = np.concatenate([np.arange(s + 1, dtype=np.int64)
                            for s in range(1, s_max + 1)])
    ident, upper = _identity_entries(k, s_all, c_all)
    ti = np.zeros((s_max + 1, s_max + 1), np.float32)
    tu = np.zeros((s_max + 1, s_max + 1), np.float32)
    ti[s_all, c_all] = ident
    tu[s_all, c_all] = upper
    return ti, tu


@functools.lru_cache(maxsize=None)
def min_hits_lut(k: int, perc_identity: float, s_max: int) -> np.ndarray:
    """minimumHits for every sketch size s in [0, s_max]: entry s =
    max(1, estimateMinimumHitsRelaxed(s, k, id)) (computeMap.hpp:301,
    :316-317); entry 0 is a placeholder 1."""
    out = np.ones(s_max + 1, dtype=np.int32)
    for s in range(1, s_max + 1):
        out[s] = max(1, estimate_minimum_hits_relaxed(s, k, perc_identity))
    return out


@functools.lru_cache(maxsize=None)
def identity_row(s: int, k: int):
    """(identity[c], upper[c]) float32 for c = 0..s: row s of
    ``identity_tables`` alone (the JAX package's ``identity_lut(s, k)``)."""
    return _identity_entries(k, np.full(s + 1, s, np.int64),
                             np.arange(s + 1, dtype=np.int64))


def identities_for(shared: np.ndarray, sketch_sizes: np.ndarray, k: int):
    """Per-row (identity, upper bound) float32 of (shared count, sketch
    size) pairs (computeMap.hpp:375-381); rows with s <= 0 stay zero."""
    shared = np.asarray(shared)
    sketch_sizes = np.asarray(sketch_sizes)
    ident = np.zeros(shared.shape, np.float32)
    upper = np.zeros(shared.shape, np.float32)
    for s in np.unique(sketch_sizes).tolist():
        if s <= 0:
            continue
        lut_i, lut_u = identity_row(int(s), k)
        sel = sketch_sizes == s
        c = np.clip(shared[sel], 0, int(s))
        ident[sel] = lut_i[c]
        upper[sel] = lut_u[c]
    return ident, upper
