"""Scalar oracle of the reference mapping engine (counterpart of
``fastani_tpu/utils/refmodel.py``).

A literal re-statement of the reference's per-fragment control flow
(src/map/include/computeMap.hpp:204-497, slidingMap.hpp,
MIIteratorL2.hpp:74-96), on the host, one fragment at a time.  It maps the
fragments that need a capacity cap past a kernel's width limit
(``models/glue.py``), and is the tests' oracle for single fragments.

The SlideMapper's incremental counter equals the closed form
    S(W) = |{h : h in QH and h in RH(W) and rank_of_h_in(QH ∪ RH(W)) < s}|
(QH = the query's s unique sketch hashes; RH(W) = the set of reference
hashes in super-window W), so the model computes that closed form inside
the exact event-driven window walk of MIIteratorL2.

It reads an index's ``host_view()`` (numpy arrays of the true entries).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Tuple

import numpy as np
import torch

from fastani_tpu_torch.ops import hashing, stats


@dataclasses.dataclass
class L1Candidate:
    seq_id: int
    range_start: int
    range_end: int


@dataclasses.dataclass
class Mapping:
    query_seq_id: int
    ref_seq_id: int
    ref_start_pos: int
    nuc_identity: np.float32
    nuc_identity_upper: np.float32
    conserved: int
    sketch_size: int
    query_len: int


def winnow_model(seq: np.ndarray, k: int, w: int):
    """The reference's deque winnowing (commonFunc.hpp:92-167) step by
    step over one sequence.  Returns (hash int64 u32 values, wpos int32)
    of the emitted minimizers."""
    seq = hashing.upper_np(np.asarray(seq, dtype=np.uint8))
    L = len(seq)
    if L - k + 1 <= 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int32)
    t = torch.from_numpy(seq)
    hf = hashing.kmer_hashes(t, k).tolist()
    hb = hashing.kmer_hashes(hashing.revcomp(t), k).tolist()
    out_h, out_w = [], []
    q = deque()       # entries [hash, push position, wpos (set on emit)]
    last_emitted = None
    for i in range(L - k + 1):
        cwid = i - w + 1
        fwd, bwd = hf[i], hb[L - i - k]
        if fwd == bwd:              # symmetric k-mer: skipped entirely
            continue
        cur = min(fwd, bwd)
        while q and q[0][1] <= i - w:
            q.popleft()
        while q and q[-1][0] >= cur:
            q.pop()
        q.append([cur, i, -1])
        if cwid >= 0:
            front = q[0]
            if last_emitted is None or (front[0], front[2]) != last_emitted:
                front[2] = cwid
                out_h.append(front[0])
                out_w.append(cwid)
                last_emitted = (front[0], cwid)
    return np.array(out_h, np.int64), np.array(out_w, np.int32)


def fragment_sketch(frag: np.ndarray, k: int, w: int) -> np.ndarray:
    """Sorted unique minimizer hashes of a fragment (computeMap.hpp:260-274)."""
    h, _ = winnow_model(frag, k, w)
    return np.unique(h)


def l1_candidates(q_hashes: np.ndarray, index, minimum_hits: int,
                  frag_len: int) -> List[L1Candidate]:
    """L1 stage (computeMap.hpp:252-354) against a host index."""
    minimum_hits = max(minimum_hits, 1)
    hits_sid: List[int] = []
    hits_wp: List[int] = []
    for h in q_hashes:
        lo = np.searchsorted(index.occ_hash, h, side="left")
        hi = np.searchsorted(index.occ_hash, h, side="right")
        if hi > lo and (hi - lo) < index.freq_threshold:
            hits_sid.extend(index.occ_seqid[lo:hi].tolist())
            hits_wp.extend(index.occ_wpos[lo:hi].tolist())
    if not hits_sid:
        return []
    order = np.lexsort((hits_wp, hits_sid))
    sid = np.asarray(hits_sid)[order]
    wp = np.asarray(hits_wp)[order]
    out: List[L1Candidate] = []
    for i in range(len(sid)):
        j = i + minimum_hits - 1
        if j >= len(sid):
            break
        if sid[j] == sid[i] and wp[j] - wp[i] < frag_len:
            start = max(0, int(wp[j]) - frag_len + 1)
            end = int(wp[i])
            if out and out[-1].seq_id == sid[i] and out[-1].range_end >= start:
                out[-1].range_end = max(end, out[-1].range_end)
            else:
                out.append(L1Candidate(int(sid[i]), start, end))
    return out


def _search_index(index, seq_id: int, winpos: int) -> int:
    """lower_bound on (seqId, wpos) pairs (winSketch.hpp:259-270)."""
    lo = int(np.searchsorted(index.mi_seqid, seq_id, side="left"))
    hi = int(np.searchsorted(index.mi_seqid, seq_id, side="right"))
    return lo + int(np.searchsorted(index.mi_wpos[lo:hi], winpos,
                                    side="left"))


def _shared_sketch(q_hashes: np.ndarray, ref_hashes: np.ndarray,
                   s: int) -> int:
    """Closed form of SlideMapper.sharedSketchElements."""
    ref_set = np.unique(ref_hashes)
    bottom = set(np.union1d(q_hashes, ref_set)[:s].tolist())
    return len(bottom & set(q_hashes.tolist()) & set(ref_set.tolist()))


def l2_map(q_hashes: np.ndarray, index, cand: L1Candidate, frag_len: int,
           k: int, w: int) -> Tuple[int, int]:
    """L2 stage for one candidate (computeMap.hpp:418-497): the
    event-driven super-window walk of MIIteratorL2::next, with its loop
    bounds and the first/last argmax position average.  Returns
    (shared sketch size, mean optimal position)."""
    s = len(q_hashes)
    C = frag_len - (w - 1) - (k - 1)      # countMinimizerWindows
    M = index.num_entries
    b = _search_index(index, cand.seq_id, cand.range_start)
    if b >= M:
        # the reference would dereference end(); candidates have an entry
        return 0, 0
    sw_pos = int(index.mi_wpos[b])
    e = _search_index(index, cand.seq_id, sw_pos + C)
    e_last = _search_index(index, cand.seq_id, cand.range_end + frag_len)
    best = 0
    begin_opt = last_opt = None
    while e_last - e > 0:
        shared = _shared_sketch(q_hashes, index.mi_hash[b:e], s)
        if shared > best:
            best = shared
            begin_opt = last_opt = int(index.mi_wpos[b])
        elif shared == best:
            last_opt = int(index.mi_wpos[b])
        # MIIteratorL2::next (MIIteratorL2.hpp:74-96)
        nb = int(index.mi_wpos[b + 1]) - sw_pos if b + 1 < M else 1 << 30
        ne = int(index.mi_wpos[e]) - (sw_pos + C - 1) if e < M else 1 << 30
        adv = min(nb, ne)
        sw_pos += adv
        if adv == nb:
            b += 1
        if adv == ne:
            e += 1
    if best == 0 or begin_opt is None:
        return best, 0      # the reference reads uninitialized ints; unused
    return best, (begin_opt + last_opt) // 2


def map_fragment(frag: np.ndarray, index, params,
                 query_seq_id: int) -> List[Mapping]:
    """Map one fragment (computeMap.hpp:204-240, then L1 and L2), gated by
    the identity's upper bound (computeMap.hpp:375-403)."""
    k, w, l = params.kmer_size, params.window_size, params.frag_len
    q_hashes = fragment_sketch(frag, k, w)
    s = len(q_hashes)
    if s == 0:
        return []
    min_hits = stats.estimate_minimum_hits_relaxed(
        s, k, params.percentage_identity)
    lut_i, lut_u = stats.identity_row(s, k)
    out: List[Mapping] = []
    for cand in l1_candidates(q_hashes, index, min_hits, l):
        shared, mean_pos = l2_map(q_hashes, index, cand, l, k, w)
        if lut_u[shared] >= params.percentage_identity:
            out.append(Mapping(query_seq_id, cand.seq_id, mean_pos,
                               lut_i[shared], lut_u[shared], shared, s, l))
    return out
