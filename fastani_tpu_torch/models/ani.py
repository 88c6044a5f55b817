"""ANI aggregation (counterpart of ``fastani_tpu/models/ani.py``:
``CGIResult``, ``VisualRow``, ``results_from_matrices`` and
``compute_cgi_arrays``).

``results_from_matrices`` reads the device CGI's (Gq, Gr) matrices;
``compute_cgi_arrays`` is the host fold of cgi::computeCGI
(src/cgi/include/computeCoreIdentity.hpp:166-298) over one query genome's
mapping rows, with the reference's float32 accumulation order.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class CGIResult:
    qry_genome: int       # index into params.query_sequences
    ref_genome: int       # index into params.ref_sequences
    count_seq: int
    total_query_fragments: int
    identity: np.float32


@dataclasses.dataclass
class VisualRow:
    """One reciprocal mapping destined for the .visual file."""
    genome_id: int
    ref_seq_id: int
    query_seq_id: int
    ref_start: int
    query_start: int
    identity: np.float32


def results_from_matrices(counts: np.ndarray, sums: np.ndarray,
                          total_fragments) -> List[CGIResult]:
    """(Gq, Gr) count / identity-sum matrices -> CGIResult rows: the
    per-pair mean of computeCoreIdentity.hpp:267-297.  total_fragments is
    a callable(qno) or indexable."""
    rows: List[CGIResult] = []
    Gq, Gr = counts.shape
    for q in range(Gq):
        tq = total_fragments(q) if callable(total_fragments) \
            else total_fragments[q]
        for g in range(Gr):
            if counts[q, g] > 0:
                rows.append(CGIResult(
                    q, g, int(counts[q, g]), tq,
                    np.float32(sums[q, g] / np.float32(counts[q, g]))))
    return rows


def compute_cgi_arrays(ref_sid, qsid, ref_start, ident,
                       genome_of_seq: np.ndarray, frag_len: int,
                       query_file_no: int, total_query_fragments: int,
                       want_visual: bool = True
                       ) -> Tuple[List[CGIResult], List[VisualRow]]:
    """computeCoreIdentity.hpp:166-298 over one query genome's mapping
    rows.  Returns per-reference-genome CGI rows and the 2-way
    (reciprocal-best) mappings in the order the reference writes them to
    the .visual file (empty when ``want_visual`` is False)."""
    if len(ref_sid) == 0:
        return [], []
    ref_sid = np.asarray(ref_sid, np.int64)
    qsid = np.asarray(qsid, np.int64)
    ref_start = np.asarray(ref_start, np.int64)
    ident = np.asarray(ident, np.float32)
    qstart = np.zeros(len(ref_sid), np.int64)  # queryStartPos is always 0
    gid = np.asarray(genome_of_seq)[ref_sid]
    pos_bin = ref_start // (frag_len - 20)  # computeCoreIdentity.hpp:194

    # 1-way: best per (genomeId, querySeqId); ascending sort + keep-last is
    # the overwrite loop at :212-232 with the tie-breakers of
    # cmp_query_bucket (cgid_types.hpp:31-39)
    o1 = np.lexsort((ref_start, ref_sid, ident, qsid, gid))
    g1, q1 = gid[o1], qsid[o1]
    is_last1 = np.ones(len(o1), bool)
    is_last1[:-1] = (g1[:-1] != g1[1:]) | (q1[:-1] != q1[1:])
    k1 = o1[is_last1]

    # 2-way: best per (refSequenceId, mapRefPosBin) among the 1-way rows
    # (:237-255); cmp_refbin_bucket breaks no tie beyond identity, so
    # (querySeqId, queryStartPos) are added for determinism
    o2 = k1[np.lexsort((qstart[k1], qsid[k1], ident[k1], pos_bin[k1],
                        ref_sid[k1]))]
    r2, b2 = ref_sid[o2], pos_bin[o2]
    is_last2 = np.ones(len(o2), bool)
    is_last2[:-1] = (r2[:-1] != r2[1:]) | (b2[:-1] != b2[1:])
    k2 = o2[is_last2]

    visual = [VisualRow(int(gid[i]), int(ref_sid[i]), int(qsid[i]),
                        int(ref_start[i]), int(qstart[i]), ident[i])
              for i in k2] if want_visual else []

    # per-genome mean identity (:267-297): k2 is sorted by refSeqId, so a
    # genome's rows are contiguous; the fold stays a sequential float32
    # accumulation, the only order that matches the reference bit for bit
    out: List[CGIResult] = []
    g2, id2 = gid[k2], ident[k2]
    bounds = np.concatenate([[0], np.nonzero(g2[1:] != g2[:-1])[0] + 1,
                             [len(k2)]])
    for lo, hi in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        acc = np.float32(0.0)
        for v in id2[lo:hi]:
            acc = np.float32(acc + v)
        count = hi - lo
        out.append(CGIResult(query_file_no, int(g2[lo]), count,
                             total_query_fragments,
                             np.float32(acc / np.float32(count))))
    return out, visual
