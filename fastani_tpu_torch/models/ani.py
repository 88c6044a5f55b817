"""ANI results from the device CGI matrices (counterpart of
``fastani_tpu/models/ani.py``: ``CGIResult`` and ``results_from_matrices``).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class CGIResult:
    qry_genome: int       # index into params.query_sequences
    ref_genome: int       # index into params.ref_sequences
    count_seq: int
    total_query_fragments: int
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
