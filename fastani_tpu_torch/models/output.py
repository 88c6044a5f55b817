"""Output writers: ANI TSV, phylip-style matrix and the .visual mapping
dump (counterpart of ``fastani_tpu/models/output.py``).

Byte-compatible with the reference writers (computeCoreIdentity.hpp:
307-344 outputCGI, :353-448 outputPhylip, :103-153
outputVisualizationFile): identities print like C++ ``operator<<(float)``
(%.6g) in the TSV and the .visual file, and like std::to_string(float)
(%.6f) in the matrix.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from fastani_tpu_torch.models.ani import CGIResult, VisualRow


def _fmt_float(x: np.float32) -> str:
    """Default C++ ostream float formatting (6 significant digits)."""
    return f"{float(np.float32(x)):.6g}"


def sort_cgi_rows(rows: List[CGIResult]) -> List[CGIResult]:
    """Query genome ascending, identity descending (CGI_Results::operator<,
    computeCoreIdentity.hpp:313), reference genome as the tie-break."""
    return sorted(rows, key=lambda e: (e.qry_genome, -float(e.identity),
                                       e.ref_genome))


def passes_min_fraction(e: CGIResult, genome_lengths: Dict[str, int],
                        params) -> bool:
    qry = params.query_sequences[e.qry_genome]
    ref = params.ref_sequences[e.ref_genome]
    min_len = min(genome_lengths[qry], genome_lengths[ref])
    return e.count_seq * params.frag_len >= min_len * params.min_fraction


def write_cgi(rows: List[CGIResult], genome_lengths: Dict[str, int],
              params, path: str) -> None:
    with open(path, "w") as f:
        for e in sort_cgi_rows(rows):
            if not passes_min_fraction(e, genome_lengths, params):
                continue
            f.write("%s\t%s\t%s\t%d\t%d\n" % (
                params.query_sequences[e.qry_genome],
                params.ref_sequences[e.ref_genome],
                _fmt_float(e.identity), e.count_seq,
                e.total_query_fragments))


def write_phylip(rows: List[CGIResult], genome_lengths: Dict[str, int],
                 params, path: str) -> None:
    """Lower-triangular matrix with two-direction averaging
    (computeCoreIdentity.hpp:353-448)."""
    genome2int: Dict[str, int] = {}
    for e in list(params.query_sequences) + list(params.ref_sequences):
        if e not in genome2int:
            genome2int[e] = len(genome2int)
    names = {v: k for k, v in genome2int.items()}
    n = len(genome2int)
    mat = np.zeros((n, n), np.float32)
    for e in sort_cgi_rows(rows):
        if not passes_min_fraction(e, genome_lengths, params):
            continue
        qg = genome2int[params.query_sequences[e.qry_genome]]
        rg = genome2int[params.ref_sequences[e.ref_genome]]
        if qg == rg:
            continue
        i, j = (qg, rg) if qg > rg else (rg, qg)
        if mat[i][j] > 0:
            mat[i][j] = np.float32((mat[i][j] + e.identity) / 2)
        else:
            mat[i][j] = e.identity
    with open(path + ".matrix", "w") as f:
        f.write("%d\n" % n)
        for i in range(n):
            f.write(names[i])
            for j in range(i):
                val = "%.6f" % float(mat[i][j]) if mat[i][j] > 0.0 else "NA"
                f.write("\t" + val)
            f.write("\n")


def write_visual(visual_rows: List[VisualRow], params, query_file_no: int,
                 query_offsets: np.ndarray, ref_offsets: np.ndarray,
                 path: str, append: bool) -> None:
    """BLAST-outfmt6-like rows in genome-global coordinates
    (computeCoreIdentity.hpp:103-153).

    query_offsets: prefix sums over the query's visualization metadata
    (one entry per fragment and one per skipped short contig,
    computeMap.hpp:160-167), indexed directly by querySeqId as the
    reference does at :145-146 — so a short contig before a mapped one
    shifts that contig's offsets by one entry, as in the reference.
    ref_offsets: global offset of each reference contig."""
    l = params.frag_len
    with open(path + ".visual", "a" if append else "w") as f:
        for e in visual_rows:
            qoff = int(query_offsets[e.query_seq_id])
            roff = int(ref_offsets[e.ref_seq_id])
            f.write("%s\t%s\t%s\tNA\tNA\tNA\t%d\t%d\t%d\t%d\tNA\tNA\n" % (
                params.query_sequences[query_file_no],
                params.ref_sequences[e.genome_id],
                _fmt_float(e.identity),
                e.query_start + qoff, e.query_start + l - 1 + qoff,
                e.ref_start + roff, e.ref_start + l - 1 + roff))
