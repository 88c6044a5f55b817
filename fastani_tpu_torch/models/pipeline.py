"""The fast ANI path, FASTA to TSV (counterpart of ``run_fast`` in
``fastani_tpu/models/pipeline.py`` and the pieces it runs).

``run_fast``: device index build -> Mapper -> one plain loop over fragment
batches, each mapped and folded into the device CGI table, finished query
genomes closed as the loop passes them -> one readout of the (Gq, Gr)
matrices -> TSV and optional phylip matrix.  Reference semantics:
src/cgi/core_genome_identity.cpp:27-167.

A real fragment that overflows a capacity cap (sketch, L1, L2 or unit)
raises ``CapOverflowError`` naming the cap and the observed value; the
exact redo of such fragments is not ported yet.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from fastani_tpu_torch.config import Parameters, scale_caps
from fastani_tpu_torch.index.sketch import ReferenceIndex
from fastani_tpu_torch.io import fasta
from fastani_tpu_torch.models import ani, device_cgi, jitmap, output
from fastani_tpu_torch.ops import hashing
from fastani_tpu_torch.ops.cuda import resolve_device


class CapOverflowError(RuntimeError):
    """A real fragment overflowed a capacity cap of the fixed-width path."""


def load_query_fragments(path: str, params: Parameters) -> np.ndarray:
    """Cut one query genome into (F, frag_len) uppercased rows: contigs
    shorter than the fragment length (or w, k) are skipped, each other
    contig gives len // frag_len fragments (computeMap.hpp:140-167); row i
    is the fragment with querySeqId i."""
    l = params.frag_len
    k, w = params.kmer_size, params.window_size
    blocks: List[np.ndarray] = []
    for _, seq in fasta.read_sequences(path):
        L = len(seq)
        if L < w or L < k or L < l:
            continue
        fc = L // l
        blocks.append(hashing.upper_np(seq[: fc * l]).reshape(fc, l))
    return np.concatenate(blocks) if blocks else np.zeros((0, l), np.uint8)


class FragmentStream:
    """Global-row view over the query genomes, parsed once for the batch
    plan and reloaded on demand while batches consume them (only the
    genomes under the current batch stay in host memory)."""

    def __init__(self, paths, params: Parameters):
        self.paths = list(paths)
        self.params = params
        self._cache: Dict[int, np.ndarray] = {}
        self.counts = [len(load_query_fragments(p, params))
                       for p in self.paths]
        self.offsets = np.concatenate([[0], np.cumsum(self.counts)]
                                      ).astype(np.int64)
        self.F = int(self.offsets[-1])

    def qno_of_row(self, row: int) -> int:
        return int(np.searchsorted(self.offsets, row, side="right")) - 1

    def total_fragments(self, qno: int) -> int:
        return self.counts[qno]

    def get_query(self, qno: int) -> np.ndarray:
        if qno not in self._cache:
            self._cache[qno] = load_query_fragments(self.paths[qno], self.params)
        return self._cache[qno]

    def evict_up_to(self, qno: int) -> None:
        for q in [q for q in self._cache if q < qno]:
            del self._cache[q]

    def make_batch(self, b0: int, B: int):
        """Rows [b0, min(b0 + B, F)).  Returns (frags (n, L) u8, qno_row
        (n,) i32, gid_row (n,) i32)."""
        n = min(B, self.F - b0)
        frags = np.zeros((n, self.params.frag_len), np.uint8)
        qno_row = np.zeros(n, np.int32)
        gid_row = np.zeros(n, np.int32)
        r = 0
        qno = self.qno_of_row(b0)
        while r < n:
            qf = self.get_query(qno)
            lo = b0 + r - int(self.offsets[qno])
            take = min(n - r, len(qf) - lo)
            frags[r:r + take] = qf[lo:lo + take]
            qno_row[r:r + take] = qno
            gid_row[r:r + take] = np.arange(lo, lo + take)
            r += take
            qno += 1
        return frags, qno_row, gid_row


def cgi_stream_schedule(stream: FragmentStream, B: int, n_query_genomes: int):
    """Static slot / finalize plan: per-batch lists of query genomes whose
    fragments all precede the batch, the leftover list after the last
    batch, and the slot-ring size (most distinct query genomes in one
    batch; consecutive qnos, so slot = qno % n_slots never collides).
    Only genomes that own fragments are listed."""
    F = stream.F
    starts = list(range(0, F, B))
    q_lo = [stream.qno_of_row(b0) for b0 in starts]
    q_hi = [stream.qno_of_row(min(b0 + B, F) - 1) for b0 in starts]
    n_slots = max((hi - lo + 1 for lo, hi in zip(q_lo, q_hi)), default=1)
    has_frags = [stream.counts[i] > 0 for i in range(n_query_genomes)]
    fins, ptr = [], 0
    for lo in q_lo:
        fins.append([q for q in range(ptr, lo) if has_frags[q]])
        ptr = max(ptr, lo)
    tail = [q for q in range(ptr, n_query_genomes) if has_frags[q]]
    return starts, fins, tail, n_slots


def _overflow_message(cfg, c: Dict[str, int], n_real: int) -> str:
    caps = []
    if c["sk_overflow"]:
        caps.append(f"sketch_cap={cfg.sketch_cap} (max unique minimizers "
                    f"per fragment {c['max_s']})")
    if c["l1_overflow"]:
        caps.append(f"hits_cap={cfg.hits_cap} (max L1 hits {c['max_hits']}) "
                    f"or cand_cap={cfg.cand_cap} (max candidate regions "
                    f"{c['max_groups']})")
    if c["l2_overflow"]:
        caps.append(f"l2_entry_cap={cfg.l2_entry_cap} (max entry span "
                    f"{c['max_span']})")
    if c["unit_overflow"]:
        caps.append(f"unit_cap={cfg.unit_cap} (units {c['n_units']})")
    return (f"{n_real} real fragment(s) overflowed: " + "; ".join(caps)
            + " — the exact redo of overflowed fragments is not ported")


def map_queries_cgi_device(stream: FragmentStream, index: ReferenceIndex,
                           params: Parameters, mapper: "jitmap.Mapper",
                           n_query_genomes: int, n_ref_genomes: int,
                           stats: Optional[dict] = None):
    """Map every query fragment and fold the rows into per-genome-pair
    (counts, sums) on the device; one plain loop over batches.  Returns
    host (counts (Gq, Gr) int32, sums (Gq, Gr) float32)."""
    dev = index.device
    B = params.frag_batch
    starts, fins, tail, n_slots = cgi_stream_schedule(stream, B,
                                                      n_query_genomes)
    cgi = device_cgi.StreamingCGI(index, params, n_query_genomes,
                                  n_ref_genomes, n_slots=n_slots, frag_cap=B)
    for i, b0 in enumerate(starts):
        if fins[i]:
            cgi.finalize_list(fins[i])
        frags, qno_row, gid_row = stream.make_batch(b0, B)
        as_t = lambda a: torch.as_tensor(a, device=dev)
        out = mapper.map_batch(as_t(frags), as_t(qno_row), as_t(gid_row))
        counts = dict(zip(jitmap.COUNT_NAMES, out["counts"].tolist()))
        if stats is not None:
            for key, v in counts.items():
                stats[key] = max(v, stats.get(key, 0))
            stats["batches"] = stats.get("batches", 0) + 1
        n_fb = 0
        if any(counts[key] for key in jitmap.COUNT_NAMES[1:5]):
            n_fb = int(out["fallback_mask"].sum())
            if n_fb:
                raise CapOverflowError(_overflow_message(mapper.cfg, counts,
                                                         n_fb))
        if stats is not None:
            stats["fallback_frags"] = stats.get("fallback_frags", 0) + n_fb
        cgi.update(out["packed"], counts["n_valid"])
        stream.evict_up_to(stream.qno_of_row(b0))
    if tail:
        cgi.finalize_list(tail)
    return cgi.result()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_fast(params: Parameters, device="cuda",
             log=lambda msg: print(msg, file=sys.stderr),
             stats: Optional[dict] = None) -> List[ani.CGIResult]:
    """Device index build + map/fold stream + one readout; writes the TSV
    (and ``.matrix`` with params.matrix_output).  Runs on ``cuda`` unless
    the caller asks for ``cpu``; raises if no card is present.  ``stats``,
    when given, receives phase wall times and the counters' maxima."""
    dev = resolve_device(device)
    stats = {} if stats is None else stats
    params.finalize()
    G = len(params.ref_sequences)
    scale_caps(G, params)

    t0 = time.time()
    index = ReferenceIndex.build_device(params, device=dev)
    _sync(dev)
    stats["t_index_build"] = time.time() - t0
    log(f"INFO, fastani_tpu_torch, reference sketched on {dev} in "
        f"{stats['t_index_build']:.2f}s: {index.n_entries} minimizers "
        f"(window size {params.window_size})")

    t0 = time.time()
    mapper = jitmap.Mapper(params, index, unit_factor=max(G + 2, int(1.7 * G) + 8),
                           unit_chunk=min(512, params.frag_batch))
    stream = FragmentStream(params.query_sequences, params)
    _sync(dev)
    stats["t_mapper_init"] = time.time() - t0

    t0 = time.time()
    n_q = len(stream.paths)
    counts, sums = map_queries_cgi_device(stream, index, params, mapper,
                                          n_q, G, stats=stats)
    stats["t_map_fold"] = time.time() - t0
    log(f"INFO, fastani_tpu_torch, mapped {n_q} queries ({stream.F} "
        f"fragments) + device CGI in {stats['t_map_fold']:.2f}s")

    t0 = time.time()
    final = ani.results_from_matrices(counts, sums, stream.total_fragments)
    if params.out_file_name:
        genome_lengths: Dict[str, int] = {}
        for e in list(params.query_sequences) + list(params.ref_sequences):
            if e not in genome_lengths:
                genome_lengths[e] = fasta.genome_length_for_ani(
                    e, params.frag_len)
        output.write_cgi(final, genome_lengths, params, params.out_file_name)
        if params.matrix_output:
            output.write_phylip(final, genome_lengths, params,
                                params.out_file_name)
    stats["t_write"] = time.time() - t0
    return final
