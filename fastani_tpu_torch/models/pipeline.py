"""The fast ANI path, FASTA to TSV (counterpart of ``run_fast`` in
``fastani_tpu/models/pipeline.py`` and the pieces it runs).

``run_fast``: device index build -> Mapper -> one plain loop over fragment
batches, each mapped and folded into the device CGI table, finished query
genomes closed as the loop passes them -> one readout of the (Gq, Gr)
matrices -> TSV and optional phylip matrix.  Reference semantics:
src/cgi/core_genome_identity.cpp:27-167.

A query genome that owns a fragment over a capacity cap (sketch, L1, L2
or unit) is redone exactly once the stream has passed: the device CGI
leaves the overflowed fragments out, and the genome's whole row of the
(Gq, Gr) matrices is replaced by the host fold of its fragments mapped
again with caps sized to what the counters observed
(``_redo_query_exact``).  ``CapOverflowError`` is left only for a
data-sized cap past a kernel's width limit.
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
from fastani_tpu_torch.models import ani, device_cgi, jitmap, l2walk, output
from fastani_tpu_torch.ops import hashing, sort
from fastani_tpu_torch.ops.cuda import resolve_device
from fastani_tpu_torch.ops.stats import identities_for


class CapOverflowError(RuntimeError):
    """A data-sized cap of the exact redo passes a kernel's width limit."""


# cap -> (the counter that sizes it, rounding step, largest width the
# kernels take or None, what sets that limit).  The L2 event records hold
# ranks in 10 bits; K3 sorts rows of up to sort.MAX_KEYS hit keys
_CAPS = {
    "sketch_cap": ("max_s", 64, l2walk.MAX_SCAP, "the L2 event record"),
    "hits_cap": ("max_hits", 1024, sort.MAX_KEYS, "the K3 row sort"),
    "cand_cap": ("max_groups", 64, None, None),
    "l2_entry_cap": ("max_span", 128, l2walk.MAX_NCAP,
                     "the L2 event record"),
    "unit_cap": ("n_units", 1024, None, None),
}


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


def _grown_caps(cfg, c: Dict[str, int]) -> Dict[str, int]:
    """Caps that hold what the counters ``c`` of an overflowing batch
    observed, each rounded up to its step.  Raises ``CapOverflowError``
    where a fragment needs more than a kernel's width limit."""
    caps = {}
    for cap, (counter, step, limit, holder) in _CAPS.items():
        cur, need = getattr(cfg, cap), c[counter]
        if cap == "sketch_cap" and c["sk_overflow"] and need <= cur:
            # the unique count fits: the emit row (>= 4 x sketch_cap wide,
            # mapping.sketch_fragments) overflowed, so widen both
            need = 2 * cur
        if need <= cur:
            continue
        if limit is not None and need > limit:
            raise CapOverflowError(
                f"{cap}: a fragment needs {need} ({counter} "
                f"{c[counter]}), past the limit of {limit} of {holder}")
        caps[cap] = -(-need // step) * step
        if limit is not None:
            caps[cap] = min(caps[cap], limit)
    return caps


def _redo_query_exact(qno: int, stream: FragmentStream,
                      params: Parameters, mapper: "jitmap.Mapper",
                      genome_of_seq: np.ndarray):
    """Exact (counts, sums) of one query genome a fragment of which
    overflowed a cap (the JAX package's ``_redo_query_exact``).  The 2-way
    dedupe couples a genome's fragments, so all of them are mapped again,
    on the index's device, batch by batch; a batch that overflows is mapped
    again with caps grown to its counters until none overflows.  The rows
    the map step marks valid are folded on the host (``ani.
    compute_cgi_arrays``).  Returns ({ref genome: (count, sum)}, the mapper
    with the caps that sufficed)."""
    frags = stream.get_query(qno)
    dev = mapper.index.device
    B = params.frag_batch
    rows = []
    for b0 in range(0, len(frags), B):
        f = torch.as_tensor(frags[b0:b0 + B], device=dev)
        gid = torch.arange(b0, b0 + len(f), dtype=torch.int32, device=dev)
        while True:
            out = mapper.map_batch(f, qsid_row=gid)
            c = dict(zip(jitmap.COUNT_NAMES, out["counts"].tolist()))
            if not any(c[key] for key in jitmap.COUNT_NAMES[1:5]):
                break
            caps = _grown_caps(mapper.cfg, c)
            if all(getattr(mapper.cfg, k) == v for k, v in caps.items()):
                raise CapOverflowError(f"a batch overflows at caps that "
                                       f"hold its counters: {c}")
            mapper = mapper.with_caps(**caps)
        rows.append(out["packed"][:, :c["n_valid"]].cpu().numpy())
    _, _, qsid, sid, shared, sketch, pos = np.concatenate(rows, axis=1)
    ident, upper = identities_for(shared, sketch, params.kmer_size)
    keep = upper >= np.float32(params.percentage_identity)
    res, _ = ani.compute_cgi_arrays(
        sid[keep], qsid[keep], pos[keep], ident[keep], genome_of_seq,
        params.frag_len, qno, stream.total_fragments(qno), want_visual=False)
    return {r.ref_genome: (r.count_seq,
                           np.float32(r.identity) * np.float32(r.count_seq))
            for r in res}, mapper


def map_queries_cgi_device(stream: FragmentStream, index: ReferenceIndex,
                           params: Parameters, mapper: "jitmap.Mapper",
                           n_query_genomes: int, n_ref_genomes: int,
                           stats: Optional[dict] = None):
    """Map every query fragment and fold the rows into per-genome-pair
    (counts, sums) on the device; one plain loop over batches, then the
    exact redo of each query genome that owns an overflowed fragment.
    Returns host (counts (Gq, Gr) int32, sums (Gq, Gr) float32)."""
    dev = index.device
    B = params.frag_batch
    starts, fins, tail, n_slots = cgi_stream_schedule(stream, B,
                                                      n_query_genomes)
    cgi = device_cgi.StreamingCGI(index, params, n_query_genomes,
                                  n_ref_genomes, n_slots=n_slots, frag_cap=B)
    redo = set()               # query genomes that own an overflowed fragment
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
            fb_rows = np.nonzero(out["fallback_mask"].cpu().numpy())[0]
            n_fb = len(fb_rows)
            redo.update(qno_row[fb_rows].tolist())
        if stats is not None:
            stats["fallback_frags"] = stats.get("fallback_frags", 0) + n_fb
        cgi.update(out["packed"], counts["n_valid"])
        stream.evict_up_to(stream.qno_of_row(b0))
    if tail:
        cgi.finalize_list(tail)
    counts, sums = cgi.result()
    # the device CGI left the overflowed fragments out; each genome that
    # owns one gets its row replaced by the exact redo's
    genome_of_seq = index.genome_of_seq()
    for qno in sorted(redo):
        row, mapper = _redo_query_exact(qno, stream, params, mapper,
                                        genome_of_seq)
        counts[qno, :] = 0
        sums[qno, :] = 0.0
        for g, (c, sm) in row.items():
            counts[qno, g] = c
            sums[qno, g] = sm
    if stats is not None:
        stats["redone_queries"] = len(redo)
    return counts, sums


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
