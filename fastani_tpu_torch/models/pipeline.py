"""The two ANI jobs, FASTA to TSV (counterpart of
``fastani_tpu/models/pipeline.py``: ``run_fast``, ``run`` and the pieces
they run, and of ``fastani_tpu/parallel/runner.py``: the same jobs over an
(r, q) grid).  Reference semantics: src/cgi/core_genome_identity.cpp:27-167.

Every job runs over an (r, q) grid of cells (``Grid``): reference shard r
(round-robin, ``parallel/mesh.py``) against slice q of each fragment
batch, one ``Mapper`` of the slice's height a shard.  A job without
``--mesh`` or ``--coordinator`` is the 1x1 grid with no process group:
one index, one mapper, one cell whose slice is the whole batch.  This
replaces the reference program's OpenMP shard loop and merge
(core_genome_identity.cpp:46-141) and its shell-level multi-node split
(scripts/splitDatabase.sh:14-39); ``parallel/distributed.py`` gives each
process its cells.

Every batch of a job has one shape, as in the JAX package: ``make_batch``
pads it to n_q x the slice height and returns the count of real rows, and
``Mapper.dispatch`` passes ``row_valid``, so on a card one captured set of
CUDA graphs a shard serves every slice of its cells, the tail's included;
a slice with no real row is skipped.

``run_fast``: device index build -> mappers -> ``map_queries_cgi_stream``
(each slice dispatched and folded into its cell's device CGI table,
finished query genomes closed as the loop passes them, their bin rows
first merged over the q cells of a shard; each slice's counts and
fallback mask stacked on the device; the host reads only the map step's
``n_live`` a slice) -> ``map_queries_cgi_finish`` (one read of the
stacks, the (Gq, Gr) matrices, the redo, the shards' matrices gathered to
process 0 at their global genome ids) -> TSV and optional phylip matrix.

``run`` (the exact path: ``--exact``, ``--visualize``, ``-s``): the same
index build and map step, slices dispatched two deep, but each slice's
valid rows are read back, renumbered to the unsharded index's seqIds
(``mesh.global_layout``), gathered to process 0 and folded on the host per
query genome (``ani.compute_cgi_arrays``, the reference's sequential
float32 fold), so the TSV and ``.matrix`` are byte-equal to the
reference's and the ``.visual`` file can be written.  Every reference
genome and contig lives in one shard and the fold's choices do not depend
on row order, so the union's fold is the single-device fold.  ``-s`` runs
each shard's repeat sanity check first; a failing shard maps nothing.

A fragment over a capacity cap (sketch, L1, L2 or unit) is left out by the
map step and mapped again exactly by ``glue.map_fallback_batch``: on the
index's device with caps grown to the counters, and, past a kernel's
width limit, by the scalar oracle.  ``run_fast`` does so for the whole
query genome that owns it, on every shard (``_redo_query_exact``: the
device CGI already folded the genome's other fragments), ``run`` for the
slice's overflowed fragments.

Both jobs take their indexes from ``reference_index`` (``build_shards``):
built on the device, or restored with ``--loadIndex`` (which also sets
the reference list, so it comes before anything counts the reference
genomes), and saved with ``--saveIndex``.  ``run_fast`` shrinks hits_cap
to the workload before its loop at n_r = 1 (``autotune_hits_cap``).
Process 0 writes the files and returns the CGI rows; the other processes
return [].

Each job records its spans and counters (``utils/spans.py``): ``job``;
``index_build`` a shard (counters ``index.bytes``, ``index.peak_bytes``);
``mapper_init`` (``mapper.tables``, ``query_plan``, ``autotune``);
``map_loop`` (a ``batch`` span a batch with ``batch.make``,
``query.load`` whenever a query genome is cut, and the map step's and
CGI's spans, then ``cgi.finalize``, ``map_finish`` with
``map_finish.read`` and a ``redo`` a redone query genome; on the exact
path ``batch.collect``, ``fold`` and ``visual``); ``write``
(``write.results``, ``write.lengths``, ``write.tsv``, ``write.matrix``).
Each process parses a genome file once a job: the job opens the reader's
memo (``io.fasta.memo``), which the index build fills, so the batch plan,
the batches' loads and the write's genome lengths take the contigs from
it.  The ``stats`` phase seconds (``t_index_build``, ``t_mapper_init``,
``t_autotune``, ``t_map_fold``, ``t_map``, ``t_fold``, ``t_visual``,
``t_write``) are their spans' summed durations.  With ``--profile DIR``
(``params.profile_dir``) a single-device job runs under
``torch.profiler`` (``profiled``), which writes one Chrome trace,
``DIR/job.pt.trace.json``, every span in it as a range beside the device's
kernels; a sharded job logs that it writes none.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from fastani_tpu_torch.config import Parameters, scale_caps
from fastani_tpu_torch.index.sketch import ReferenceIndex
from fastani_tpu_torch.io import fasta
from fastani_tpu_torch.models import ani, device_cgi, glue, jitmap, output
from fastani_tpu_torch.ops import cuda
from fastani_tpu_torch.ops.stats import identities_for
from fastani_tpu_torch.parallel import distributed, mesh as pmesh
from fastani_tpu_torch.utils import spans


@dataclasses.dataclass
class QueryFragments:
    frags: np.ndarray           # (F, frag_len) uint8, uppercased
    frag_ids: np.ndarray        # (F,) querySeqId of each fragment
    total_fragments: int
    # .visual metadata: one entry per fragment plus one per skipped short
    # contig (computeMap.hpp:140-167); each entry's global offset
    vis_offsets: np.ndarray     # (n_meta,) int64


def fragment_plan(lengths: np.ndarray, params: Parameters):
    """One query genome's batch plan from its contig lengths alone: its
    fragment count and its .visual offsets (``load_query_fragments``'
    ``total_fragments`` and ``vis_offsets``).  A contig shorter than the
    fragment length (or w, k) gives one metadata entry of its length; each
    other contig gives len // frag_len entries of frag_len, the last one
    holding the remainder too (computeMap.hpp:140-167)."""
    l = params.frag_len
    L = np.asarray(lengths, np.int64)
    cut = (L >= params.window_size) & (L >= params.kmer_size) & (L >= l)
    entries = np.where(cut, L // l, 1)
    meta = np.repeat(np.where(cut, l, L), entries)
    meta[(np.cumsum(entries) - 1)[cut]] = l + L[cut] % l
    return int(entries[cut].sum()), np.cumsum(meta) - meta


def load_query_fragments(path: str, params: Parameters) -> QueryFragments:
    """Cut one query genome into (F, frag_len) uppercased rows, each
    contig that ``fragment_plan`` cuts into len // frag_len rows (a view
    of the reader's bytes where the genome has one such contig)."""
    l = params.frag_len
    recs = fasta.contigs(path)
    n, vis = fragment_plan(recs.lengths, params)
    blocks = [s[: len(s) // l * l].reshape(-1, l) for s in recs.seqs
              if len(s) >= max(l, params.window_size, params.kmer_size)]
    if len(blocks) == 1:
        frags = blocks[0]
    else:
        frags = (np.concatenate(blocks) if blocks
                 else np.zeros((0, l), np.uint8))
    return QueryFragments(frags, np.arange(n, dtype=np.int32), n, vis)


class FragmentStream:
    """Global-row view over the query genomes: the batch plan (fragment
    counts and .visual metadata) from their contig lengths, each genome
    cut into fragments on demand while batches consume it (only the
    genomes under the current batch stay cut).  In a job the reader's
    memo (``io.fasta.memo``) gives the lengths and the bytes, so the plan
    and the loads parse nothing the index build parsed; a genome the
    stream has passed gives its bytes back (``evict_up_to``)."""

    def __init__(self, paths, params: Parameters):
        self.paths = list(paths)
        self.params = params
        self._cache: Dict[int, QueryFragments] = {}
        # each path's last place: a path listed twice keeps its bytes
        self._last = {p: q for q, p in enumerate(self.paths)}
        self._passed = 0
        self.counts, self._vis = [], []
        with spans.span("query_plan"):
            for p in self.paths:
                n, vis = fragment_plan(fasta.contig_lengths(p), params)
                self.counts.append(n)
                self._vis.append(vis)
        self.offsets = np.concatenate([[0], np.cumsum(self.counts)]
                                      ).astype(np.int64)
        self.F = int(self.offsets[-1])

    def qno_of_row(self, row: int) -> int:
        return int(np.searchsorted(self.offsets, row, side="right")) - 1

    def total_fragments(self, qno: int) -> int:
        return self.counts[qno]

    def vis_offsets(self, qno: int) -> np.ndarray:
        return self._vis[qno]

    def get_query(self, qno: int) -> QueryFragments:
        if qno not in self._cache:
            with spans.span("query.load", q=qno):
                self._cache[qno] = load_query_fragments(self.paths[qno],
                                                        self.params)
        return self._cache[qno]

    def evict_up_to(self, qno: int) -> None:
        """Drop the fragments of the genomes before ``qno``, and the
        memo's bytes of those listed no later."""
        for q in [q for q in self._cache if q < qno]:
            del self._cache[q]
        for q in range(self._passed, qno):
            if self._last[self.paths[q]] == q:
                fasta.release(self.paths[q])
        self._passed = max(self._passed, qno)

    def make_batch(self, b0: int, B: int):
        """Rows [b0, b0 + B), zero-padded past F (the JAX package's
        ``make_batch``: every batch of a run has one shape).  Returns
        (frags (B, L) u8, qno_row (B,) i32, gid_row (B,) i32
        querySeqIds, n_used, the rows that are real)."""
        frags = np.zeros((B, self.params.frag_len), np.uint8)
        qno_row = np.zeros(B, np.int32)
        gid_row = np.zeros(B, np.int32)
        n = min(B, self.F - b0)
        r = 0
        qno = self.qno_of_row(b0)
        while r < n:
            qf = self.get_query(qno)
            lo = b0 + r - int(self.offsets[qno])
            take = min(n - r, len(qf.frags) - lo)
            frags[r:r + take] = qf.frags[lo:lo + take]
            qno_row[r:r + take] = qno
            gid_row[r:r + take] = qf.frag_ids[lo:lo + take]
            r += take
            qno += 1
        return frags, qno_row, gid_row, n


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


@dataclasses.dataclass
class Grid:
    """This process's part of a job over an (r, q) grid of cells: the plan
    (``distributed.plan``), the indexes of its shard rows, every shard's
    genome count, the mappers of the shard rows that map (one of height
    ``height`` a shard, shared by its cells) and its device.  Cell (r, q)
    maps rows [q x height, (q + 1) x height) of each batch of
    n_q x ``height`` rows against shard r."""
    plan: distributed.Plan
    shards: Dict[int, ReferenceIndex]
    n_local: Dict[int, int]             # every shard row -> its genomes
    mappers: Dict[int, "jitmap.Mapper"]
    height: int
    device: torch.device

    @classmethod
    def single(cls, index: ReferenceIndex, mapper: "jitmap.Mapper"
               ) -> "Grid":
        """The 1x1 grid of one index and its mapper."""
        return cls(distributed.plan(1, 1), {0: index},
                   {0: len(index.sequences_by_file)}, {0: mapper},
                   mapper.height, index.device)

    @property
    def batch(self) -> int:
        """The rows of a batch: a slice for each q cell."""
        return self.height * self.plan.n_q

    def slices(self, n_used: int):
        """(r, q, rows of slice q, its real rows) of this process's mapping
        cells in a padded batch of which the first n_used rows are real;
        a slice with no real row is left out."""
        H = self.height
        for r, q in self.plan.cells:
            if r in self.mappers and q * H < n_used:
                yield r, q, slice(q * H, (q + 1) * H), min(H, n_used - q * H)

    def finalize(self, cells: dict, qnos: List[int]) -> None:
        """Close query genomes on every shard row this process maps: the
        row's first cell folds the q-merge of its cells' bin rows, this
        process's and, through all_reduce, the other processes' of the
        row (``StreamingCGI.finalize_list``)."""
        for r in self.plan.rows:
            cs = [cells[(r, q)] for q in self.plan.cells_of(r)
                  if (r, q) in cells]
            if cs:
                cs[0].finalize_list(
                    qnos, peers=cs[1:],
                    reduce_max=distributed.q_max(self.plan, r))

    @functools.cached_property
    def layout(self) -> pmesh.GlobalLayout:
        """The unsharded index's contig numbering, from every shard's
        contigs (``all_gather``: every process asks for it)."""
        contigs = {}
        for part in distributed.all_gather(
                {r: pmesh.shard_contigs(self.shards[r])
                 for r in self.plan.rows if self.plan.reports(r)}):
            contigs.update(part)
        return pmesh.global_layout(contigs, sum(self.n_local.values()),
                                   self.plan.n_r)

    def graph_stats(self) -> dict:
        """This process's map step graphs, summed over its shards' mappers
        (``Mapper.graph_stats``: count, capture seconds, pool bytes)."""
        total = {}
        for mapper in self.mappers.values():
            for key, v in mapper.graph_stats().items():
                if isinstance(v, dict):
                    sub = total.setdefault(key, {})
                    for name, n in v.items():
                        sub[name] = sub.get(name, 0) + n
                else:
                    total[key] = total.get(key, 0) + v
        return total


def _merge_stats(stats: dict, part: dict) -> None:
    """Fold a slice's or a process's counters into the job's: maxima of
    the map step's counters, sums of the fallback and oracle fragments."""
    for key, v in part.items():
        if key in jitmap.COUNT_NAMES:
            stats[key] = max(v, stats.get(key, 0))
        elif key in ("fallback_frags", "oracle_frags"):
            stats[key] = stats.get(key, 0) + v


def _redo_query_exact(qno: int, stream: FragmentStream,
                      params: Parameters, mapper: "jitmap.Mapper",
                      genome_of_seq: np.ndarray, stats: dict,
                      batch: Optional[int] = None):
    """Exact (counts, sums) of one query genome a fragment of which
    overflowed a cap (the JAX package's ``_redo_query_exact``).  The 2-way
    dedupe couples a genome's fragments, so all of them are mapped again,
    in batches of ``batch`` rows (default ``params.frag_batch``: the rows
    the mapper's caps were sized for), by ``glue.map_fallback_batch``, and
    folded on the host (``ani.compute_cgi_arrays``).  Returns ({ref genome:
    (count, sum)}, the mapper whose caps held the last batch)."""
    frags = stream.get_query(qno).frags
    dev = mapper.index.device
    B = batch or params.frag_batch
    parts = []
    for b0 in range(0, len(frags), B):
        rows, mapper = glue.map_fallback_batch(
            torch.as_tensor(frags[b0:b0 + B], device=dev), mapper, params,
            stats)
        rows["frag"] = rows["frag"] + b0
        parts.append(rows)
    cat = lambda key: np.concatenate([r[key] for r in parts])
    res, _ = ani.compute_cgi_arrays(
        cat("sid"), cat("frag"), cat("mean_pos"), cat("ident"), genome_of_seq,
        params.frag_len, qno, stream.total_fragments(qno), want_visual=False)
    return {r.ref_genome: (r.count_seq,
                           np.float32(r.identity) * np.float32(r.count_seq))
            for r in res}, mapper


@dataclasses.dataclass
class CGIRunHandle:
    """A device CGI run whose stream phase is done and nothing read (the
    JAX package's ``CGIRunHandle``): each mapping cell's CGI table and
    accumulators, and each slice's counts and fallback mask stacked on the
    device, row i x n_cells + c for batch i in cell c."""
    cells: Dict[Tuple[int, int], device_cgi.StreamingCGI]
    counts: torch.Tensor        # (n_batches x n_cells, 11) int64
    fb_masks: torch.Tensor      # (n_batches x n_cells, height) bool
    first_rows: list            # each stack row's first global row
    stream: FragmentStream
    starts: list                # each batch's first row
    n_query_genomes: int


def map_batch_cgi(frags: np.ndarray, qno_row: np.ndarray,
                  gid_row: np.ndarray, n_used: int, mapper: "jitmap.Mapper",
                  cgi: device_cgi.StreamingCGI, counts_row: torch.Tensor,
                  mask_row: torch.Tensor) -> None:
    """Map one slice (``Mapper.dispatch``, ``collect_device``) and fold its
    rows into ``cgi``, all on the device; its counts and fallback mask go
    into ``counts_row`` and ``mask_row``, rows of the run's device stacks
    (``read_stacks``).  Nothing is read here but the map step's
    ``n_live``."""
    out = mapper.collect_device(mapper.dispatch(frags, qno_row, gid_row,
                                                n_used))
    cgi.update(out["packed"], out["counts"][0])
    counts_row.copy_(out["counts"])
    mask_row.copy_(out["fallback_mask"])


def read_stacks(counts: torch.Tensor, masks: torch.Tensor, first_rows,
                stream: FragmentStream, stats: dict) -> set:
    """The one read of a run's per-slice stacks (``map_batch_cgi``'s rows;
    row i is the slice whose first row is global row ``first_rows[i]``):
    each counter's maximum into ``stats`` under COUNT_NAMES; then, only if
    a row's overflow flags are set, the fallback masks, whose rows are
    counted in ``stats["fallback_frags"]``.  Returns the query genomes
    that own a fallback row."""
    c = counts.cpu().numpy()
    for i, key in enumerate(jitmap.COUNT_NAMES):
        stats[key] = max(stats.get(key, 0), int(c[:, i].max()) if len(c)
                         else 0)
    redo = set()
    flagged = np.nonzero(c[:, 1:5].any(axis=1))[0]
    if len(flagged):
        m = masks.cpu().numpy()
        for i in flagged:
            rows = np.nonzero(m[i])[0]
            stats["fallback_frags"] += len(rows)
            redo.update(stream.qno_of_row(first_rows[i] + int(r))
                        for r in rows)
    return redo


def map_queries_cgi_stream(stream: FragmentStream, grid: Grid,
                           params: Parameters,
                           n_query_genomes: int) -> CGIRunHandle:
    """The stream phase of the device CGI path (the JAX package's
    ``map_queries_cgi_stream``): every batch, n_q slices of the grid's
    height, is dispatched slice by slice and folded into the device CGI
    table of each cell, finished query genomes are closed as the loop
    passes them (``Grid.finalize``), and each slice's counts and fallback
    mask are stacked on the device.  A slice's inputs reach the device
    through pinned buffers without a wait (``jitmap.HostInputs``), and the
    only read of the device a slice is the map step's ``n_live``: torch's
    ``CUDAGraph`` has no conditional node, so the host sets the chunk
    replays (the JAX stream reads nothing).  Everything else is read once
    by ``map_queries_cgi_finish``."""
    B, H = grid.batch, grid.height
    starts, fins, tail, n_slots = cgi_stream_schedule(stream, B,
                                                      n_query_genomes)
    cells = {(r, q): device_cgi.StreamingCGI(
        grid.shards[r], params, n_query_genomes, grid.n_local[r],
        n_slots=n_slots, frag_cap=H)
        for r, q in grid.plan.cells if r in grid.mappers}
    col = {cell: c for c, cell in enumerate(cells)}
    rows = len(starts) * len(cells)
    counts = torch.zeros((rows, len(jitmap.COUNT_NAMES)), dtype=torch.int64,
                         device=grid.device)
    masks = torch.zeros((rows, H), dtype=torch.bool, device=grid.device)
    first_rows = [b0 + q * H for b0 in starts for _, q in cells]
    for i, b0 in enumerate(starts):
        if fins[i]:
            grid.finalize(cells, fins[i])
        with spans.span("batch", i=i):
            with spans.span("batch.make"):
                frags, qno_row, gid_row, n_used = stream.make_batch(b0, B)
            for r, q, sl, n in grid.slices(n_used):
                j = i * len(cells) + col[(r, q)]
                map_batch_cgi(frags[sl], qno_row[sl], gid_row[sl], n,
                              grid.mappers[r], cells[(r, q)], counts[j],
                              masks[j])
            stream.evict_up_to(stream.qno_of_row(b0))
    if tail:
        grid.finalize(cells, tail)
    return CGIRunHandle(cells, counts, masks, first_rows, stream, starts,
                        n_query_genomes)


def map_queries_cgi_finish(handle: CGIRunHandle, grid: Grid,
                           params: Parameters, stats: Optional[dict] = None):
    """The readout of a streamed run (the JAX package's
    ``map_queries_cgi_finish``): the counters' maxima and ``batches`` into
    ``stats``, the fallback masks only if a slice overflowed
    (``read_stacks``), each reported shard's (counts, sums) matrices, then
    the exact redo, on every shard, of each query genome that owns an
    overflowed fragment on any shard (which the device CGI left out); the
    shards' matrices and counters are gathered to process 0.  Returns, on
    process 0, host (counts (Gq, Gr), sums (Gq, Gr) float32): with one
    shard, its int32 counts and sums as they are, else the shards' columns
    placed at their global genome ids (``mesh.global_genomes``); None on
    the other processes."""
    stats = {} if stats is None else stats
    local = {"fallback_frags": 0, "oracle_frags": 0}
    plan = grid.plan
    with spans.span("map_finish"):
        with spans.span("map_finish.read"):
            redo = read_stacks(handle.counts, handle.fb_masks,
                               handle.first_rows, handle.stream, local)
            results = {r: handle.cells[(r, 0)].result() for r in plan.rows
                       if r in grid.mappers and plan.reports(r)}
        redo = sorted(set().union(*distributed.all_gather(redo)))
        for r, (c, s) in results.items():
            redo_queries(c, s, redo, handle.stream, params, grid.mappers[r],
                         grid.shards[r].genome_of_seq(), local,
                         batch=grid.height)
        gathered = distributed.gather((results, local))
    for _, st in gathered or [(None, local)]:
        _merge_stats(stats, st)
    stats["batches"] = len(handle.starts)
    stats["redone_queries"] = len(redo)
    if gathered is None:
        return None
    parts = {r: cs for part, _ in gathered for r, cs in part.items()}
    if plan.n_r == 1:
        return parts[0]
    counts = np.zeros((handle.n_query_genomes, sum(grid.n_local.values())),
                      np.int64)
    sums = np.zeros(counts.shape, np.float32)
    for r, (c, s) in parts.items():
        cols = pmesh.global_genomes(c.shape[1], plan.n_r, r)
        counts[:, cols] = c
        sums[:, cols] = s
    return counts, sums


def map_queries_cgi_device(stream: FragmentStream, grid: Grid,
                           params: Parameters, n_query_genomes: int,
                           stats: Optional[dict] = None):
    """Map every query fragment and fold the rows into per-genome-pair
    (counts, sums) on the device: ``map_queries_cgi_stream``, then
    ``map_queries_cgi_finish``, whose result it returns."""
    handle = map_queries_cgi_stream(stream, grid, params, n_query_genomes)
    return map_queries_cgi_finish(handle, grid, params, stats)


def redo_queries(counts: np.ndarray, sums: np.ndarray, qnos, stream,
                 params: Parameters, mapper: "jitmap.Mapper",
                 genome_of_seq: np.ndarray, stats: dict,
                 batch: Optional[int] = None) -> None:
    """Replace the (counts, sums) rows of query genomes ``qnos`` by the
    exact redo's (``_redo_query_exact``), in place; the caps one genome
    grew to carry over to the next.  Span ``redo`` a query genome."""
    for qno in qnos:
        with spans.span("redo", q=qno):
            row, mapper = _redo_query_exact(qno, stream, params, mapper,
                                            genome_of_seq, stats, batch)
        counts[qno, :] = 0
        sums[qno, :] = 0.0
        for g, (c, sm) in row.items():
            counts[qno, g] = c
            sums[qno, g] = sm


def two_deep(jobs):
    """``Mapper.dispatch`` (``to_host``) over ``jobs`` (tuples (mapper,
    frags, qno_row, gid_row, n_used, ...)) two deep, as the JAX package's
    ``results_iter``: job i+1 is dispatched before job i is handed back,
    so the host's work on job i (``Mapper.collect``, whose copies were
    enqueued right behind job i) overlaps the device's on job i+1.
    Yields (job, its ``BatchHandle``) in order; a handle is consumed
    before the next is asked for (a mapper keeps two batches' outputs).
    Span ``batch`` a dispatch."""
    inflight = collections.deque()
    for i, job in enumerate(jobs):
        with spans.span("batch", i=i):
            h = job[0].dispatch(*job[1:5], to_host=True)
        inflight.append((job, h))
        if len(inflight) == 2:
            yield inflight.popleft()
    while inflight:
        yield inflight.popleft()


def batch_rows(mapper: "jitmap.Mapper", handle, frags: np.ndarray,
               qno_row: np.ndarray, gid_row: np.ndarray,
               fb_mapper: "jitmap.Mapper", params: Parameters, stats: dict):
    """One dispatched slice's valid rows, read back for the host fold
    (``Mapper.collect``).  Its overflowed fragments, real rows only, are
    mapped again by ``glue.map_fallback_batch`` with ``fb_mapper``.
    Returns (row columns (qno, qsid, sid, start, ident) per part, the
    mapper whose caps held the fallback).  Span ``batch.collect``: the
    host's read of the rows and their identities."""
    with spans.span("batch.collect"):
        got = mapper.collect(handle)
        _, qno, qsid, sid, shared, sketch, pos = got["rows"]
        ident, _ = identities_for(shared, sketch, params.kmer_size)
    parts = [(qno, qsid, sid, pos, ident)]
    _merge_stats(stats, got["counts"])
    fb = got["fallback"]
    if len(fb):
        stats["fallback_frags"] = stats.get("fallback_frags", 0) + len(fb)
        rows, fb_mapper = glue.map_fallback_batch(
            torch.as_tensor(frags[fb], device=fb_mapper.index.device),
            fb_mapper, params, stats)
        r = fb[rows["frag"]]
        parts.append((qno_row[r], gid_row[r], rows["sid"],
                      rows["mean_pos"], rows["ident"]))
    return parts, fb_mapper


def rows_by_query(parts, n_queries: int) -> List[dict]:
    """Row columns (qno, qsid, sid, start, ident), in parts of any order,
    as one column dict per query genome: ``query_seq_id``,
    ``ref_seq_id``, ``ref_start_pos`` (int64) and ``ident`` (float32)."""
    qno, qsid, sid, start, ident = (
        np.concatenate([p[i] for p in parts]).astype(dt) if parts
        else np.zeros(0, dt)
        for i, dt in enumerate((np.int64, np.int64, np.int64, np.int64,
                                np.float32)))
    order = np.argsort(qno, kind="stable")
    bounds = np.searchsorted(qno[order], np.arange(n_queries + 1))
    return [dict(query_seq_id=qsid[sel], ref_seq_id=sid[sel],
                 ref_start_pos=start[sel], ident=ident[sel])
            for sel in (order[lo:hi] for lo, hi in zip(bounds[:-1],
                                                        bounds[1:]))]


def map_queries_batched(stream: FragmentStream, grid: Grid,
                        params: Parameters,
                        stats: Optional[dict] = None) -> Optional[List[dict]]:
    """Map every query fragment in shared batches and read each slice's
    valid rows back for the host fold (the JAX package's
    ``map_queries_batched``): slices dispatched two deep (``two_deep``),
    each read by ``batch_rows``, their reference seqIds renumbered to the
    unsharded index's (``Grid.layout``) and gathered to process 0.
    Returns on process 0 ``rows_by_query``'s column dict per query
    genome, None on the other processes."""
    stats = {} if stats is None else stats
    local = {"fallback_frags": 0, "oracle_frags": 0}
    B = grid.batch

    def jobs():
        for b0 in range(0, stream.F, B):
            with spans.span("batch.make"):
                frags, qno_row, gid_row, n_used = stream.make_batch(b0, B)
            for r, q, sl, n in grid.slices(n_used):
                yield (grid.mappers[r], frags[sl], qno_row[sl], gid_row[sl],
                       n, r)
            stream.evict_up_to(stream.qno_of_row(b0))

    parts = []
    fb_mappers = dict(grid.mappers)
    gsid = grid.layout.global_sid
    for (mapper, frags, qno_row, gid_row, _, r), h in two_deep(jobs()):
        cell_parts, fb_mappers[r] = batch_rows(
            mapper, h, frags, qno_row, gid_row, fb_mappers[r], params, local)
        parts.extend((qn, qs, gsid[r][sid], st, idt)
                     for qn, qs, sid, st, idt in cell_parts)
    gathered = distributed.gather((parts, local))
    for _, st in gathered or [(None, local)]:
        _merge_stats(stats, st)
    stats["batches"] = -(-stream.F // B)
    if gathered is None:
        return None
    return rows_by_query([p for ps, _ in gathered for p in ps],
                         len(stream.paths))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def profiled(trace_dir: str, dev: torch.device, stats: dict, log):
    """With ``trace_dir``, the body (a whole job) runs under
    ``torch.profiler`` (CPU activity, and CUDA on a card) and its Chrome
    trace is written to ``{trace_dir}/job.pt.trace.json`` (path logged
    and kept in ``stats["profile_trace"]``, the write's seconds in
    ``stats["t_trace_export"]``, each kernel's launches inside the traced
    body in ``stats["profile_launches"]``); without it, the body just
    runs."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    before = dict(cuda.LAUNCHES)
    with profile(activities=acts) as prof:
        yield
        _sync(dev)
    stats["profile_launches"] = {name: cuda.LAUNCHES[name] - n
                                 for name, n in before.items()}
    t0 = time.time()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "job.pt.trace.json")
    prof.export_chrome_trace(path)
    stats["profile_trace"] = path
    stats["t_trace_export"] = time.time() - t0
    log(f"INFO, fastani_tpu_torch, profiler trace written to {path}")


def _sharded(plan: distributed.Plan) -> bool:
    """Whether a job is sharded: more than one cell, or a process group."""
    return plan.n_r * plan.n_q > 1 or distributed.backend() != "none"


@contextlib.contextmanager
def _job(params: Parameters, device, stats: dict, log, n_r, n_q,
         coordinator, num_processes, process_id):
    """What both jobs run in: the process group (``distributed.session``),
    the profiler on a single-device job, the job's spans and the reader's
    memo; ``params`` finalized.  Yields (the plan, the device)."""
    with distributed.session(coordinator, num_processes, process_id,
                             device) as dev:
        plan = distributed.plan(*distributed.mesh_shape(n_r, n_q, dev))
        sharded = _sharded(plan)
        if sharded:
            rank, size = distributed.world()
            log(f"INFO, fastani_tpu_torch, sharded run on a {plan.n_r}x"
                f"{plan.n_q} (r, q) mesh, process {rank} of {size}, backend "
                f"{distributed.backend()}, on {dev}")
            if params.profile_dir:
                log("INFO, fastani_tpu_torch, --profile traces single-device "
                    "runs; this sharded run writes no trace")
        with profiled("" if sharded else params.profile_dir, dev, stats,
                      log), spans.job(stats), \
                fasta.memo(params.query_sequences):
            params.finalize()
            yield plan, dev


def reference_index(params: Parameters, dev: torch.device, stats: dict,
                    log, ref_files=None, load_path: str = "",
                    save_path: str = "") -> ReferenceIndex:
    """The run's reference index on ``dev``: loaded from ``load_path``
    (which sets ``params.ref_sequences`` from the file), or built from
    ``ref_files`` (default ``params.ref_sequences``; the build checks its
    overflow and rebuilds); then saved to ``save_path``.  Callers read the
    reference count only after this.  Span ``index_build``; its seconds,
    summed over the job's builds, in ``stats["t_index_build"]``; counter
    ``index.peak_bytes``, the device allocator's peak at its end."""
    t0 = time.time()
    with spans.span("index_build"):
        if load_path:
            index = ReferenceIndex.load(load_path, params, dev)
            how = f"restored from {load_path}"
        else:
            index = ReferenceIndex.build_device(params, ref_files, device=dev)
            how = "sketched"
        _sync(dev)
        # the allocator's peak so far, which the build's transients set
        # (read, never reset: the caller owns the peak); 0 off a card
        spans.gauge("index.peak_bytes", torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else 0)
    stats["t_index_build"] = spans.seconds("index_build")
    log(f"INFO, fastani_tpu_torch, reference {how} on {dev} in "
        f"{time.time() - t0:.2f}s: {index.n_entries} minimizers "
        f"(window size {params.window_size})")
    if save_path:
        index.save(save_path, params)
        log(f"INFO, fastani_tpu_torch, reference index saved to {save_path}")
    return index


def build_shards(params: Parameters, plan: distributed.Plan, dev, stats: dict,
                 log) -> Dict[int, ReferenceIndex]:
    """The indexes of the shards whose cells this process runs
    (``plan.rows``) on ``dev`` (``reference_index``): built from each
    shard's files (``mesh.shard_files``), or loaded with ``--loadIndex``
    (which sets ``params.ref_sequences``: a sharded job's every shard file
    holds the whole list, as the JAX package writes it).  A single-device
    job's index file is the ``--saveIndex``/``--loadIndex`` path itself, a
    sharded job's shard r is ``{prefix}.r{r}of{n_r}.npz``, saved by the one
    process that reports it (``plan.reports``), so no two processes write
    one file."""
    single = not _sharded(plan)
    path = lambda prefix, r: (prefix if single or not prefix
                              else pmesh.shard_path(prefix, r, plan.n_r))
    return {r: reference_index(
        params, dev, stats, log,
        ref_files=pmesh.shard_files(params.ref_sequences, plan.n_r, r),
        load_path=path(params.load_index, r),
        save_path=path(params.save_index, r) if plan.reports(r) else "")
        for r in plan.rows}


# the JAX package's autotune_hits_cap: batches probed, headroom over the
# largest hit total seen
_TUNE_SAMPLES = 12
_TUNE_MARGIN = 1.25


def autotune_hits_cap(mapper: "jitmap.Mapper", stream: FragmentStream,
                      params: Parameters) -> "jitmap.Mapper":
    """The hits_cap auto-tune (the JAX package's ``autotune_hits_cap``):
    the largest per-fragment L1 hit total on ``_TUNE_SAMPLES`` evenly
    spaced batches (``Mapper.probe_hits``, one read for all of them) sets
    hits_cap to round1024(max x ``_TUNE_MARGIN``), at least 4096 and never
    above the static cap.  Every L1 stage, K3's hit rows included, runs at
    that width.  A no-op while hits_cap <= 8192 (up to 34 reference genomes),
    where there is little width to win.  A fragment of a batch that was
    not sampled and needs more goes through the exact redo, so the answer
    does not depend on the sample.  Sets ``params.hits_cap``; returns the
    mapper at the tuned cap (``Mapper.with_caps``)."""
    B = params.frag_batch
    starts = list(range(0, stream.F, B))
    if not starts or params.hits_cap <= 8192:
        return mapper
    step = max(1, len(starts) // _TUNE_SAMPLES)
    dev = mapper.index.device
    probes = [mapper.probe_hits(torch.as_tensor(stream.make_batch(b0, B)[0],
                                                device=dev))
              for b0 in starts[::step][:_TUNE_SAMPLES]]
    mx = int(torch.stack(probes)[:, 0].max())
    params.hits_cap = min(params.hits_cap,
                          max(4096, -(-int(mx * _TUNE_MARGIN) // 1024) * 1024))
    return mapper.with_caps(hits_cap=params.hits_cap)


def tuned_mapper(mapper: "jitmap.Mapper", stream: FragmentStream,
                 params: Parameters, stats: dict, log) -> "jitmap.Mapper":
    """``autotune_hits_cap``, logged, with the static and the tuned cap in
    ``stats["hits_cap_static"]`` and ``stats["hits_cap"]``, and its
    seconds (span ``autotune``, synchronised) in ``stats["t_autotune"]``."""
    stats["hits_cap_static"] = mapper.cfg.hits_cap
    with spans.span("autotune"):
        mapper = autotune_hits_cap(mapper, stream, params)
        _sync(mapper.index.device)
    stats["t_autotune"] = spans.seconds("autotune")
    stats["hits_cap"] = mapper.cfg.hits_cap
    log(f"INFO, fastani_tpu_torch, hits_cap auto-tuned to "
        f"{stats['hits_cap']} (static {stats['hits_cap_static']})")
    return mapper


def open_grid(params: Parameters, plan: distributed.Plan, dev: torch.device,
              stats: dict, log, exact: bool):
    """A job's set-up on this process: its shards (``build_shards``), the
    caps ``scale_caps`` sets for the most genomes of a shard, on the exact
    path each shard's repeat sanity check (with ``-s``; a failing shard
    maps nothing), then span ``mapper_init``: the shards' mappers
    (``jitmap.job_mapper``, span ``mapper.tables``), the query stream and,
    on the fast path at n_r = 1, the hits_cap auto-tune (``tuned_mapper``).
    Returns (the ``Grid``, the ``FragmentStream``); the stream is None, and
    nothing maps, when no shard does."""
    shards = build_shards(params, plan, dev, stats, log)
    # --loadIndex set the reference list: count the genomes only now
    n_local = {r: len(pmesh.shard_files(params.ref_sequences, plan.n_r, r))
               for r in range(plan.n_r)}
    # the exact path too (the JAX run keeps the defaults, which mid's hits
    # and L2 units overflow on most batches): the answer does not depend
    # on them, and at these no mid fragment falls back
    scale_caps(max(n_local.values()), params)
    live = {r for r, n in n_local.items() if n}
    if exact and params.sanity_check:
        checks = {}
        for part in distributed.all_gather(
                {r: pmesh.shard_sanity(shards[r], params.max_ratio_diff)
                 for r in plan.rows if plan.reports(r)}):
            checks.update(part)
        for r in range(plan.n_r):
            ok, diff = checks[r]
            if not ok:
                # the reference skips the split's whole map loop
                # (core_genome_identity.cpp:79-80)
                log(f"ERROR :: SPLIT {r}'s ratio difference {diff} exceeds "
                    f"maximum thresholds.")
                live.discard(r)
    height = -(-params.frag_batch // plan.n_q)
    grid = Grid(plan, shards, n_local, {}, height, dev)
    if not live:
        return grid, None
    with spans.span("mapper_init"):
        with spans.span("mapper.tables"):
            grid.mappers.update(
                (r, jitmap.job_mapper(params, shards[r], n_local[r], height))
                for r in plan.rows if r in live)
        stream = FragmentStream(params.query_sequences, params)
        if not exact and plan.n_r == 1:
            grid.mappers[0] = tuned_mapper(grid.mappers[0], stream, params,
                                           stats, log)
        _sync(dev)
    stats["t_mapper_init"] = spans.seconds("mapper_init")
    return grid, stream


def fold_queries(maps: List[dict], genome_of_seq: np.ndarray,
                 ref_offsets: np.ndarray, stream: FragmentStream,
                 params: Parameters, stats: dict) -> List[ani.CGIResult]:
    """The host fold of each query genome's rows (``rows_by_query``'s
    dicts) by ``ani.compute_cgi_arrays``, whose reference seqIds index
    ``genome_of_seq`` and ``ref_offsets`` (each contig's global offset);
    with ``params.visualize`` each genome's 2-way rows are appended to the
    ``.visual`` file.  Returns the CGI rows; ``stats`` takes the fold's and
    the ``.visual`` write's times (spans ``fold`` and ``visual`` a query
    genome; ``t_fold``, ``t_visual``)."""
    final: List[ani.CGIResult] = []
    for qno, m in enumerate(maps):
        with spans.span("fold", q=qno):
            rows, visual = ani.compute_cgi_arrays(
                m["ref_seq_id"], m["query_seq_id"], m["ref_start_pos"],
                m["ident"], genome_of_seq, params.frag_len, qno,
                stream.total_fragments(qno), want_visual=params.visualize)
        final.extend(rows)
        if params.visualize and params.out_file_name:
            with spans.span("visual", q=qno):
                output.write_visual(visual, params, qno,
                                    stream.vis_offsets(qno), ref_offsets,
                                    params.out_file_name, append=True)
    stats["t_fold"] = spans.seconds("fold")
    stats["t_visual"] = spans.seconds("visual")
    return final


def write_results(final: List[ani.CGIResult], params: Parameters) -> None:
    """The TSV, and the ``.matrix`` with params.matrix_output (spans
    ``write.lengths``, ``write.tsv``, ``write.matrix``)."""
    if not params.out_file_name:
        return
    with spans.span("write.lengths"):
        genome_lengths: Dict[str, int] = {}
        for e in list(params.query_sequences) + list(params.ref_sequences):
            if e not in genome_lengths:
                genome_lengths[e] = fasta.genome_length_for_ani(
                    e, params.frag_len)
    with spans.span("write.tsv"):
        output.write_cgi(final, genome_lengths, params, params.out_file_name)
    if params.matrix_output:
        with spans.span("write.matrix"):
            output.write_phylip(final, genome_lengths, params,
                                params.out_file_name)


def run_fast(params: Parameters, device="cuda",
             log=lambda msg: print(msg, file=sys.stderr),
             stats: Optional[dict] = None, n_r: Optional[int] = 1,
             n_q: Optional[int] = 1, coordinator: Optional[str] = None,
             num_processes: Optional[int] = None,
             process_id: Optional[int] = None) -> List[ani.CGIResult]:
    """Device index build + map/fold stream + one readout on an n_r x n_q
    grid (``None`` for both: ``--mesh auto``; a process group with
    ``coordinator``, ``num_processes`` and ``process_id``); process 0
    writes the TSV (and ``.matrix`` with params.matrix_output).  Counts on
    every grid equal the 1x1 job's, the sums too (a fixed-order fold).
    Runs on ``cuda`` unless the caller asks for ``cpu``; raises if no card
    is present.  ``stats``, when given, receives phase wall times, the
    counters' maxima and the job's spans and counters."""
    stats = {} if stats is None else stats
    with _job(params, device, stats, log, n_r, n_q, coordinator,
              num_processes, process_id) as (plan, dev):
        grid, stream = open_grid(params, plan, dev, stats, log, exact=False)
        n_qg = len(stream.paths)
        with spans.span("map_loop"):
            out = map_queries_cgi_device(stream, grid, params, n_qg,
                                         stats=stats)
        stats["t_map_fold"] = spans.seconds("map_loop")
        stats.update(grid.graph_stats())
        log(f"INFO, fastani_tpu_torch, mapped {n_qg} queries ({stream.F} "
            f"fragments) + device CGI in {stats['t_map_fold']:.2f}s")
        if out is None:
            return []
        with spans.span("write"):
            with spans.span("write.results"):
                final = ani.results_from_matrices(*out,
                                                  stream.total_fragments)
            write_results(final, params)
        stats["t_write"] = spans.seconds("write")
    return final


def run(params: Parameters, device="cuda",
        log=lambda msg: print(msg, file=sys.stderr),
        stats: Optional[dict] = None, n_r: Optional[int] = 1,
        n_q: Optional[int] = 1, coordinator: Optional[str] = None,
        num_processes: Optional[int] = None,
        process_id: Optional[int] = None) -> List[ani.CGIResult]:
    """The exact path (the JAX package's ``run`` on its device backend) on
    an n_r x n_q grid, as ``run_fast`` takes it: device index build, ``-s``
    sanity check, every slice mapped on the device and its rows read back,
    the host fold per query genome on process 0, then the TSV, ``.matrix``
    and ``.visual`` (params.visualize) files, byte-equal on every grid.
    Runs on ``cuda`` unless the caller asks for ``cpu``; raises if no card
    is present.  Returns the CGI rows (before the minFraction gate)."""
    stats = {} if stats is None else stats
    with _job(params, device, stats, log, n_r, n_q, coordinator,
              num_processes, process_id) as (plan, dev):
        grid, stream = open_grid(params, plan, dev, stats, log, exact=True)
        maps = None
        if stream is not None:
            with spans.span("map_loop"):
                maps = map_queries_batched(stream, grid, params, stats)
            stats["t_map"] = spans.seconds("map_loop")
            stats.update(grid.graph_stats())
            log(f"INFO, fastani_tpu_torch, mapped {len(stream.paths)} "
                f"queries ({stream.F} fragments) in {stats['t_map']:.2f}s")
            if maps is None:
                return []
        elif distributed.world()[0]:
            return []

        out_path = params.out_file_name
        if params.visualize and out_path:
            open(out_path + ".visual", "w").close()  # fresh run, then appends
        final: List[ani.CGIResult] = []
        if maps is not None:
            lens = grid.layout.contig_lengths
            final = fold_queries(maps, grid.layout.genome_of_seq,
                                 np.cumsum(lens) - lens, stream, params,
                                 stats)
        with spans.span("write"):
            write_results(final, params)
        stats["t_write"] = spans.seconds("write")
    return final
