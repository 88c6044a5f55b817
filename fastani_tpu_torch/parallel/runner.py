"""Sharded runs over an (r, q) grid of cells (counterpart of
``fastani_tpu/parallel/runner.py``; the CLI's ``--mesh``/``--coordinator``).

Replaces the reference program's OpenMP shard loop and merge
(src/cgi/core_genome_identity.cpp:46-141) and its shell-level multi-node
split (scripts/splitDatabase.sh:14-39).  Every process of a run calls the
same function with the same arguments; ``distributed.plan`` gives it its
cells.  Cell (r, q) maps slice q of each fragment batch (``B_local`` =
ceil(frag_batch / n_q) rows) against reference shard r with the port's
map step, one ``Mapper`` of height ``B_local`` per shard.  A batch is
padded to n_q x ``B_local`` rows (``FragmentStream.make_batch``), so every
slice has ``B_local`` rows and passes ``row_valid`` (``Mapper.dispatch``):
on a card each shard's mapper captures one set of CUDA graphs, which its
cells share and every slice replays, the tail's included; a slice with no
real row is skipped.  ``stats`` takes this process's graphs
(``Mapper.graph_stats``, summed over its shards).

* ``run_sharded_fused`` (the fast path): one device CGI table per cell;
  each cell's counts and fallback masks are stacked on the device
  (``pipeline.map_batch_cgi``) and read once after the loop
  (``pipeline.read_stacks``); a finished query genome's bin rows are
  merged over the q cells of its shard (``StreamingCGI.finalize_list``,
  the JAX ``lax.pmax``) and folded into the shard's (Gq, G_local)
  matrices; a query genome with a fragment over a cap is redone exactly
  per shard (``pipeline.redo_queries``, on the shard's device); the
  shards' matrices are gathered and placed at their global genome ids
  (``mesh.global_genomes``) on process 0.
* ``run_sharded`` (the exact path): the cells' slices are dispatched two
  deep (``pipeline.two_deep``), each cell's rows read back
  (``pipeline.batch_rows``), renumbered to the unsharded index's
  seqIds (``mesh.global_layout``) and gathered to process 0, which folds
  each query genome's union with ``ani.compute_cgi_arrays``.  Every reference
  genome and contig lives in one shard, the 1-way dedupe is per (genome,
  fragment) and the 2-way per (contig, bin), and the fold's choices do not
  depend on row order, so the union's fold is the single-device fold: the
  TSV, ``.matrix`` and ``.visual`` are byte-equal to ``pipeline.run``'s.

Process 0 writes the files and returns the CGI rows; the other
processes return [].  With ``-s`` each shard is checked on its own
(``ERROR :: SPLIT {r}'s ratio difference ...``), and a failing shard maps
nothing.  With one shard the fast path tunes hits_cap as ``run_fast``
does (``pipeline.autotune_hits_cap``).  Each process records its job's
spans and counters (``utils/spans.py``) as ``pipeline``'s paths do, the
shared helpers' spans included; ``stats`` takes this process's.  Each
process keeps its own memo of parsed files (``io.fasta.memo``), so it
parses once each file it reads.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from fastani_tpu_torch.config import Parameters, scale_caps
from fastani_tpu_torch.index.sketch import ReferenceIndex
from fastani_tpu_torch.io import fasta
from fastani_tpu_torch.models import ani, device_cgi, jitmap, pipeline
from fastani_tpu_torch.parallel import distributed, mesh as pmesh
from fastani_tpu_torch.utils import spans


@dataclasses.dataclass
class _Run:
    """What both paths set up: the plan, this process's shards and their
    mappers (the shards that map), the query stream and the slice size."""
    plan: distributed.Plan
    shards: Dict[int, ReferenceIndex]
    n_local: Dict[int, int]             # every shard row -> its genomes
    mappers: Dict[int, jitmap.Mapper]
    stream: pipeline.FragmentStream
    B_local: int

    def slices(self, n_used: int):
        """(r, q, rows of slice q, its real rows) of this process's mapping
        cells in a padded batch of which the first n_used rows are real;
        a slice with no real row is left out."""
        B = self.B_local
        for r, q in self.plan.cells:
            if r in self.mappers and q * B < n_used:
                yield (r, q, slice(q * B, (q + 1) * B),
                       min(B, n_used - q * B))


def _prepare(params: Parameters, n_r: Optional[int], n_q: Optional[int],
             dev: torch.device, stats: dict, log) -> _Run:
    params.finalize()
    plan = distributed.plan(*distributed.mesh_shape(n_r, n_q, dev))
    rank, size = distributed.world()
    log(f"INFO, fastani_tpu_torch, sharded run on a {plan.n_r}x{plan.n_q} "
        f"(r, q) mesh, process {rank} of {size}, backend "
        f"{distributed.backend()}, on {dev}")
    if params.profile_dir:
        log("INFO, fastani_tpu_torch, --profile traces single-device runs; "
            "this sharded run writes no trace")
    shards = pmesh.build_shards(params, plan, dev, stats, log)
    # --loadIndex set the reference list: count the genomes only now
    n_local = {r: len(pmesh.shard_files(params.ref_sequences, plan.n_r, r))
               for r in range(plan.n_r)}
    scale_caps(max(n_local.values()), params)
    live = {r for r, n in n_local.items() if n}
    if params.sanity_check:
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
    with spans.span("mapper_init"):
        stream = pipeline.FragmentStream(params.query_sequences, params)
        B_local = -(-params.frag_batch // plan.n_q)
        with spans.span("mapper.tables"):
            mappers = {r: pmesh.shard_mapper(params, shards[r], n_local[r],
                                             B_local)
                       for r in plan.rows if r in live}
    stats["t_mapper_init"] = spans.seconds("mapper_init")
    return _Run(plan, shards, n_local, mappers, stream, B_local)


def _merge_stats(stats: dict, part: dict) -> None:
    """Fold one process's counters into the run's: maxima of the map
    step's counters, sums of the fallback and oracle fragments."""
    for key, v in part.items():
        if key in jitmap.COUNT_NAMES:
            stats[key] = max(v, stats.get(key, 0))
        elif key in ("fallback_frags", "oracle_frags"):
            stats[key] = stats.get(key, 0) + v


def _graph_stats(stats: dict, mappers: Dict[int, jitmap.Mapper]) -> None:
    """This process's map step graphs, summed over its shards' mappers
    (``Mapper.graph_stats``: count, capture seconds, pool bytes)."""
    for mapper in mappers.values():
        for key, v in mapper.graph_stats().items():
            if isinstance(v, dict):
                total = stats.setdefault(key, {})
                for name, n in v.items():
                    total[name] = total.get(name, 0) + n
            else:
                stats[key] = stats.get(key, 0) + v


def _finalize(run: _Run, cells: dict, qnos: List[int]) -> None:
    """Close query genomes on every shard row this process maps: the
    row's first cell folds the q-merge of its cells' bin rows, this
    process's and, through all_reduce, the other processes' of the row."""
    for r in run.plan.rows:
        cs = [cells[(r, q)] for q in run.plan.cells_of(r) if (r, q) in cells]
        if cs:
            cs[0].finalize_list(qnos, peers=cs[1:],
                                reduce_max=distributed.q_max(run.plan, r))


def run_sharded_fused(params: Parameters, n_r: Optional[int] = None,
                      n_q: Optional[int] = None,
                      coordinator: Optional[str] = None,
                      num_processes: Optional[int] = None,
                      process_id: Optional[int] = None, device="cuda",
                      stats: Optional[dict] = None,
                      log=lambda msg: print(msg, file=sys.stderr)
                      ) -> List[ani.CGIResult]:
    """The fast path on an n_r x n_q grid (``None`` for both: ``--mesh
    auto``); counts equal ``pipeline.run_fast``'s, ANI up to the float32
    order of the device sums.  Runs on ``cuda`` unless asked for ``cpu``;
    raises without a card.  Process 0 writes the TSV (and ``.matrix``) and
    returns the CGI rows; the other processes return []."""
    stats = {} if stats is None else stats
    with distributed.session(coordinator, num_processes, process_id,
                             device) as dev, spans.job(stats), \
            fasta.memo(params.query_sequences):
        run = _prepare(params, n_r, n_q, dev, stats, log)
        plan, stream = run.plan, run.stream
        n_queries = len(stream.paths)
        if plan.n_r == 1 and run.mappers:
            run.mappers[0] = pipeline.tuned_mapper(run.mappers[0], stream,
                                                   params, stats, log)
        B = run.B_local * plan.n_q
        starts, fins, tail, n_slots = pipeline.cgi_stream_schedule(
            stream, B, n_queries)
        cells = {(r, q): device_cgi.StreamingCGI(
            run.shards[r], params, n_queries, run.n_local[r],
            n_slots=n_slots, frag_cap=run.B_local)
            for r, q in plan.cells if r in run.mappers}
        # each cell's per-batch counts and fallback masks, on its device
        stacks = {cell: (torch.zeros((len(starts), len(jitmap.COUNT_NAMES)),
                                     dtype=torch.int64, device=dev),
                         torch.zeros((len(starts), run.B_local),
                                     dtype=torch.bool, device=dev))
                  for cell in cells}

        local = {"fallback_frags": 0, "oracle_frags": 0}
        with spans.span("map_loop"):
            for i, b0 in enumerate(starts):
                if fins[i]:
                    _finalize(run, cells, fins[i])
                with spans.span("batch", i=i):
                    with spans.span("batch.make"):
                        frags, qno_row, gid_row, n_used = stream.make_batch(
                            b0, B)
                    for r, q, sl, n in run.slices(n_used):
                        counts, masks = stacks[(r, q)]
                        pipeline.map_batch_cgi(
                            frags[sl], qno_row[sl], gid_row[sl], n,
                            run.mappers[r], cells[(r, q)], counts[i],
                            masks[i])
                    stream.evict_up_to(stream.qno_of_row(b0))
            if tail:
                _finalize(run, cells, tail)
            _graph_stats(stats, run.mappers)
            with spans.span("map_finish"):
                # the run's one read of the stacks: the counters, and the
                # query genomes that own an overflowed fragment (only if
                # one did)
                redo = set()
                with spans.span("map_finish.read"):
                    for (r, q), (counts, masks) in stacks.items():
                        redo |= pipeline.read_stacks(
                            counts, masks,
                            [b0 + q * run.B_local for b0 in starts], stream,
                            local)

                # the device CGI left the overflowed fragments out: each
                # shard redoes every query genome that owns one, on any
                # shard
                redo_all = sorted(set().union(*distributed.all_gather(redo)))
                results = {}
                for r in plan.rows:
                    if r not in run.mappers or not plan.reports(r):
                        continue
                    with spans.span("map_finish.read"):
                        c, s = cells[(r, 0)].result()
                    run.mappers[r] = pipeline.redo_queries(
                        c, s, redo_all, stream, params, run.mappers[r],
                        run.shards[r].genome_of_seq(), local,
                        batch=run.B_local)
                    results[r] = (c, s)

                gathered = distributed.gather((results, local))
        for _, st in gathered or [(None, local)]:
            _merge_stats(stats, st)
        stats["batches"] = len(starts)
        stats["redone_queries"] = len(redo_all)
        stats["t_map_fold"] = spans.seconds("map_loop")
        log(f"INFO, fastani_tpu_torch, mapped {n_queries} queries "
            f"({stream.F} fragments) + device CGI on the mesh in "
            f"{stats['t_map_fold']:.2f}s")

        final = []
        with spans.span("write"):
            if gathered is not None:
                n_ref = len(params.ref_sequences)
                counts = np.zeros((n_queries, n_ref), np.int64)
                sums = np.zeros((n_queries, n_ref), np.float32)
                for part, _ in gathered:
                    for r, (c, s) in part.items():
                        cols = pmesh.global_genomes(c.shape[1], plan.n_r, r)
                        counts[:, cols] = c
                        sums[:, cols] = s
                with spans.span("write.results"):
                    final = ani.results_from_matrices(
                        counts, sums, stream.total_fragments)
                pipeline.write_results(final, params)
        stats["t_write"] = spans.seconds("write")
    return final


def run_sharded(params: Parameters, n_r: Optional[int] = None,
                n_q: Optional[int] = None, coordinator: Optional[str] = None,
                num_processes: Optional[int] = None,
                process_id: Optional[int] = None, device="cuda",
                stats: Optional[dict] = None,
                log=lambda msg: print(msg, file=sys.stderr)
                ) -> List[ani.CGIResult]:
    """The exact path on an n_r x n_q grid: TSV, ``.matrix`` and
    ``.visual`` byte-equal to ``pipeline.run``'s.  Runs on ``cuda`` unless
    asked for ``cpu``; raises without a card.  Process 0 folds, writes the
    files and returns the CGI rows; the other processes return []."""
    stats = {} if stats is None else stats
    with distributed.session(coordinator, num_processes, process_id,
                             device) as dev, spans.job(stats), \
            fasta.memo(params.query_sequences):
        run = _prepare(params, n_r, n_q, dev, stats, log)
        plan, stream = run.plan, run.stream
        contigs = {}
        for part in distributed.all_gather(
                {r: pmesh.shard_contigs(run.shards[r])
                 for r in plan.rows if plan.reports(r)}):
            contigs.update(part)
        layout = pmesh.global_layout(contigs, len(params.ref_sequences),
                                     plan.n_r)

        B = run.B_local * plan.n_q
        local = {"fallback_frags": 0, "oracle_frags": 0}

        def jobs():
            for b0 in range(0, stream.F, B):
                with spans.span("batch.make"):
                    frags, qno_row, gid_row, n_used = stream.make_batch(b0, B)
                for r, q, sl, n in run.slices(n_used):
                    yield (run.mappers[r], frags[sl], qno_row[sl],
                           gid_row[sl], n, r)
                stream.evict_up_to(stream.qno_of_row(b0))

        parts = []         # (qno, qsid, global sid, start, ident) columns
        fb_mappers = dict(run.mappers)
        with spans.span("map_loop"):
            for (mapper, frags, qno_row, gid_row, _, r), h in \
                    pipeline.two_deep(jobs()):
                cell_parts, fb_mappers[r] = pipeline.batch_rows(
                    mapper, h, frags, qno_row, gid_row, fb_mappers[r],
                    params, local)
                gsid = layout.global_sid[r]
                parts.extend((qn, qs, gsid[sid], st, idt)
                             for qn, qs, sid, st, idt in cell_parts)
            _graph_stats(stats, run.mappers)
            gathered = distributed.gather((parts, local))
        for _, st in gathered or [(None, local)]:
            _merge_stats(stats, st)
        stats["batches"] = -(-stream.F // B)
        stats["t_map"] = spans.seconds("map_loop")
        log(f"INFO, fastani_tpu_torch, mapped {len(stream.paths)} queries "
            f"({stream.F} fragments) on the mesh in {stats['t_map']:.2f}s")
        if gathered is None:
            return []

        maps = pipeline.rows_by_query([p for ps, _ in gathered for p in ps],
                                      len(stream.paths))
        if params.visualize and params.out_file_name:
            open(params.out_file_name + ".visual", "w").close()
        lens = layout.contig_lengths
        final = pipeline.fold_queries(
            maps, layout.genome_of_seq, np.cumsum(lens) - lens, stream,
            params, stats)
        with spans.span("write"):
            pipeline.write_results(final, params)
        stats["t_write"] = spans.seconds("write")
    return final
