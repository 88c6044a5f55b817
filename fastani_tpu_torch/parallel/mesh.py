"""Reference shards of a sharded run (counterpart of
``fastani_tpu/parallel/mesh.py``).

Round-robin sharding, the reference's splitReferenceGenomes law
(computeCoreIdentity.hpp:457-474): file j goes to shard j % n_r, so local
genome g of shard r is global genome g * n_r + r (correctRefGenomeIds,
:480-487).  Each process builds, or loads, only the shards whose cells it
runs (``build_shards``), each through ``ReferenceIndex.build_device``,
which checks its overflow flag and rebuilds, on every shard; with
``--saveIndex``/``--loadIndex`` each shard is the file
``{prefix}.r{r}of{n_r}.npz``.

``make_sharded_step`` is the per-query sharded tally step of the JAX
package over these shards: each shard maps one query genome's fragments
in n_q slices and folds the rows with ``device_cgi.cgi_matrices``.

Not ported: the JAX package's stacked, padded ``ShardedIndex`` arrays and
``local_shard_dims``/``allgather_shard_dims``.  They exist so that
``shard_map`` sees equal shapes on every device; a torch process holds its
shards at their own sizes, each under its own ``Mapper``.  What the runner
still needs of them is here: the global genome ids and the map from each
shard's seqIds to the seqIds of the unsharded index (``GlobalLayout``),
which puts the ``.visual`` rows in the single-device order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from fastani_tpu_torch.config import Parameters, scale_caps
from fastani_tpu_torch.index.sketch import ReferenceIndex
from fastani_tpu_torch.models import device_cgi, glue, jitmap, pipeline


def shard_files(ref_files: Sequence[str], n_r: int, r: int) -> List[str]:
    """splitReferenceGenomes: file j belongs to shard j % n_r."""
    return [f for j, f in enumerate(ref_files) if j % n_r == r]


def global_genomes(n_local: int, n_r: int, r: int) -> np.ndarray:
    """correctRefGenomeIds: the global ids of shard r's n_local genomes."""
    return np.arange(n_local, dtype=np.int64) * n_r + r


def shard_path(prefix: str, r: int, n_r: int) -> str:
    return f"{prefix}.r{r}of{n_r}.npz"


def build_shards(params: Parameters, plan, dev, stats: dict,
                 log) -> Dict[int, ReferenceIndex]:
    """The indexes of the shards whose cells this process runs
    (``plan.rows``, a ``distributed.Plan``) on ``dev``: built from each
    shard's files, or loaded from ``{params.load_index}.r{r}of{n_r}.npz``
    (which sets ``params.ref_sequences``: every shard file holds the whole
    list, as the JAX package writes it).  With ``params.save_index`` each
    shard is saved to ``{params.save_index}.r{r}of{n_r}.npz`` by the one
    process that reports it (``plan.reports``), so no two processes write
    one file."""
    n_r, shards = plan.n_r, {}
    for r in plan.rows:
        shards[r] = pipeline.reference_index(
            params, dev, stats, log,
            ref_files=shard_files(params.ref_sequences, n_r, r),
            load_path=(shard_path(params.load_index, r, n_r)
                       if params.load_index else ""),
            save_path=(shard_path(params.save_index, r, n_r)
                       if params.save_index and plan.reports(r) else ""))
    return shards


def shard_mapper(params: Parameters, index: ReferenceIndex, n_local: int,
                 B_local: int) -> jitmap.Mapper:
    """One shard's map step for slices of B_local rows (its height), in
    the JAX runner's geometry: L2 units for max(4, int(1.7 G_local) + 8)
    candidate regions a fragment, in chunks of one full wave of K5 blocks
    on a card (``jitmap.chunk_width``), of min(512, max(8, B_local)) units
    on the CPU."""
    uf = max(4, int(1.7 * n_local) + 8)
    unit_cap = min(B_local * uf, B_local * params.cand_cap)
    chunk = jitmap.chunk_width(index.device, unit_cap, params.sketch_cap,
                               min(512, max(8, B_local)))
    mapper = jitmap.Mapper(params, index, unit_factor=uf, unit_chunk=chunk,
                           height=B_local)
    return mapper.with_caps(unit_cap=unit_cap)


def _slice_rows(mapper: jitmap.Mapper, frags: torch.Tensor, first: int,
                params: Parameters) -> torch.Tensor:
    """Mapping rows (7, n) int64 (frag, qno, qsid, sid, shared, sketch,
    pos) of one slice of a query genome's fragments, whose first row is
    fragment ``first``; qsid is the fragment's number in the genome.  A
    fragment over a cap is mapped again by ``glue.map_fallback_batch``.
    The slice is mapped at its own height, eagerly (``Mapper.map_batch``):
    a query genome's slices have heights a run's stream never makes."""
    dev = frags.device
    ids = torch.arange(first, first + frags.shape[0], dtype=torch.int32,
                       device=dev)
    out = mapper.map_batch(frags, torch.zeros_like(ids), ids)
    c = dict(zip(jitmap.COUNT_NAMES, out["counts"].tolist()))
    parts = [out["packed"][:, :c["n_valid"]].long()]
    if jitmap.overflowed(c):
        over = torch.nonzero(out["fallback_mask"]).flatten()
        fb, _ = glue.map_fallback_batch(frags[over], mapper, params)
        f = over.cpu().numpy()[fb["frag"]] + first
        parts.append(torch.as_tensor(np.stack(
            [f, np.zeros_like(f), f, fb["sid"], fb["shared"], fb["sketch"],
             fb["mean_pos"]]).astype(np.int64), device=dev))
    return torch.cat(parts, 1)


def make_sharded_step(params: Parameters, shards: Dict[int, ReferenceIndex],
                      n_r: int, n_q: int, frags_per_slice: int):
    """The per-query sharded tally step (the JAX package's
    ``make_sharded_step``) over ``build_shards``' indexes of an n_r x n_q
    run; ``shards`` holds the shard rows this process runs.  Sets the caps
    as the runner does (``scale_caps`` for the most genomes of a shard).

    Returns ``step(frags)``: for one query genome's (F, frag_len) uint8
    fragments, F <= n_q x ``frags_per_slice``, (sum_ident (n_r, G) float32,
    count (n_r, G) int32) on the shards' device, G the most genomes of a
    shard; column g of row r is shard r's local genome g, and the rows of
    shards not in ``shards`` stay zero.  Each shard maps slice q (rows
    [q x frags_per_slice, ...)) with its mapper (``shard_mapper``), the
    cells in turn, concatenates the slices' rows and folds them with
    ``device_cgi.cgi_matrices`` for one query genome: its 1-way law per
    (genome, fragment) and 2-way law per (contig, bin) are the JAX step's,
    and the rows of every q slice meet in one fold, as the JAX step's
    ``all_gather`` over q makes them meet."""
    n_local = {r: len(shard_files(params.ref_sequences, n_r, r))
               for r in range(n_r)}
    G = max(n_local.values())
    params.finalize()
    scale_caps(G, params)
    mappers = {r: shard_mapper(params, idx, n_local[r], frags_per_slice)
               for r, idx in shards.items()}
    genomes = {r: torch.as_tensor(idx.genome_of_seq(), device=idx.device)
               for r, idx in shards.items()}

    def step(frags):
        dev = next(iter(shards.values())).device
        f = torch.as_tensor(frags, device=dev)
        if f.shape[0] > n_q * frags_per_slice:
            raise ValueError(f"{f.shape[0]} fragments for {n_q} slices of "
                             f"{frags_per_slice}")
        sums = torch.zeros((n_r, G), dtype=torch.float32, device=dev)
        counts = torch.zeros((n_r, G), dtype=torch.int32, device=dev)
        for r, mapper in sorted(mappers.items()):
            rows = torch.cat([
                _slice_rows(mapper, f[q0:q0 + frags_per_slice], q0, params)
                for q0 in range(0, f.shape[0], frags_per_slice)], 1)
            # fallback rows may hold sketches past the cap
            s_max = params.sketch_cap
            if rows.shape[1]:
                s_max = max(s_max, int(rows[5].max()))
            lut = torch.as_tensor(
                device_cgi.identity_lut_full(params.kmer_size, s_max),
                device=dev)
            c, sm = device_cgi.cgi_matrices(
                rows[1], rows[2], rows[3], rows[4], rows[5], rows[6],
                torch.ones(rows.shape[1], dtype=torch.bool, device=dev),
                genomes[r], lut, params.frag_len, 1, n_local[r])
            counts[r, :n_local[r]] = c[0]
            sums[r, :n_local[r]] = sm[0]
        return sums, counts

    return step


def shard_sanity(index: ReferenceIndex, max_ratio_diff: float
                 ) -> Tuple[bool, float]:
    """One shard's repeat sanity check (winSketch.hpp:298-318, reported
    per split at core_genome_identity.cpp:125-130): (passes, ratio
    difference)."""
    ok = index.sanity_check(max_ratio_diff)
    return ok, index.ratio_difference


@dataclasses.dataclass
class GlobalLayout:
    """The unsharded index's contig numbering: contigs of file 0, then of
    file 1, and so on."""
    global_sid: Dict[int, np.ndarray]   # shard r -> global seqId per local
    genome_of_seq: np.ndarray           # global seqId -> global genome
    contig_lengths: np.ndarray          # (n_seqs,) int64, global order


def shard_contigs(index: ReferenceIndex) -> Tuple[np.ndarray, np.ndarray]:
    """What ``global_layout`` needs of one shard: its file boundaries and
    contig lengths."""
    return (np.asarray(index.sequences_by_file, np.int64),
            np.array([c.length for c in index.metadata], np.int64))


def global_layout(contigs: Dict[int, Tuple[np.ndarray, np.ndarray]],
                  n_files: int, n_r: int) -> GlobalLayout:
    """The layout from every shard's ``shard_contigs``: file j is the
    (j // n_r)-th file of shard j % n_r."""
    gsid = {r: np.zeros(len(lens), np.int64)
            for r, (_, lens) in contigs.items()}
    lengths, genomes = [], []
    n = 0
    for j in range(n_files):
        r, li = j % n_r, j // n_r
        bounds, lens = contigs[r]
        lo, hi = (int(bounds[li - 1]) if li else 0), int(bounds[li])
        gsid[r][lo:hi] = np.arange(n, n + hi - lo)
        lengths.append(lens[lo:hi])
        genomes.append(np.full(hi - lo, j, np.int32))
        n += hi - lo
    cat = lambda xs, dt: np.concatenate(xs) if xs else np.zeros(0, dt)
    return GlobalLayout(gsid, cat(genomes, np.int32), cat(lengths, np.int64))
