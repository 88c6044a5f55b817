"""Reference shards of a sharded job (counterpart of
``fastani_tpu/parallel/mesh.py``).

Round-robin sharding, the reference's splitReferenceGenomes law
(computeCoreIdentity.hpp:457-474): file j goes to shard j % n_r, so local
genome g of shard r is global genome g * n_r + r (correctRefGenomeIds,
:480-487).  Each process builds, or loads, only the shards whose cells it
runs (``models.pipeline.build_shards``); with ``--saveIndex``/
``--loadIndex`` a sharded job's shard is the file
``{prefix}.r{r}of{n_r}.npz`` (``shard_path``).

Not ported: the JAX package's stacked, padded ``ShardedIndex`` arrays and
``local_shard_dims``/``allgather_shard_dims``.  They exist so that
``shard_map`` sees equal shapes on every device; a torch process holds its
shards at their own sizes, each under its own ``Mapper``.  What the jobs
still need of them is here: the global genome ids and the map from each
shard's seqIds to the seqIds of the unsharded index (``GlobalLayout``),
which puts the ``.visual`` rows in the single-device order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from fastani_tpu_torch.index.sketch import ReferenceIndex


def shard_files(ref_files: Sequence[str], n_r: int, r: int) -> List[str]:
    """splitReferenceGenomes: file j belongs to shard j % n_r."""
    return [f for j, f in enumerate(ref_files) if j % n_r == r]


def global_genomes(n_local: int, n_r: int, r: int) -> np.ndarray:
    """correctRefGenomeIds: the global ids of shard r's n_local genomes."""
    return np.arange(n_local, dtype=np.int64) * n_r + r


def shard_path(prefix: str, r: int, n_r: int) -> str:
    return f"{prefix}.r{r}of{n_r}.npz"


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
