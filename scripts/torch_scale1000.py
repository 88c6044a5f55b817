#!/usr/bin/env python3
"""The 1000-genome clustered all-vs-all on one card, through the port (the
counterpart of scripts/run_scale1000.py).

    python3 scripts/torch_scale1000.py [--genomes 1000] [--size 1000000]
        [--clusters 20] [--frag-batch 512] [--queries 0] [--workdir DIR]
        [--tsv FILE]

Workload (``chip_smoke.build_clustered``, seed 1234): ``--clusters``
unrelated random genomes of ``--size`` bases, each the base of
ceil(genomes / clusters) strains with 1%..5% substitutions and 0.0002
indels; all against all (or the first ``--queries`` genomes against all).

As the JAX script does, the caps come from one cluster's genome count
(``scale_caps(per_cluster)``, ``unit_factor`` max(per + 2, 1.7 per + 8),
``unit_chunk`` 512), not from the 1000: a fragment maps to its own
cluster.  An overflowed fragment is redone exactly, so the answer does
not depend on the caps.  Runs the port's pieces one by one on the card:
the device index build, ``jitmap.Mapper``, ``pipeline.FragmentStream``,
``autotune_hits_cap``, ``map_queries_cgi_stream`` and
``map_queries_cgi_finish``; each phase's seconds end in a
synchronise.  Prints one JSON line (phase seconds, genome-pairs/s, caps,
the counters' maxima, peak device bytes, the card's name and power
limit); ``--tsv`` writes the run's TSV (the CLI's format) for a
comparison with the CLI's run.  Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def run(paths: list, clusters: int, frag_batch: int = 512, queries: int = 0,
        tsv: str = "") -> dict:
    """The first ``queries`` genomes of ``paths`` (all if 0) against all of
    them, ``clusters`` clusters of consecutive genomes, on the card;
    returns the JSON line's dict (without the card's line)."""
    import numpy as np
    import torch

    from fastani_tpu_torch.config import Parameters, scale_caps
    from fastani_tpu_torch.index.sketch import ReferenceIndex
    from fastani_tpu_torch.models import ani, jitmap, pipeline

    dev = torch.device("cuda")
    genomes = len(paths)
    per = -(-genomes // clusters)
    params = Parameters(frag_batch=frag_batch, out_file_name=tsv).finalize()
    scale_caps(per, params)
    params.ref_sequences = list(paths)
    params.query_sequences = list(paths[:queries] if queries else paths)
    n_q = len(params.query_sequences)
    torch.cuda.reset_peak_memory_stats(dev)
    sec = {}

    def phase(name, fn):
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize(dev)
        sec[name] = time.time() - t0
        return out

    index = phase("index_build", lambda: ReferenceIndex.build_device(
        params, device=dev))
    uf = max(per + 2, int(1.7 * per) + 8)
    mapper = phase("mapper_init", lambda: jitmap.Mapper(
        params, index, unit_factor=uf, unit_chunk=512))
    stream = phase("ingest", lambda: pipeline.FragmentStream(
        params.query_sequences, params))
    static_cap = params.hits_cap
    mapper = phase("autotune", lambda: pipeline.autotune_hits_cap(
        mapper, stream, params))
    grid = pipeline.Grid.single(index, mapper)
    handle = phase("stream", lambda: pipeline.map_queries_cgi_stream(
        stream, grid, params, n_q))
    stats = {}
    counts, sums = phase("readout", lambda: pipeline.map_queries_cgi_finish(
        handle, grid, params, stats=stats))
    total = sum(sec.values())
    mapped = counts > 0
    same = (np.arange(n_q)[:, None] // per) == (np.arange(genomes) // per)
    if tsv:
        phase("write", lambda: pipeline.write_results(
            ani.results_from_matrices(counts, sums, stream.total_fragments),
            params))
    return {
        "genomes": genomes, "queries": n_q, "clusters": clusters,
        "pairs": n_q * genomes, "seconds": sec,
        "total_s": total, "pairs_per_s": n_q * genomes / total,
        "frags": stream.F, "batches": stats["batches"],
        "caps": {"hits_cap_static": static_cap, "hits_cap": params.hits_cap,
                 "cand_cap": params.cand_cap,
                 "l2_entry_cap": params.l2_entry_cap,
                 "sketch_cap": params.sketch_cap,
                 "unit_cap": mapper.cfg.unit_cap, "unit_factor": uf,
                 "frag_batch": frag_batch},
        "counters_max": {k: stats[k] for k in jitmap.COUNT_NAMES},
        "fallback_frags": stats["fallback_frags"],
        "redone_queries": stats["redone_queries"],
        "ani_rows": int(mapped.sum()),
        "same_cluster_pairs_mapped": int((mapped & same).sum()),
        "cross_cluster_pairs_mapped": int((mapped & ~same).sum()),
        "index_entries": index.n_entries,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
        **{f"mapper_{k}": v for k, v in mapper.graph_stats().items()},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genomes", type=int, default=1000)
    ap.add_argument("--size", type=int, default=1_000_000)
    ap.add_argument("--clusters", type=int, default=20)
    ap.add_argument("--frag-batch", type=int, default=512)
    ap.add_argument("--queries", type=int, default=0)
    ap.add_argument("--workdir", default="")
    ap.add_argument("--tsv", default="")
    a = ap.parse_args()

    import numpy as np

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    wd = pathlib.Path(a.workdir or ROOT / ".smokework" /
                      f"scale_{a.genomes}x{a.size}x{a.clusters}")
    wd.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    paths = chip_smoke.build_clustered(np, wd, a.genomes, a.size, a.clusters)
    gen_s = time.time() - t0
    row = {"workload": f"clustered all-vs-all, {a.genomes} x {a.size} bp, "
                       f"{a.clusters} clusters, seed 1234", "gen_s": gen_s,
           **run(paths, a.clusters, a.frag_batch, a.queries, a.tsv),
           "nvidia_smi": chip_smoke.nvidia_smi()}
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
