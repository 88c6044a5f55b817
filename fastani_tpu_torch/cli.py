"""Command line of the port, with the reference fastANI flags
(src/map/include/parseCmdArgs.hpp:114-234) plus ``--device``:

    python -m fastani_tpu_torch.cli -q genome1.fa -r genome2.fa -o out.txt
    python -m fastani_tpu_torch.cli --ql queries.txt --rl refs.txt -o out.txt --matrix
    python -m fastani_tpu_torch.cli -q a.fa -r b.fa -o out.txt --profile prof/
    python -m fastani_tpu_torch.cli -q a.fa -r b.fa -o out.txt --exact --visualize
    python -m fastani_tpu_torch.cli -q a.fa -r b.fa -o out.txt --saveIndex ref.npz
    python -m fastani_tpu_torch.cli -q a.fa --loadIndex ref.npz -o out.txt
    python -m fastani_tpu_torch.cli --ql q.txt --rl r.txt -o out.txt --mesh 2x2

It runs on ``--device`` (default ``cuda``) the fast path
(``models.pipeline.run_fast``), or, with ``--exact``, ``--visualize`` or
``-s``, the exact path (``models.pipeline.run``: the host fold, whose TSV
and ``.matrix`` are byte-equal to the reference's, the ``.visual`` file
and the repeat sanity check).  Without ``--mesh`` or ``--coordinator`` a
job is the 1x1 grid; with them the same two jobs run sharded over the
grid, and every process of a run over several runs this CLI with its
``--procid``.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from fastani_tpu_torch import __version__
from fastani_tpu_torch.config import Parameters


def parse_file_list(path: str) -> List[str]:
    try:
        with open(path) as f:
            return [line.strip() for line in f if line.strip()]
    except OSError:
        print(f"ERROR, fastani_tpu_torch, could not open {path}", file=sys.stderr)
        raise SystemExit(1)


def validate_input_files(paths: List[str]) -> None:
    """Every genome file must open and be non-empty (reference:
    parseCmdArgs.hpp:59-90)."""
    import gzip
    import os

    bad = False
    for p in paths:
        try:
            opener = gzip.open if p.endswith(".gz") else open
            if os.path.getsize(p) == 0:
                raise OSError("file is empty")
            with opener(p, "rb") as f:
                if not f.read(1):
                    raise OSError("file is empty")
        except OSError as e:
            print(f"ERROR, fastani_tpu_torch, input file {p}: "
                  f"{e.strerror or e}", file=sys.stderr)
            bad = True
    if bad:
        raise SystemExit(1)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fastani_tpu_torch",
        description="Alignment-free whole-genome ANI on an NVIDIA GPU "
                    "(capabilities of ParBLiSS/FastANI)")
    p.add_argument("-r", "--ref", help="reference genome (fasta/fastq)[.gz]")
    p.add_argument("--rl", "--refList", dest="refList",
                   help="file with list of reference genomes, one per line")
    p.add_argument("-q", "--query", help="query genome (fasta/fastq)[.gz]")
    p.add_argument("--ql", "--queryList", dest="queryList",
                   help="file with list of query genomes, one per line")
    p.add_argument("-k", "--kmer", type=int, default=16, help="kmer size <= 16 [16]")
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="accepted for compatibility; the output does not depend on it")
    p.add_argument("--fragLen", type=int, default=3000, help="fragment length [3000]")
    p.add_argument("--minFraction", type=float, default=0.2,
                   help="minimum shared-genome fraction for trusting ANI [0.2]")
    p.add_argument("--maxRatioDiff", type=float, default=100.0,
                   help="max sanity-check ratio difference [100.0] (with -s)")
    p.add_argument("--visualize", action="store_true",
                   help="output mappings for visualization (exact path)")
    p.add_argument("--matrix", action="store_true",
                   help="also output phylip-style lower-triangular matrix")
    p.add_argument("-o", "--output", help="output file name")
    p.add_argument("-s", "--sanityCheck", action="store_true",
                   help="run the repeat sanity check (exact path)")
    p.add_argument("--exact", action="store_true",
                   help="fold the mappings on the host as the reference does "
                        "(byte-equal TSV and .matrix); implied by "
                        "--visualize and -s")
    p.add_argument("-v", "--version", action="store_true", help="show version")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on [cuda]; 'cpu' runs the plain "
                        "PyTorch versions of the kernels")
    p.add_argument("--saveIndex", dest="saveIndex", default="",
                   help="persist the built reference index to this .npz "
                        "(with --mesh: one file per shard, "
                        "PREFIX.rRofN.npz)")
    p.add_argument("--loadIndex", dest="loadIndex", default="",
                   help="restore a persisted reference index instead of "
                        "sketching (the reference file list comes from the "
                        "index, so -r is optional)")
    p.add_argument("--profile", dest="profile", default="",
                   help="write a torch.profiler Chrome trace of the whole "
                        "job, index build to write, with the program's "
                        "spans beside the kernels, into this directory as "
                        "job.pt.trace.json (single-device runs)")
    p.add_argument("--mesh", default="",
                   help="run sharded on an RxQ grid, e.g. --mesh 2x4 (R "
                        "reference shards x Q slices of each fragment "
                        "batch); 'auto' factors torch.cuda.device_count() "
                        "(1x1 on cpu).  One process runs every cell on its "
                        "device; output equals the single-device run's")
    p.add_argument("--coordinator", default="",
                   help="address host:port of a run over several processes "
                        "(torch.distributed; NCCL on cuda, gloo on cpu); "
                        "every process runs this CLI")
    p.add_argument("--nprocs", type=int, default=0,
                   help="number of processes of the run")
    p.add_argument("--procid", type=int, default=-1,
                   help="this process's id (0-based)")
    return p


def main(argv=None, stats: Optional[dict] = None) -> int:
    """Run the CLI; ``stats``, when given, receives the path's phase wall
    times and counters."""
    args = build_parser().parse_args(argv)
    if args.version:
        print(f"fastani_tpu_torch {__version__}")
        return 0
    if not args.ref and not args.refList and not args.loadIndex:
        print("Provide reference file(s)", file=sys.stderr)
        return 1
    if not args.query and not args.queryList:
        print("Provide query file(s)", file=sys.stderr)
        return 1
    if not args.output:
        print("Provide output file (-o)", file=sys.stderr)
        return 1
    params = Parameters(
        kmer_size=args.kmer,
        frag_len=args.fragLen,
        min_fraction=args.minFraction,
        max_ratio_diff=args.maxRatioDiff,
        visualize=args.visualize,
        matrix_output=args.matrix,
        sanity_check=args.sanityCheck,
        out_file_name=args.output,
        save_index=args.saveIndex,
        load_index=args.loadIndex,
        profile_dir=args.profile,
        ref_sequences=([args.ref] if args.ref
                       else parse_file_list(args.refList) if args.refList
                       else []),
        query_sequences=([args.query] if args.query
                         else parse_file_list(args.queryList)),
    )
    validate_input_files(list(params.query_sequences)
                         + list(params.ref_sequences))

    # the .visual rows and the sanity ratios come from the exact path only
    # (reference: one binary covers all modes, parseCmdArgs.hpp:114-234)
    exact = args.exact or args.visualize or args.sanityCheck
    n_r = n_q = 1
    if args.mesh and args.mesh != "auto":
        n_r, n_q = (int(x) for x in args.mesh.lower().split("x"))
    elif args.mesh or args.coordinator:
        n_r = n_q = None                    # --mesh auto
    from fastani_tpu_torch.models import pipeline

    run = pipeline.run if exact else pipeline.run_fast
    run(params, device=args.device, stats=stats, n_r=n_r, n_q=n_q,
        coordinator=args.coordinator or None,
        num_processes=args.nprocs or None,
        process_id=args.procid if args.procid >= 0 else None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
