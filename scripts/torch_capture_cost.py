#!/usr/bin/env python3
"""The one-off cost of a run's first batch (the warm-up and the CUDA graph
capture) against the run's map loop, on one card.

    python3 scripts/torch_capture_cost.py [--runs 3] [--out FILE]

bench.py's mid workload (``chip_smoke.build_workload``, seed 123: 32
genomes x 3 Mbp) through the CLI's fast path ``--runs`` times in one
process.  Each run builds its own mapper, so each warms its stages up
and captures them at its first batch (``jitmap.Mapper._capture``); the
first run is also the process's first at mid's shapes.  Per run: the
wall, the map loop (``t_map_fold``), the warm-up's and the capture's
seconds (``Mapper.graph_stats``), and for each of the three stages the
host seconds between ``CUDAGraph.capture_begin`` and ``capture_end``
(recording) and inside ``capture_end`` (instantiation).  Prints one JSON
line a run, and the card's name and power limit; with ``--out`` also
writes the lines there.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", default="")
    a = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_capture_cost: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from fastani_tpu_torch import cli
    from fastani_tpu_torch.ops import cuda as kc

    smi = chip_smoke.nvidia_smi()
    kc.build_all()
    wd = ROOT / ".smokework" / "capture_cost"
    wd.mkdir(parents=True, exist_ok=True)
    paths = chip_smoke.build_workload(np, wd, chip_smoke.N_GENOMES,
                                       chip_smoke.GENOME_BP)
    (wd / "g.txt").write_text("\n".join(paths) + "\n")

    marks = []
    graph = torch.cuda.CUDAGraph
    begin, end = graph.capture_begin, graph.capture_end

    def timed_begin(self, *args, **kw):
        marks.append(time.perf_counter())
        return begin(self, *args, **kw)

    def timed_end(self, *args, **kw):
        t0 = time.perf_counter()
        out = end(self, *args, **kw)
        marks.extend((t0, time.perf_counter()))
        return out

    graph.capture_begin, graph.capture_end = timed_begin, timed_end
    lines = []
    try:
        for run in range(a.runs):
            marks.clear()
            stats = {}
            torch.cuda.synchronize()
            t0 = time.time()
            rc = cli.main(["--ql", str(wd / "g.txt"), "--rl", str(wd / "g.txt"),
                           "-o", str(wd / f"out{run}.txt"), "--device",
                           "cuda"], stats=stats)
            torch.cuda.synchronize()
            wall = time.time() - t0
            if rc:
                raise SystemExit(f"the CLI exited with {rc}")
            stages = [{"record_s": marks[i + 1] - marks[i],
                       "instantiate_s": marks[i + 2] - marks[i + 1]}
                      for i in range(0, len(marks), 3)]
            row = {"run": run, "nvidia_smi": smi, "wall_s": wall,
                   "t_map_fold_s": stats["t_map_fold"],
                   "t_warmup_s": stats["t_warmup"],
                   "t_capture_s": stats["t_capture"],
                   "graphs": stats["graphs"],
                   "eager_batches": stats["eager_batches"],
                   "batches": stats["batches"], "stages": stages,
                   "tsv_equal_first": (wd / f"out{run}.txt").read_bytes()
                   == (wd / "out0.txt").read_bytes()}
            lines.append(json.dumps(row))
            print(lines[-1], flush=True)
    finally:
        graph.capture_begin, graph.capture_end = begin, end
        shutil.rmtree(wd)
    print(smi, flush=True)
    if a.out:
        pathlib.Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(a.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
