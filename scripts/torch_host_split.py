#!/usr/bin/env python3
"""The fast path's host time split by op, from a ``--profile`` trace, on
one card.

    python3 scripts/torch_host_split.py [--tree DIR] [--queries 8] [--eager]
                                        [--workload mid] [--out FILE]

A workload is written, by ``--workload``: bench.py's mid
(``chip_smoke.build_workload``, seed 123: 32 genomes x 3 Mbp), its
``full`` (the same generator, ``chip_smoke.FULL``: 100 x 3 Mbp) or the
clustered 1000-genome panel (``chip_smoke.build_clustered``,
``chip_smoke.SCALE1000``: 20 clusters of 50 x 1 Mbp, seed 1234); then its
first ``--queries`` query genomes are mapped against all of it through
the CLI's fast path with ``--profile``
(as ``chip_smoke.py``'s ``profile`` phase does), with the package of
``--tree`` (default: this checkout; give an unpacked older commit to
measure it).  Each of these functions, where the tree has it, runs inside
a ``torch.profiler.record_function`` range of its name:
``pipeline.map_batch_cgi`` (one batch: map step, CGI update; on older
trees also the counts read), ``jitmap.Mapper.dispatch`` (older trees:
``jitmap.Mapper.map_batch``), ``jitmap.locate_units``,
``l2walk.l2_walk_units`` and ``l2walk.build_events`` (once a chunk when
the chunk runs eagerly), ``jitmap.stage_chunk``,
``jitmap.StepGraphs.replay_chunks`` (a batch's chunk replays) and
``device_cgi.finalize_rows``.  ``--eager`` builds every mapper with
``graphs=False`` (``chip_smoke.eager_mappers``; a tree whose ``Mapper``
takes it).

From the trace: ``chip_smoke.trace_summary`` (the window, first event to
last; the device's kernels, their count a batch, summed time and idle
share, and the twenty kernels with the most device time), each host
op's self time (its span less the spans nested in it on its thread)
summed by name, the top ten, each range's summed span and
share of the window, and the host's launch calls (CUDA API calls whose
name holds ``Launch``, graph launches among them) and memory copies a
batch.  Prints one JSON line,
also written to ``--out``, with the card's name and power limit.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import pathlib
import shutil
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent

# (module, attribute path, range name) of the functions timed as ranges
RANGES = (
    ("pipeline", "map_batch_cgi", "batch"),
    ("jitmap", "Mapper.dispatch", "dispatch"),
    ("jitmap", "Mapper.map_batch", "map_batch"),
    ("jitmap", "locate_units", "locate_units"),
    ("l2walk", "l2_walk_units", "l2_walk_units"),
    ("l2walk", "build_events", "build_events"),
    ("jitmap", "stage_chunk", "stage_chunk"),
    ("jitmap", "StepGraphs.replay_chunks", "replay_chunks"),
    ("device_cgi", "finalize_rows", "finalize_rows"),
)
# the trace's host categories: CPU ops, ranges, Python functions and the
# CUDA API calls (category names starting with "cuda_")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


def is_host(cat) -> bool:
    return cat in HOST_CATS or is_api(cat)


def is_api(cat) -> bool:
    return str(cat).startswith("cuda_")


def wrap_ranges(torch, mods: dict) -> list:
    """Wrap every function of RANGES the tree has; returns the names."""
    done = []
    for mod, path, name in RANGES:
        owner = mods[mod]
        *outer, attr = path.split(".")
        for part in outer:
            owner = getattr(owner, part, None)
        fn = getattr(owner, attr, None) if owner is not None else None
        if fn is None:
            continue

        def ranged(*args, _fn=fn, _name=name, **kw):
            with torch.profiler.record_function(f"range:{_name}"):
                return _fn(*args, **kw)

        setattr(owner, attr, functools.wraps(fn)(ranged))
        done.append(name)
    return done


def self_times(events: list) -> dict:
    """{(cat, name): [self us, count]} of the host events: each event's
    span less the spans of the events nested in it on its thread."""
    out = {}
    by_tid = {}
    for e in events:
        if is_host(e.get("cat")):
            by_tid.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    for evs in by_tid.values():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0))))
        stack = []              # [end, self us, key]

        def close(item):
            t = out.setdefault(item[2], [0.0, 0])
            t[0] += item[1]
            t[1] += 1

        for e in evs:
            ts, dur = float(e["ts"]), float(e.get("dur", 0))
            while stack and stack[-1][0] <= ts:
                close(stack.pop())
            if stack:
                stack[-1][1] -= min(dur, stack[-1][0] - ts)
            stack.append([ts + dur, dur, (e["cat"], e["name"])])
        while stack:
            close(stack.pop())
    return out


def summarize(chip_smoke, path: str, batches: int) -> dict:
    """``chip_smoke.trace_summary`` of the trace (window, device kernels,
    idle share), with the host's side: each op's self time, the ranges'
    spans, and the launch calls and copies."""
    events = chip_smoke.trace_events(path)
    base = chip_smoke.trace_summary(events, top=20)
    window = base["window_s"] * 1e6
    st = self_times(events)
    ops = sorted(((k, v) for k, v in st.items()
                  if k[0] == "cpu_op" or is_api(k[0])),
                 key=lambda kv: -kv[1][0])
    ranges = {}
    for e in events:
        if e.get("cat") == "user_annotation" and \
                e["name"].startswith("range:"):
            t = ranges.setdefault(e["name"][6:], [0.0, 0])
            t[0] += float(e.get("dur", 0))
            t[1] += 1
    calls = {}
    for (cat, name), (_, n) in st.items():
        if is_api(cat):
            calls[name] = calls.get(name, 0) + n
    launch = {k: v for k, v in calls.items() if "Launch" in k}
    copies = {k: v for k, v in calls.items()
              if "Memcpy" in k or "Memset" in k}
    cats = {}
    for e in events:
        cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
    return {
        "trace_bytes": os.path.getsize(path), **base,
        "event_categories": cats,
        "top_host_ops": [{"cat": c, "name": n[:80], "self_s": t / 1e6,
                          "share": t / window, "calls": k}
                         for (c, n), (t, k) in ops[:10]],
        "host_ops_self_s": sum(t for _, (t, _) in ops) / 1e6,
        "ranges": {n: {"s": t / 1e6, "share": t / window, "calls": k}
                   for n, (t, k) in ranges.items()},
        "launch_calls": launch,
        "launch_calls_per_batch": sum(launch.values()) / batches,
        "copy_calls": copies,
        "copy_calls_per_batch": sum(copies.values()) / batches,
        "device_kernels_per_batch": base["device_kernels"] / batches,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--queries", type=int, default=8)
    ap.add_argument("--eager", action="store_true")
    ap.add_argument("--workload", default="mid",
                    choices=("mid", "full", "scale1000"))
    ap.add_argument("--out", default="")
    a = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_host_split: no CUDA device", file=sys.stderr)
        return 2
    tree = pathlib.Path(a.tree).resolve()
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    sys.path.insert(0, str(tree))
    for name in [m for m in sys.modules if m.startswith("fastani_tpu_torch")]:
        del sys.modules[name]
    from fastani_tpu_torch import cli
    from fastani_tpu_torch.models import device_cgi, jitmap, l2walk, pipeline
    from fastani_tpu_torch.ops import cuda as kc

    smi = chip_smoke.nvidia_smi()
    kc.build_all()
    wd = tree / ".smokework" / "host_split"
    wd.mkdir(parents=True, exist_ok=True)
    if a.workload == "scale1000":
        paths = chip_smoke.build_clustered(np, wd, *chip_smoke.SCALE1000)
    else:
        paths = chip_smoke.build_workload(np, wd, *(
            chip_smoke.FULL if a.workload == "full" else
            (chip_smoke.N_GENOMES, chip_smoke.GENOME_BP)))
    (wd / "refs.txt").write_text("\n".join(paths) + "\n")
    (wd / "queries.txt").write_text("\n".join(paths[:a.queries]) + "\n")
    wrapped = wrap_ranges(torch, {"pipeline": pipeline, "jitmap": jitmap,
                                  "l2walk": l2walk,
                                  "device_cgi": device_cgi})
    args = ["--ql", str(wd / "queries.txt"), "--rl", str(wd / "refs.txt"),
            "--device", "cuda"]
    with chip_smoke.eager_mappers() if a.eager else \
            contextlib.nullcontext():
        # a warm run, then the profiled one
        rc = cli.main(args + ["-o", str(wd / "warm.txt")])
        stats = {}
        torch.cuda.synchronize()
        t0 = time.time()
        rc |= cli.main(args + ["-o", str(wd / "out.txt"), "--profile",
                               str(wd / "prof")], stats=stats)
        torch.cuda.synchronize()
        wall = time.time() - t0
    if rc:
        raise SystemExit(f"the CLI exited with {rc}")
    t0 = time.time()
    summary = summarize(chip_smoke, stats["profile_trace"], stats["batches"])
    row = {"tree": str(tree), "eager": a.eager, "nvidia_smi": smi,
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "workload": a.workload, "queries": a.queries,
           "genomes": len(paths),
           "batches": stats["batches"], "wall_s": wall,
           "t_map_fold_s": stats["t_map_fold"],
           "t_trace_read_s": time.time() - t0, "ranges_wrapped": wrapped,
           "tsv_equal_warm": (wd / "out.txt").read_bytes()
           == (wd / "warm.txt").read_bytes(), **summary}
    shutil.rmtree(wd)
    line = json.dumps(row)
    print(line, flush=True)
    if a.out:
        pathlib.Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(a.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
