"""One run of one cell: set-up, the measured window of FastANI jobs (or,
with ``--trace 1``, one traced job), the check of the jobs' answers
against the plain reference, and the result line.

A job is one CLI invocation, ``fastani_tpu_torch.cli.main(argv,
stats=stats)``, FASTA to TSV and .matrix with the index built inside the
job, as a user runs it.  Jobs run back to back; a new one starts only
while fewer than ``--seconds`` have passed since the window opened.
``pairs_per_s`` is every ordered (query, reference) pair of every job
over the time from the window's start to the end of the last job.

Set-up, in order: import and start CUDA; build (first run in a checkout)
and load the kernel libraries; generate the panel from the seed and
write it as FASTA under TMPDIR; one warm-up job, the cell's own job cut
to its first batch of queries against the full reference list.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import signal
import sys
import tempfile
import time
import pathlib
from typing import Optional

from anibench import check, panels
from anibench.manifest import Manifest

FORBIDDEN = ("jax", "jaxlib", "flax", "fastani_tpu")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (``fastani_tpu_torch`` is not ``fastani_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def children() -> list:
    """The ids of this process's child processes that are still there."""
    me, out = os.getpid(), []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # the command name, in brackets, may hold spaces
        if int(stat[stat.rindex(")") + 2:].split()[1]) == me:
            out.append(int(d))
    return out


def end_children(wait_s: float = 5.0) -> list:
    """End every child process still there (SIGTERM, after ``wait_s`` a
    SIGKILL) and wait for each; returns their ids."""
    left = children()
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in left:
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < wait_s:
            for pid in left:
                try:
                    os.waitpid(pid, os.WNOHANG)
                except ChildProcessError:
                    pass
            if not set(children()) & set(left):
                return left
            time.sleep(0.05)
    return left


def _sync(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def run_job(argv: list, device: str):
    """One CLI job; returns (its stats, its seconds, its exit code)."""
    from fastani_tpu_torch import cli

    stats: dict = {}
    if device != "cuda":
        argv = argv + ["--device", device]
    t0 = time.perf_counter()
    rc = cli.main(argv, stats=stats)
    _sync(device)
    return stats, time.perf_counter() - t0, rc


def prepare(device: str) -> dict:
    """Start CUDA, build what is not built and load the kernel libraries
    and the native reader.  Returns the seconds of each step."""
    import torch
    from fastani_tpu_torch import native
    from fastani_tpu_torch.ops import cuda as kc

    out = {}
    t0 = time.perf_counter()
    if device == "cuda":
        torch.cuda.init()
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    out["cuda_init_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    built = {}
    if device == "cuda":
        built = kc.build_all()
        for name in kc.SOURCES:
            kc.lib(name)
    native_built = not native.lib_path().exists()
    native.load()
    out["compile_s"] = time.perf_counter() - t0 if (built or native_built) \
        else 0.0
    out["load_s"] = time.perf_counter() - t0
    return out


PHASES = ("t_index_build", "t_mapper_init", "t_autotune", "t_map_fold",
          "t_write")


def job_line(i: int, wall: float, pairs: int, stats: dict) -> str:
    rec = {"job": i, "wall_s": wall, "pairs": pairs}
    rec.update({k: stats.get(k) for k in PHASES})
    rec["batches"] = stats.get("batches")
    rec["fallback_frags"] = stats.get("fallback_frags")
    rec["hits_cap"] = stats.get("hits_cap")
    return json.dumps(rec)


def run_cell(man: Manifest, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: Optional[float] = None,
             out=sys.stdout, err=sys.stderr) -> Optional[dict]:
    """Run one cell; returns the result line's object (``None`` when a
    module that may not be loaded was loaded)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cell = man.workload(workload)
    config = man.config(cell["config"])
    traffic = man.traffic(cell["traffic"])
    setup = prepare(device)
    work = pathlib.Path(tempfile.mkdtemp(prefix="anibench_"))
    try:
        t0 = time.perf_counter()
        panel = panels.make_panel(config, traffic, seed, work / "panel")
        setup["generate_s"] = time.perf_counter() - t0
        # the first batch, as the CLI sizes it: the program's own default
        from fastani_tpu_torch.config import Parameters

        warm_q = panels.warmup_queries(panel, config,
                                       Parameters().frag_batch)
        st, wall, rc = run_job(panel.job_argv(str(work / "warm.tsv"),
                                              warm_q), device)
        setup["warmup_job_s"] = wall
        if rc != 0:
            raise RuntimeError(f"the warm-up job exited with {rc}")
        setup_s = time.perf_counter() - t_start
        print(json.dumps({"setup": setup, "setup_s": setup_s}), file=out)

        pairs_per_job = len(panel.queries) * len(panel.refs)
        jobs, outs, failed = [], [], 0
        summary = None
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        if trace:
            from torch.profiler import ProfilerActivity, profile, \
                record_function

            from anibench import trace as tr

            acts = [ProfilerActivity.CPU]
            if device == "cuda":
                acts.append(ProfilerActivity.CUDA)
            o = str(work / "job0.tsv")
            l2 = tr.L2Work()
            with tr.wrapped_ranges(), tr.counting_l2(l2), \
                    profile(activities=acts) as prof:
                with record_function(tr.JOB_RANGE):
                    st, wall, rc = run_job(panel.job_argv(o), device)
            l2_work = l2.result()
            t_read = time.perf_counter()
            summary = tr.summarize(*tr.read_profile(prof))
            del prof
            print(json.dumps({"trace_read_s": time.perf_counter() - t_read,
                              "traced_job_s": wall, "l2_work": l2_work}),
                  file=out)
            jobs.append(st)
            outs.append(o)
            failed += rc != 0
            print(job_line(0, wall, pairs_per_job, st), file=out)
            window = wall
        else:
            t_open = time.perf_counter()
            while time.perf_counter() - t_open < seconds:
                o = str(work / f"job{len(jobs)}.tsv")
                st, wall, rc = run_job(panel.job_argv(o), device)
                print(job_line(len(jobs), wall, pairs_per_job, st), file=out)
                jobs.append(st)
                outs.append(o)
                failed += rc != 0
            window = time.perf_counter() - t_open
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

        t0 = time.perf_counter()
        pairs = panels.check_sample(panel, traffic, seed)
        parts: dict = {}
        ref = check.reference_answers(pairs, config, torch.device(device),
                                      times=parts)["float32"]
        numbers = check.compare(ref, outs, pairs, panel.queries)
        numbers["jobs_failed"] = failed
        print(json.dumps({"reference_s": time.perf_counter() - t0,
                          "pairs_checked": len(pairs),
                          "reference_parts": parts}), file=out)
        correct = failed == 0 and check.judge(numbers)

        values = {"pairs_per_s": pairs_per_job * len(jobs) / window,
                  "peak_mem_gb": peak / 1e9, "setup_s": setup_s}
        dev = {"platform": "gpu" if device == "cuda" else device,
               "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                        else "cpu"),
               "count": cell["chips"], "memory_peak_bytes": int(peak)}
        if trace:
            ctx = {"jobs": jobs, "trace": summary, "config": config,
                   "l2_work": l2_work}
            metrics = {}
            for m in man.per_layer(workload):
                v = man.metric_reader(m["name"]).read(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            dev["busy_s"] = summary["busy_s"]
            dev["window_s"] = summary["window_s"]
        else:
            metrics = {m["name"]: {"value": values[m["name"]],
                                   "unit": m["unit"]}
                       for m in man.end_to_end(workload)}
    finally:
        shutil.rmtree(work, ignore_errors=True)

    bad = forbidden_modules()
    if bad:
        print(f"anibench: modules that may not be loaded were: {bad}",
              file=err)
        return None
    limits = dict(check.LIMITS, jobs_failed=0)
    result = {"correct": bool(correct), "attempted": len(jobs),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
        print(json.dumps({"idle_by_range": summary["idle_by_range"]}),
              file=out)
    result["compared"] = {k: {"value": numbers[k], "limit": limits[k]}
                          for k in limits}
    for k in limits:
        print(f"{k} {numbers[k]!r} limit {limits[k]!r}", file=err)
    return result


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="anibench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    man = Manifest()
    cell = man.workload(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"anibench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        result = run_cell(man, args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", t_start)
    finally:
        left = end_children()
        if left:
            print(f"anibench: ended child processes left running: {left}",
                  file=sys.stderr)
    if result is None:
        return 3
    sys.stdout.flush()
    print(json.dumps(result))
    return 0
