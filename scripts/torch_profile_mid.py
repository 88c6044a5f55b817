#!/usr/bin/env python3
"""Where the time goes on the card: the port's fast path on bench.py's
``mid`` workload (32 genomes x 3 Mbp, all-vs-all, seed 123) under
torch.profiler.

    python3 scripts/torch_profile_mid.py

Runs ``run_fast`` once to warm up, then once under the profiler, and
prints one JSON line: wall time, summed device kernel time, the device's
idle share of the wall time, and the top CUDA kernels by device time
(names as the profiler reports them).  Needs a CUDA device.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
N_GENOMES = 32
TOP = 25          # kernels listed


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile_mid: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from fastani_tpu_torch.config import Parameters
    from fastani_tpu_torch.models import pipeline

    wd = ROOT / ".smokework" / "profile"
    wd.mkdir(parents=True, exist_ok=True)
    paths = chip_smoke.build_workload(np, wd, N_GENOMES,
                                       chip_smoke.GENOME_BP)

    def run():
        params = Parameters(ref_sequences=paths, query_sequences=paths,
                            out_file_name=str(wd / "out.txt"))
        stats = {}
        torch.cuda.synchronize()
        t0 = time.time()
        pipeline.run_fast(params, device="cuda", log=lambda m: None,
                          stats=stats)
        torch.cuda.synchronize()
        return time.time() - t0, stats

    run()                                             # warm-up
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall, stats = run()
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type.name == "CUDA"
                   and ev.self_device_time_total > 0), reverse=True)
    if not rows:
        raise RuntimeError("the profiler recorded no device kernels")
    total_dev_us = sum(us for us, _, _ in rows)
    if total_dev_us / 1e6 > wall:
        # one stream: device time above the wall means the sum is wrong
        raise RuntimeError(f"summed device time {total_dev_us / 1e6} s "
                           f"exceeds the wall time {wall} s")
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": chip_smoke.nvidia_smi(),
        "genomes": N_GENOMES, "wall_s": wall,
        "phases_s": {k: v for k, v in stats.items() if k.startswith("t_")},
        "device_kernel_s": total_dev_us / 1e6,
        "device_idle_share": 1.0 - total_dev_us / 1e6 / wall,
        "top_kernels": [{"name": name[:90], "device_ms": us / 1e3,
                         "share": us / total_dev_us,
                         "calls": n}
                        for us, name, n in rows[:TOP]],
    }))
    shutil.rmtree(wd, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
