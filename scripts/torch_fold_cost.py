#!/usr/bin/env python3
"""The cost of the fast path's fixed-order fold
(``device_cgi.finalize_rows``) against the float32 ``index_add_`` fold it
replaced, whose atomics sum in no fixed order on a card, in one process on
one card.

    python3 scripts/torch_fold_cost.py [--genomes 32] [--genome-bp 3000000]

1. bench.py's mid workload (``chip_smoke.build_workload``, seed 123: 32
   genomes x 3 Mbp, all against all) through ``pipeline.run_fast`` four
   times, in turns: atomic, fixed, fixed, atomic.  Each run's
   ``t_map_fold`` and wall; the finalize calls and their FIN (query
   genomes closed by the call); whether the fixed runs' TSVs are
   byte-equal, and the atomic runs'.
2. Each fold alone, replaying the run's finalize calls (its FIN, its
   reference bins) on a random table with 60% of the bins occupied: host
   seconds a call with a sync after it (the fast path is host-bound: the
   host issues the fold's launches), summed over the run's calls; then one
   call at FIN 4 with the longest reference genome stretched to 1008,
   2000 and 4000 bins (about 3, 6 and 12 Mbp at fragment length 3000), host
   seconds and CUDA-event milliseconds.

Prints one JSON line with the card's name and power limit.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def finalize_rows_atomic(tab, acc_counts, acc_sums, fin_qnos, ranges,
                         n_slots: int, rows=None):
    """The fold before the fixed order: per-(query, genome) segment sums by
    ``index_add_`` over each bin's genome id (float32 atomics on a card)."""
    import torch

    FIN = fin_qnos.shape[0]
    if not FIN:
        return tab, acc_counts, acc_sums
    dev = tab.device
    n_rg = ranges.shape[1]
    slots = fin_qnos % n_slots
    if rows is None:
        rows = tab[slots]
    # the genomes' bin ranges cover the bins in order (output_size given:
    # no read of the device)
    gid_of_bin = torch.repeat_interleave(torch.arange(n_rg, device=dev),
                                         ranges[1].long(),
                                         output_size=rows.shape[1])
    occ = rows >= 0
    ident = torch.where(occ, rows.view(torch.float32), 0.0)
    seg = torch.where(occ, gid_of_bin[None, :], n_rg)
    seg_flat = (torch.arange(FIN, device=dev)[:, None] * (n_rg + 1)
                + seg).reshape(-1)
    cnt = torch.zeros(FIN * (n_rg + 1), dtype=torch.int32, device=dev)
    cnt.index_add_(0, seg_flat, occ.to(torch.int32).reshape(-1))
    sm = torch.zeros(FIN * (n_rg + 1), dtype=torch.float32, device=dev)
    sm.index_add_(0, seg_flat, ident.reshape(-1))
    acc_counts.index_add_(0, fin_qnos, cnt.view(FIN, n_rg + 1)[:, :n_rg])
    acc_sums.index_add_(0, fin_qnos, sm.view(FIN, n_rg + 1)[:, :n_rg])
    tab[slots] = -1
    return tab, acc_counts, acc_sums


def random_table(torch, rng, fin: int, B_tot: int):
    """(fin, B_tot) int32 table, 60% of the bins holding float32
    identities in [76, 100), the rest -1."""
    ident = rng.uniform(76.0, 100.0, (fin, B_tot)).astype("float32")
    occ = rng.uniform(size=(fin, B_tot)) < 0.6
    tab = ident.view("int32").copy()
    tab[~occ] = -1
    return torch.as_tensor(tab, device="cuda")


def fold_seconds(torch, fold, tab, bins, n_rg: int, reps: int = 5):
    """(host seconds a call with a sync after it, CUDA-event ms a call),
    the least of ``reps`` calls after a warm-up."""
    fin = torch.arange(tab.shape[0], device="cuda")
    best_s, best_ms = float("inf"), float("inf")
    for i in range(reps + 1):
        t = tab.clone()
        c = torch.zeros((tab.shape[0], n_rg), dtype=torch.int32,
                        device="cuda")
        s = torch.zeros((tab.shape[0], n_rg), dtype=torch.float32,
                        device="cuda")
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        fold(t, c, s, fin, bins, tab.shape[0])
        e1.record()
        torch.cuda.synchronize()
        if i:
            best_s = min(best_s, time.perf_counter() - t0)
            best_ms = min(best_ms, e0.elapsed_time(e1))
    return best_s, best_ms


def stretched_bins(np, n_rg: int, bins_each: int, longest: int):
    """``genome_bins`` ranges of n_rg genomes of ``bins_each`` bins, the
    last of ``longest``."""
    from fastani_tpu_torch.models import device_cgi

    n = [bins_each] * (n_rg - 1) + [longest]
    return device_cgi.genome_bins(np.repeat(np.arange(n_rg), n), n_rg)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genomes", type=int, default=32)
    ap.add_argument("--genome-bp", type=int, default=3_000_000)
    a = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_fold_cost: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from fastani_tpu_torch.config import Parameters
    from fastani_tpu_torch.models import device_cgi, pipeline

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    wd = ROOT / ".smokework" / "fold_cost"
    wd.mkdir(parents=True, exist_ok=True)
    paths = chip_smoke.build_workload(np, wd, a.genomes, a.genome_bp)

    fixed = device_cgi.finalize_rows
    calls = []

    def counted(fold):
        def run(tab, c, s, fin, bins, n_slots, rows=None):
            calls.append((int(fin.shape[0]), bins, tab.shape[1]))
            return fold(tab, c, s, fin, bins, n_slots, rows=rows)
        return run

    runs = []
    for name in ("atomic", "fixed", "fixed", "atomic"):
        calls.clear()
        device_cgi.finalize_rows = counted(
            fixed if name == "fixed" else finalize_rows_atomic)
        out = wd / f"{name}{len(runs)}.txt"
        stats = {}
        t0 = time.perf_counter()
        try:
            pipeline.run_fast(Parameters(ref_sequences=paths,
                                         query_sequences=paths,
                                         out_file_name=str(out)),
                              device="cuda", log=lambda m: None,
                              stats=stats)
        finally:
            device_cgi.finalize_rows = fixed
        runs.append({"fold": name, "wall_s": time.perf_counter() - t0,
                     "t_map_fold_s": stats["t_map_fold"],
                     "batches": stats["batches"],
                     "finalize_calls": len(calls),
                     "fin": [f for f, _, _ in calls],
                     "tsv": out.read_bytes()})
    replay = list(calls)
    same_fixed = runs[1]["tsv"] == runs[2]["tsv"]
    same_atomic = runs[0]["tsv"] == runs[3]["tsv"]
    for r in runs:
        del r["tsv"]

    rng = np.random.default_rng(7)
    bins, B_tot = replay[0][1], replay[0][2]
    n_rg = bins.shape[1]
    summed = {"fixed": 0.0, "atomic": 0.0}
    for fin, _, _ in replay:
        tab = random_table(torch, rng, fin, B_tot)
        for name, fold in (("fixed", fixed), ("atomic", finalize_rows_atomic)):
            summed[name] += fold_seconds(torch, fold, tab, bins, n_rg)[0]

    scaling = []
    for longest in (1008, 2000, 4000):
        tot = 1008 * (n_rg - 1) + longest
        bt = torch.as_tensor(stretched_bins(np, n_rg, 1008, longest),
                             device="cuda")
        tab = random_table(torch, rng, 4, tot)
        row = {"longest_bins": longest, "B_tot": tot, "FIN": 4}
        for name, fold in (("fixed", fixed), ("atomic", finalize_rows_atomic)):
            s, ms = fold_seconds(torch, fold, tab, bt, n_rg)
            row[f"{name}_host_s"], row[f"{name}_event_ms"] = s, ms
        scaling.append(row)

    print(json.dumps({
        "nvidia_smi": smi, "torch": torch.__version__,
        "genomes": a.genomes, "genome_bp": a.genome_bp,
        "n_rg": n_rg, "B_tot": B_tot, "longest_bins": int(bins[1].max()),
        "fold_block": device_cgi.FOLD_BLOCK, "runs": runs,
        "fixed_tsvs_byte_equal": same_fixed,
        "atomic_tsvs_byte_equal": same_atomic,
        "replay_host_s": summed,
        "replay_extra_s": summed["fixed"] - summed["atomic"],
        "scaling": scaling}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
