#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fastani_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

1. device: name, count, ``nvidia-smi`` name and power limit; build the
   six CUDA sources (one nvcc each, all at once).
2. golden: tests/test_golden_frozen.py's fixtures (seed 2024) through the
   port's CLI on the card, against tests/golden/one2one.txt and multi.txt:
   the fast path (same rows, equal counts, ANI within 0.1), then the exact
   path (``--exact --visualize --matrix``: TSV, .matrix and .visual
   byte-equal as sorted lines).  This also warms the path up before phase
   3 is timed.
3. main path: bench.py's ``mid`` workload (32 genomes x 3 Mbp,
   all-vs-all, seed 123) through the port's CLI on the card; phase times,
   genome-pairs/s, peak memory, the counters' maxima, every kernel's
   launches in this run (zeroed just before it), the map step's CUDA
   graphs (count, capture seconds, pool bytes).
   native_io: the port's native FASTA parser (built from the checkout by
   g++) on mid's 32 FASTAs and a gzipped copy of one: it ran (no Python
   parser), its names and bytes equal the Python parser's; both readers'
   seconds.
3b. redo: the golden fixtures through ``run_fast`` on the card with
   ``l2_entry_cap`` 128, under the span of every mapped fragment, so each
   query genome is redone exactly (``pipeline._redo_query_exact``); held
   against the port's CPU run of the same inputs (same rows, equal counts,
   ANI within 1e-3); its launches (zeroed just before it), the queries
   redone and the overflowed fragments, which must be > 0.
3c. exact: mid through the CLI's exact path (``--exact --matrix
   --visualize``) on the card; the same numbers as phase 3 plus the host's
   row reads, fold and .visual write; 0 fallback fragments, every kernel
   launched (counts zeroed just before it); rows and counts equal to phase
   3's, ANI within 1e-3 of it; as many .visual lines as the CGI rows'
   mapped fragments; TSV and .matrix byte-equal to phase 3's (the device
   fold sums as the host fold does).  The .visual file is deleted
   afterwards.
   graphs: mid through the fast path and the exact path again with every
   mapper eager (``graphs=False``): TSV, .matrix and .visual byte-equal
   to phases 3 and 3c (which ran the map step as CUDA graphs), every
   kernel's launches equal once the graph runs' warm-ups (each stage
   once eagerly before the capture) are taken out; no batch of phases 3
   and 3c ran eagerly (every batch, the padded tail included, replays
   the mapper's one key); per path and mode the wall, graphs, capture
   and warm-up seconds, pool bytes, peak device bytes, batches eager and
   replayed, and the host's launches, copies and reads of the card
   (``read_counter``) for one mid batch (``torch.profiler`` on batch 2,
   after batch 0 warmed up, captured and replayed and batch 1
   replayed): a replayed fast batch must read the card once, for the
   map step's ``n_live``; the finalize the fast path runs before that
   batch (profiled alone) must launch one kernel, the fused fold.
3d. sanity and oracle: ``-s`` on a pure-A query against an 8A+1T repeat
   reference writes no row; then the exact path on the golden fixtures at
   ``l2_entry_cap`` 128 with the kernels' L2 span limit patched down to
   730 entries, so the fragments past it go to the scalar oracle
   (``utils/refmodel.py``): the three files byte-equal to the CPU run's.
3e. mesh: the fast and exact jobs on a 2x2 grid on the card, one process
   running every cell.
   Mid through ``--mesh 2x2`` (2 reference shards x 2 slices of each
   batch; every kernel's launches counted from 0 just before it): rows and
   counts equal to phase 3's, ANI within 1e-3; every kernel held bit-equal
   to its plain version at each of this run's call sites, on the inputs
   the run gave it (``kernel_sites``: the first call at each of up to three
   shapes a site), and the sites' launches adding up to the run's
   (``check_sites``); the same run with the map step's CUDA graphs (the
   others above are eager): files byte-equal, launches equal less the
   warm-ups', one key a shard (6 graphs), no slice eager, each replayed
   cell batch reading the card once; its graphs, pool and peak bytes,
   and the host's launches for its first replayed cell batch;
   mid's first 16 query genomes against all 32
   through ``--mesh 2x2 --exact``: the TSV byte-equal to phase 3c's lines
   of those queries; the golden
   fixtures through ``--mesh 2x2 --exact --visualize -s --matrix``: the
   three files byte-equal to phase 2's exact run; ``--saveIndex`` then
   ``--loadIndex`` without ``--rl``, single-device and ``--mesh 2x2``, on
   both paths: the TSV byte-equal to the fresh run's; one process over
   NCCL (``--coordinator 127.0.0.1:<free port> --nprocs 1 --procid 0``, in
   a process of its own) logs backend nccl and writes phase 2's fast-path
   TSV bytes; the hits_cap auto-tune where it engages (bench.py's
   generator, seed 123, 40 genomes x 500 kbp: static cap 10240): the static
   and tuned caps and max_hits, the TSV bytes of the run with
   ``pipeline.autotune_hits_cap`` patched to return its mapper, and the
   tuned run's call sites checked as the mesh's, K1-K3 under
   ``Mapper.probe_hits`` among them.  The mesh's fast TSV and .matrix are
   byte-equal to phase 3's.  Each run prints its wall, pairs/s and peak
   device memory.
   profile: ``--profile`` through the CLI, the goldens on both paths
   (files byte-equal to phase 2's), then mid's first 8 query genomes
   against all 32 on the fast path (4 of mid's 16 batches; TSV byte-equal
   to phase 3's lines of those queries, every kernel launched, and each
   kernel's count in the trace equal to its launches in the traced window,
   replayed graphs' included): its wall, the trace's window, summed device
   kernel time, idle share and top kernels.
4. kernels: K1-K3, the fold and the L2 event build's E1 and E2
   (``csrc/events.cu``, around K4) at each of their main-path call
   sites, on the inputs the path itself gives them: ``run_fast`` on the
   first three mid genomes against all 32 (the mid index, two batches)
   with the wrappers wrapped and the map step eager, keeping each call
   site's first inputs and counting its calls; then the exact path on the
   same queries with E1's and E2's wrappers wrapped.  E1 and E2 are held
   bit-equal to their plain versions at every call site of both runs
   (``check_sites``), and timed at the first chunk of the fast run, U
   512 x T 2033 (their launches on mid are phase 3's, once a chunk as
   K4, which every path checks: ``events_at_k4``).  Each other
   site's launches on mid (index-build calls, plus calls per batch times
   phase 3's batches) must sum to phase 3's count of its kernel less its
   mapper's warm-up.  K4 sorts
   int32 words with bit 31 set at the L2 chunk's shape; K5 walks real
   event streams (the port's own index build, sketch, L1 and
   ``build_events`` on generated genomes, ``real_streams``) at U 512, the
   main path's chunk, and at U 4096.  Every kernel is held bit-equal to its
   plain PyTorch version on the card; kernel and library times from CUDA
   events around a CUDA graph of 20 calls (the host's cost of a call stays
   out), plain times from CUDA events around 1-3 calls; the bound from the
   bytes and operations this run's inputs need.  K1's operations are two
   murmur3 a k-mer start, each counted from the compiled code
   (``cuobjdump -sass`` of ``fa_winnow_murmur_probe``: every integer
   instruction one operation, a multiply-add two, as the float32 rate
   counts an FMA); its line also prints the bound by the formula of the
   row-per-block kernel it replaced (``bound_row_kernel_ms``).  The fold
   (``csrc/fold.cu``, no Pallas kernel: the JAX finalize is XLA code) is
   launched on the main path by ``finalize_rows`` (read the slots, fold,
   accumulate, clear: one launch); at its site it is timed read-only
   (``fold_rows`` on the rows the finalize folds, the table's row) and
   fused (``finalize_case``: the slots and accumulators put back before
   each call, that copy timed alone and taken out) against PR 13's
   composition of five ops around ``fold_rows``.  ``fold_rows`` also runs
   at FIN 4 against 32 genomes, the longest of 1008, 2000 and 4000 bins;
   its library call is ``torch.segment_reduce`` (sums only).  Each fold
   line prints its occupied share and longest occupied chain;
   ``fold_chain`` prints the slope of time over that chain across the
   three (a step of the chain, in microseconds and in cycles at the
   ``clocks.sm`` read under load) and each site's chain floor.
scale: the main path at the JAX package's own scale, through the CLI on
   the card with the caps ``scale_caps`` and the auto-tune give.  First
   bench.py's ``quick`` (QUICK: 8 genomes x 1 Mbp) and ``full`` (FULL:
   100 genomes x 3 Mbp), its generator, seed 123, all against all: every
   ordered pair has a TSV row, 0 fallback fragments; then the clustered 1000-genome all-vs-all of
   scripts/run_scale1000.py (SCALE1000: 20 unrelated clusters of 50
   genomes x 1 Mbp, seed 1234): every same-cluster ordered pair has a
   row, and ``scripts/torch_scale1000.py``'s run of it (per-cluster caps)
   has the same rows, equal counts, ANI within 1e-3.  Each panel's first
   SUBSET_QUERIES query genomes against all run again through the fast
   path eagerly with every wrapper wrapped and through the exact path,
   both TSVs byte-equal to the whole run's lines of those queries, and
   every kernel is held bit-equal to its plain version at each call site
   of the eager run (among them K3 at an L1 width past 16384 and K2's
   leaders at cand_cap 256 on ``full``, the unit compaction at 524288
   and the fold over 1000 reference genomes on the 1000); the new sites
   (SCALE_TIMED) get kernel lines as phase 4's.  Last, references whose
   L1 hit keys pass 32 bits (``build_draft_panel``: 2102 contigs, the
   short ones of DRAFT_CONTIG_BP bases) through the CLI on the card and
   on the CPU: ``wpos_bits`` None, int64 keys on every seqId, the same
   rows, equal counts, ANI within 1e-3.  Each run prints its
   wall, pairs/s, phase seconds, peak device bytes, graphs, batches,
   caps, the counters' maxima, fallback and redone work and every
   kernel's launches.

Phases that wrap the kernels' wrappers (``kernel_sites``) build their
mappers eager: a graph replay calls no wrapper.  Then the kernels table
(each kernel's launches on mid through the fast
path, ``launches``, through the exact path, ``launches_exact``, through
``--mesh 2x2``, ``launches_mesh``, with the largest error of its mesh
sites, ``max_abs_err_mesh``, under ``--profile``, ``launches_profile``,
and through the scale phase's whole runs, ``launches_full`` and
``launches_scale1000``), the
nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
WORK = ROOT / ".smokework"

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM bytes/s, and
# the float32 rate outside the tensor cores (an FMA counted as two), used
# for the kernels' integer ALU operations: the data sheet gives no INT32
# rate, and Hopper's INT32 lanes are half its FP32 lanes, so the true
# integer bound is higher than this one
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12

N_GENOMES = 32            # bench.py's mid workload: 32 genomes x 3 Mbp
GENOME_BP = 3_000_000
# the auto-tune engages past 34 reference genomes; 40 x 500 kbp (its
# static hits_cap, 10240, depends on the genome count only)
AUTOTUNE_BP = 500_000
# mid's query genomes mapped under --profile (8 of 32: 4 of mid's 16
# batches, against mid's whole index)
PROFILE_QUERIES = 8

REPLACES = {
    "winnow": "fastani_tpu/ops/pallas_winnow.py:249 (_winnow_row_kernel)",
    "compact": "fastani_tpu/ops/pallas_compact.py:43 (_compact_block_kernel)",
    "sort": "fastani_tpu/ops/pallas_sort.py:28 (_sort_block_kernel)",
    "sort_kv": "fastani_tpu/ops/pallas_sort.py:116 (_sort_kv_block_kernel)",
    "walk": "fastani_tpu/models/l2walk.py:298 (_walk_pallas_call)",
    # no Pallas kernel: the JAX fold is XLA code (finalize_rows)
    "fold": "fastani_tpu/models/device_cgi.py:194 (finalize_rows, XLA)",
    # no Pallas kernel: the JAX event build is XLA code (build_events)
    "events": "fastani_tpu/models/l2walk.py:104 (build_events, XLA)",
    "events_scan": "fastani_tpu/models/l2walk.py:104 (build_events, XLA)",
}
SOURCE = {
    "winnow": "fastani_tpu_torch/csrc/winnow.cu",
    "compact": "fastani_tpu_torch/csrc/compact.cu",
    "sort": "fastani_tpu_torch/csrc/sort.cu",
    "sort_kv": "fastani_tpu_torch/csrc/sort.cu",
    "walk": "fastani_tpu_torch/csrc/walk.cu",
    "fold": "fastani_tpu_torch/csrc/fold.cu",
    "events": "fastani_tpu_torch/csrc/events.cu",
    "events_scan": "fastani_tpu_torch/csrc/events.cu",
}
# kernels only the fast path's device CGI launches (the exact path folds
# on the host)
FAST_ONLY = ("fold",)
# E1 and E2 (csrc/events.cu): the L2 event build, once a chunk as K4
EVENTS = ("events", "events_scan")

# K1-K3's call sites on the main path: (kernel, calling function, rank of
# the call's line among that function's calls of the kernel) -> label
SITES = {
    ("winnow", "flush", 0): "index build rows",
    ("winnow", "sketch_fragments", 0): "sketch",
    ("compact", "flush", 0): "index build",
    ("compact", "sketch_fragments", 0): "sketch emit",
    ("compact", "sketch_fragments", 1): "first unique",
    ("compact", "l1_candidates", 0): "L1 leaders",
    ("compact", "locate_units", 0): "valid units",
    ("sort", "sketch_fragments", 0): "sketch",
    ("sort", "l1_candidates", 0): "L1 hits",
    ("sort_kv", "build_events", 0): "L2 events",
    ("events", "build_events", 0): "L2 events",
    ("events_scan", "build_events", 0): "L2 events",
    ("walk", "l2_walk_units", 0): "L2 walk",
    ("fold", "finalize_list", 0): "finalize",
}
# the site whose numbers stand for the kernel in the kernels table
TABLE_SITE = {"winnow": "sketch", "compact": "L1 leaders", "sort": "L1 hits",
              "fold": "finalize", "events": "L2 events",
              "events_scan": "L2 events"}


T0 = time.time()


def emit(obj) -> None:
    """One JSON line; a phase's line also gets the seconds since start."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.time() - T0, 1)}
    print(json.dumps(obj), flush=True)


def first_queries(wd: pathlib.Path, n: int) -> str:
    """A list file of the first n genomes of ``wd/genomes.txt``."""
    path = wd / f"first{n}.txt"
    lines = (wd / "genomes.txt").read_text().splitlines()[:n]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def tsv_of_queries(path, lst: str) -> bytes:
    """The lines of a TSV whose query is in list file ``lst``, in order:
    the TSV of a run of those queries (rows go by query genome first)."""
    qs = set(pathlib.Path(lst).read_text().split())
    return b"".join(ln for ln in pathlib.Path(path).read_bytes()
                    .splitlines(keepends=True)
                    if ln.split(b"\t")[0].decode() in qs)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int, warmup: int = 1, graph: bool = False):
    """Mean milliseconds per call from CUDA events around ``reps`` calls;
    with ``graph``, around one replay of a CUDA graph of ``reps`` calls, so
    that the host's cost of a call (tens of microseconds of Python around
    a launch) does not show in the time of a short kernel."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    run, n = fn, reps
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="thread_local"):
            for _ in range(reps):
                fn()
        g.replay()
        run, n = g.replay, 1
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        run()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def max_abs_err(torch, xs, ys) -> float:
    """The largest difference of two outputs' integers; float32 outputs
    are compared as their bits (0: the same floats, bit for bit)."""
    err = 0.0
    for x, y in zip(xs, ys):
        if x.shape != y.shape:
            raise AssertionError(f"shape {tuple(x.shape)} != {tuple(y.shape)}")
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        d = (x.to(torch.int64) - y.to(torch.int64)).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def murmur_sass_ops(kc) -> dict:
    """The instructions of one murmur3 (k = 16) in the compiled K1 source:
    the SASS of ``fa_winnow_murmur_probe`` between its last load and its
    store.  Returns the counts and ``ops`` (a multiply-add counted as two
    operations, any other instruction as one)."""
    cuobjdump = pathlib.Path(kc.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(cuobjdump), "-sass", "-fun", "fa_winnow_murmur_probe",
         str(kc._lib_path(kc.SOURCES["winnow"]))], capture_output=True,
        text=True, check=True).stdout
    ops = []
    for ln in sass.splitlines():
        text = ln.split("*/", 1)[1].split(";")[0].split() \
            if ln.strip().startswith("/*") and "*/" in ln else []
        if text and text[0].startswith("@"):          # a predicate
            text = text[1:]
        if text and text[0][:1].isalpha():
            ops.append(text[0])
    last_ld = max(i for i, o in enumerate(ops) if o.startswith("LDG"))
    first_st = min(i for i, o in enumerate(ops) if o.startswith("STG"))
    body = ops[last_ld + 1:first_st]
    # IMAD.MOV, IMAD.SHL and IMAD.IADD are a move, a shift and an add
    n_mad = sum(o.startswith("IMAD") and not o.startswith(
        ("IMAD.MOV", "IMAD.SHL", "IMAD.IADD")) for o in body)
    return {"instructions": len(body), "multiply_adds": n_mad,
            "ops": len(body) + n_mad}


def bound(nbytes: float, nops: float):
    tb, to = nbytes / PEAK_BYTES * 1e3, nops / PEAK_OPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# generated genomes
# ---------------------------------------------------------------------------

def genome_bytes(np, rng, n: int):
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]


# the generators of tests/synth.py (copied: a `tests` package elsewhere on
# the path may shadow the repository's)

def mutate_genome(np, rng, seq, sub_rate=0.02, indel_rate=0.0005,
                  indel_max=12):
    """Point mutations + small indels, like diverged strains."""
    seq = seq.copy()
    n_sub = int(len(seq) * sub_rate)
    if n_sub:
        pos = rng.choice(len(seq), size=n_sub, replace=False)
        seq[pos] = genome_bytes(np, rng, n_sub)
    if indel_rate > 0:
        parts = []
        cur = 0
        n_ind = int(len(seq) * indel_rate)
        cuts = np.sort(rng.choice(len(seq), size=n_ind, replace=False))
        for c in cuts:
            parts.append(seq[cur:c])
            if rng.random() < 0.5:
                parts.append(genome_bytes(np, rng,
                                          int(rng.integers(1, indel_max))))
                cur = c
            else:
                cur = min(len(seq), c + int(rng.integers(1, indel_max)))
        parts.append(seq[cur:])
        seq = np.concatenate(parts)
    return seq


def write_fasta(path, contigs, line_width: int = 70) -> None:
    with open(path, "wb") as f:
        for name, seq in contigs:
            f.write(b">" + name.encode() + b"\n")
            b = seq.tobytes()
            for i in range(0, len(b), line_width):
                f.write(b[i: i + line_width] + b"\n")


# ---------------------------------------------------------------------------
# phase 4: kernels against their plain versions at the main path's inputs
# ---------------------------------------------------------------------------

# integer operations of E1 per entry besides its two binary searches (the
# in-contig test and selects, the clamps, the record and two key packs;
# each search step a compare and a select), and of E2 per event (the
# ballots and popcount prefixes, eff, dn, dq, the look-ahead and scored
# tests, the last leave's shuffle, six stores)
EVENTS_OPS_PER_ENTRY = 24
EVENTS_SCAN_OPS_PER_EVENT = 30

# integer operations per event of K5's O(1) design (csrc/walk.cu: the rank
# select and clamps, the packed-word update and forward, P, cnt, the move
# test and the score), against 24 bytes read per event
WALK_OPS_PER_EVENT = 30


def real_streams(torch, np, dev, sizes=(512, 4096), genome_bp=GENOME_BP):
    """Real L2 event streams at the main path's widths: four references (a
    3 Mbp genome mutated 1-4 %, one also holding a repeat-rich contig: a
    60 kbp block three times around 40 near-identical tandem copies of a
    700 bp unit), an index built on ``dev`` by the port, 2048 query
    fragments (two diverged strains and the repeat region) through
    ``jitmap.locate_units`` and ``l2walk.build_events``.  Returns
    {U: (ev, s_u, n_ev)} for the first U units of the batch, and scap."""
    from fastani_tpu_torch.config import Parameters, scale_caps
    from fastani_tpu_torch.index.sketch import ReferenceIndex
    from fastani_tpu_torch.models import jitmap, l2walk

    wd = WORK / "streams"
    wd.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(11)
    base = genome_bytes(np, rng, genome_bp)
    unit = genome_bytes(np, rng, 700)
    tandem = np.concatenate([mutate_genome(np, rng, unit, 0.01, 0.0)
                             for _ in range(40)])
    block = genome_bytes(np, rng, 60_000)
    rep = np.concatenate([block, genome_bytes(np, rng, 5000), block, tandem,
                          block])
    files = []
    for i in range(4):
        contigs = [(f"r{i}", mutate_genome(np, rng, base, 0.01 * (i + 1),
                                           0.0002))]
        if i == 0:
            contigs.append(("rep", rep))
        write_fasta(wd / f"r{i}.fa", contigs)
        files.append(str(wd / f"r{i}.fa"))
    p = Parameters(ref_sequences=files).finalize()
    scale_caps(32, p)                        # the caps of the mid run
    B, L = p.frag_batch, p.frag_len
    mapper = jitmap.Mapper(p, ReferenceIndex.build_device(p, device=dev),
                           unit_factor=int(1.7 * 32) + 8)
    # the repeat region's fragments first, so the first chunk holds them
    n_rep = 48
    qrep = mutate_genome(np, rng, rep[60_000:], 0.01, 0.0)
    strains = [mutate_genome(np, rng, base, 0.02, 0.0003) for _ in range(2)]
    frags = np.concatenate(
        [qrep[: n_rep * L].reshape(n_rep, L)]
        + [g[: (len(g) // L) * L].reshape(-1, L) for g in strains])[:B]
    cfg, t = mapper.cfg, mapper.tables
    u = jitmap.locate_units(cfg, torch.as_tensor(frags, device=dev), t)
    out = {}
    for U in sizes:
        if u["n_live"] < U:
            raise AssertionError(f"{u['n_live']} valid units, {U} wanted")
        ev, s_u, _, n_ev = l2walk.build_events(
            *jitmap.l2_chunk_args(cfg, t, u, slice(0, U)))
        out[U] = (ev, s_u, n_ev)
    shutil.rmtree(wd, ignore_errors=True)
    return out, cfg.sketch_cap


def kv_inputs(torch, dev):
    """K4's inputs at the L2 event merge of the mid run (unit_chunk, 2 *
    l2_entry_cap + 1), int32 words: keys below 2^31 with the clamped pads
    tied, payload records over all 32 bits (bit 31 set in about half)."""
    from fastani_tpu_torch.config import Parameters, scale_caps

    p = Parameters().finalize()
    scale_caps(N_GENOMES, p)
    shape = (min(512, p.frag_batch), 2 * p.l2_entry_cap + 1)
    keys = torch.randint(0, 2 ** 30, shape, dtype=torch.int32, device=dev)
    keys[:, 1500:] = (1 << 28) << 2                # clamped pads, tied
    pay = torch.randint(-2 ** 31, 2 ** 31 - 1, shape, dtype=torch.int32,
                        device=dev)
    return keys, pay


def wrapper_fns() -> dict:
    """kernel -> (module, name) of the wrapper that launches it."""
    from fastani_tpu_torch.models import device_cgi, l2walk
    from fastani_tpu_torch.ops import compact, sort, winnow

    return {"winnow": (winnow, "winnow_rows"),
            "compact": (compact, "compact_rows"),
            "sort": (sort, "sort_rows_u32"),
            "sort_kv": (sort, "sort_rows_u32_kv"),
            "walk": (l2walk, "walk"),
            "fold": (device_cgi, "finalize_rows"),
            "events": (l2walk, "events"),
            "events_scan": (l2walk, "events_scan")}


@contextlib.contextmanager
def eager_mappers():
    """Every ``Mapper`` built inside runs its map step eagerly
    (``graphs=False``): a graph replay calls no wrapper, and a capture
    forbids the host copies of ``kernel_sites``."""
    from fastani_tpu_torch.models import jitmap

    init = jitmap.Mapper.__init__

    def eager_init(self, *args, **kw):
        init(self, *args, **{**kw, "graphs": False})

    jitmap.Mapper.__init__ = eager_init
    try:
        yield
    finally:
        jitmap.Mapper.__init__ = init


def map_tensors(torch, fn, x):
    """``x`` with ``fn`` applied to every tensor in it (lists, tuples and
    dicts walked)."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, (list, tuple)):
        return type(x)(map_tensors(torch, fn, v) for v in x)
    if isinstance(x, dict):
        return {k: map_tensors(torch, fn, v) for k, v in x.items()}
    return x


def tensors_of(torch, x) -> list:
    """The tensors in ``x`` in order (lists, tuples and dicts walked; a
    dict's by its sorted keys)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = [x[k] for k in sorted(x)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in tensors_of(torch, v)]
    return []


def shape_key(torch, x):
    """The shapes of the tensors in ``x`` (other values as they are), as
    nested tuples: hashable, and JSON prints them as lists."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape)
    if isinstance(x, (list, tuple)):
        return tuple(shape_key(torch, v) for v in x)
    if isinstance(x, dict):
        return tuple((k, shape_key(torch, v)) for k, v in sorted(x.items()))
    return x


@contextlib.contextmanager
def kernel_sites(torch, kernels, shapes_per_site: int = 1):
    """While the body runs, the wrappers of ``kernels`` are wrapped; yields
    the dict they fill: (kernel, calling function, line, under
    ``Mapper.probe_hits``) -> {"calls", "launches": the kernel launches
    the site's calls made, "inputs": [(args, kw)] of the site's first call
    at each of its first ``shapes_per_site`` input shapes}.  The inputs are
    copied to the host (a few synchronising copies: the device's peak
    memory is the run's own); mappers built inside run eagerly
    (``eager_mappers``)."""
    from fastani_tpu_torch.ops import cuda as kc

    fns = wrapper_fns()
    seen = {}
    origs = []

    def wrap(kernel, mod, name):
        orig = getattr(mod, name)

        def rec(*args, **kw):
            f = sys._getframe(1)
            g, probe = f, False
            while g is not None and not probe:
                probe, g = g.f_code.co_name == "probe_hits", g.f_back
            v = seen.setdefault((kernel, f.f_code.co_name, f.f_lineno, probe),
                                {"calls": 0, "launches": 0, "inputs": [],
                                 "shapes": set()})
            v["calls"] += 1
            shape = shape_key(torch, (args, kw))
            if shape not in v["shapes"] and len(v["shapes"]) < shapes_per_site:
                v["shapes"].add(shape)
                v["inputs"].append(map_tensors(
                    torch, lambda x: x.to("cpu", copy=True), (args, kw)))
            before = kc.LAUNCHES[kernel]
            out = orig(*args, **kw)
            v["launches"] += kc.LAUNCHES[kernel] - before
            return out

        origs.append((mod, name, orig))
        setattr(mod, name, rec)

    for kernel in kernels:
        wrap(kernel, *fns[kernel])
    try:
        with eager_mappers():
            yield seen
    finally:
        for mod, name, orig in origs:
            setattr(mod, name, orig)


def site_labels(seen: dict) -> dict:
    """``kernel_sites``'s dict keyed by (kernel, label): the label from
    SITES by the rank of the call's line among its function's calls of the
    kernel, "probe " in front under ``Mapper.probe_hits``; each value also
    holds its calling function (``fn``)."""
    lines = {}
    for kernel, fn, ln, _ in seen:
        lines.setdefault((kernel, fn), set()).add(ln)
    sites = {}
    for (kernel, fn, ln, probe), v in seen.items():
        rank = sorted(lines[(kernel, fn)]).index(ln)
        label = SITES.get((kernel, fn, rank), f"{fn}:{ln}")
        sites[(kernel, ("probe " if probe else "") + label)] = {**v, "fn": fn}
    return sites


def capture_sites(torch, paths):
    """The inputs K1-K3, the fold, E1 and E2 get on the main path:
    ``run_fast`` on the first three of ``paths`` against all of them, with
    each kernel's wrapper wrapped, then the exact path (``pipeline.run``)
    on the same queries with E1's and E2's wrapped.  Returns ({(kernel,
    site): {"args", "kw", "calls", "per_batch"}}, batches, {path:
    (``kernel_sites``' dict, launches)} of E1 and E2 in the fast and the
    exact run): each call site's first inputs (on the card) and its calls
    (the index build's, or over all batches; the fold closes query genomes
    once a batch after the first, and at the end; E1 and E2 once a chunk,
    as many a batch as its live units fill)."""
    from fastani_tpu_torch.config import Parameters
    from fastani_tpu_torch.models import pipeline
    from fastani_tpu_torch.ops import cuda as kc

    stats = {}
    params = lambda: Parameters(ref_sequences=paths, query_sequences=paths[:3])
    kc.reset_launches()
    with kernel_sites(torch, ("winnow", "compact", "sort", "fold")
                      + EVENTS) as seen:
        pipeline.run_fast(params(), device="cuda", log=lambda m: None,
                          stats=stats)
    events = {"fast": ({k: v for k, v in seen.items() if k[0] in EVENTS},
                       {k: kc.LAUNCHES[k] for k in EVENTS})}
    kc.reset_launches()
    with kernel_sites(torch, EVENTS) as seen_exact:
        pipeline.run(params(), device="cuda", log=lambda m: None)
    events["exact"] = (seen_exact, {k: kc.LAUNCHES[k] for k in EVENTS})
    sites = {}
    for key, v in site_labels(seen).items():
        (args, kw), = map_tensors(torch, lambda x: x.to("cuda"), v["inputs"])
        sites[key] = {"args": args, "kw": kw, "calls": v["calls"],
                      "per_batch": v["fn"] != "flush"}
    return sites, stats["batches"], events


def check_sites(torch, path: str, seen: dict, launches: dict) -> dict:
    """Phase 4's check on the call sites of another path's run
    (``kernel_sites``'s dict): each site's inputs, at each shape kept,
    through the kernel and through its plain version on the card, bit-equal
    (max abs err 0); the sites' launches add up to each kernel's
    ``launches`` in that run (counted from 0 just before it).  Prints one
    line a site and shape; returns {kernel: {"sites", "max_abs_err"}}."""
    fns = wrapper_fns()
    total, out = {}, {}
    for (kernel, label), v in sorted(site_labels(seen).items()):
        total[kernel] = total.get(kernel, 0) + v["launches"]
        mod, name = fns[kernel]
        for inputs in v["inputs"]:
            # a copy on the card for each version: the fold's finalize
            # writes its inputs
            fresh = lambda: map_tensors(torch, lambda x: x.to("cuda"), inputs)
            args, kw = fresh()
            if kernel == "compact":
                width = kw.get("width", args[2] if len(args) > 2
                               else args[0].shape[1])
                plain = mod.compact_rows_plain(args[0], args[1], width)
            else:
                plain = getattr(mod, name + "_plain")(*args, **kw)
            args, kw = fresh()
            got = getattr(mod, name)(*args, **kw)
            err = max_abs_err(torch, tensors_of(torch, got),
                              tensors_of(torch, plain))
            emit({"phase": "kernel_site", "path": path, "name": kernel,
                  "site": label, "shape": shape_key(torch, args),
                  "calls": v["calls"], "launches": v["launches"],
                  "max_abs_err": err})
            if err != 0:
                raise AssertionError(f"{path}: {kernel} at {label} differs "
                                     f"from its plain version (max abs err "
                                     f"{err})")
            row = out.setdefault(kernel, {"sites": [], "max_abs_err": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], err)
        out.setdefault(kernel, {"sites": [], "max_abs_err": 0.0})[
            "sites"].append(label)
    want = {k: n for k, n in launches.items() if n}
    if {k: n for k, n in total.items() if n} != want:
        raise AssertionError(f"{path}: call sites add up to {total} "
                             f"launches, the run made {launches}")
    return out


def fold_inputs(torch, np, dev) -> dict:
    """The fold's synthetic sites: {longest: (rows, ranges)} at FIN 4
    against 32 reference genomes, the last stretched to 1008, 2000 and
    4000 bins (about 3, 6 and 12 Mbp), 60% of the bins occupied."""
    from fastani_tpu_torch.models import device_cgi

    rng = np.random.default_rng(7)
    out = {}
    for longest in (1008, 2000, 4000):
        n_bins = [1008] * 31 + [longest]
        B_tot = sum(n_bins)
        ident = rng.uniform(76.0, 100.0, (4, B_tot)).astype(np.float32)
        rows = np.where(rng.uniform(size=(4, B_tot)) < 0.6,
                        ident.view(np.int32), -1).astype(np.int32)
        out[longest] = (torch.as_tensor(rows, device=dev),
                        torch.as_tensor(device_cgi.genome_bins(
                            np.repeat(np.arange(32), n_bins), 32),
                            device=dev))
    return out


def finalize_case(torch, args, kw):
    """The fold's finalize at one call site (``finalize_rows``' args and
    kw), repeatable: ``run(form)`` puts the table's slot rows and the
    accumulators back as the site had them, then finalizes by ``form``:
    "fused" (``finalize_rows``: one launch), "composition" (PR 13's
    ``finalize_rows``: the slots, the gather, ``fold_rows``, two
    ``index_add_``, ``index_fill_``) or "restore" (nothing more: its time
    is taken out of the others'); returns [tab, counts, sums].  Returns
    (run, ``finalize_rows_plain``'s [tab, counts, sums] on a copy)."""
    from fastani_tpu_torch.models import device_cgi

    tab0, acc_c0, acc_s0, fin, ranges, n_slots = args
    rows = kw.get("rows")
    slots = fin % n_slots
    saved = tab0[slots]
    tab, acc_c, acc_s = tab0.clone(), acc_c0.clone(), acc_s0.clone()
    want = list(device_cgi.finalize_rows_plain(
        tab0.clone(), acc_c0.clone(), acc_s0.clone(), fin, ranges, n_slots,
        rows=rows))

    def composition():
        sl = fin % n_slots
        counts, sums = device_cgi.fold_rows(tab[sl] if rows is None else rows,
                                            ranges)
        acc_c.index_add_(0, fin, counts)
        acc_s.index_add_(0, fin, sums)
        tab.index_fill_(0, sl, -1)

    forms = {"fused": lambda: device_cgi.finalize_rows(
                 tab, acc_c, acc_s, fin, ranges, n_slots, rows=rows),
             "composition": composition, "restore": lambda: None}

    def run(form):
        tab.index_copy_(0, slots, saved)
        acc_c.copy_(acc_c0)
        acc_s.copy_(acc_s0)
        forms[form]()
        return [tab, acc_c, acc_s]

    return run, want


def sm_clock_mhz(torch, fn, seconds: float = 1.0) -> float:
    """nvidia-smi's ``clocks.sm`` (MHz), read while the card replays CUDA
    graphs of 200 calls of ``fn`` for about ``seconds``."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        for _ in range(200):
            fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    for _ in range(max(1, int(seconds * 1e3 / a.elapsed_time(b)))):
        g.replay()
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]
    torch.cuda.synchronize()
    return float(clock)


def fold_chain(torch, np, synth: list, mid: dict) -> dict:
    """The cost of one step of the fold's chain: the slope of the kernel's
    time over the longest occupied chain (a genome's occupied bins) across
    the synthetic sites, in microseconds and in cycles at the SM clock
    read under the last site's load; and each site's chain floor, its
    longest chain times that cost."""
    x = [r["longest_chain"] for r in synth]
    slope_ms = float(np.polyfit(x, [r["kernel_ms"] for r in synth], 1)[0])
    clock = sm_clock_mhz(torch, synth[-1]["run"])
    floor = lambda r: r["longest_chain"] * slope_ms
    row = {"phase": "fold_chain", "longest_chain": x,
           "kernel_ms": [r["kernel_ms"] for r in synth],
           "step_us": slope_ms * 1e3, "clocks_sm_mhz": clock,
           "step_cycles": slope_ms * 1e-3 * clock * 1e6,
           "chain_floor_ms": {r["site"]: floor(r) for r in [mid] + synth}}
    emit(row)
    return row


def kernel_recorders(torch, results: dict):
    """Phase 4's ``record`` and ``record_fold``: each holds a kernel's
    outputs to its plain version's (max abs err 0), times the kernel (a
    CUDA graph of ``reps`` calls), its plain version and its library call,
    computes the bound from the bytes and operations the inputs need,
    emits the kernel line and keeps it in ``results`` under (name,
    site)."""
    from fastani_tpu_torch.models import device_cgi

    def record(name, site, shape, outs_k, outs_p, fn_k, fn_p, nbytes, nops,
               fn_lib=None, reps=20, plain_reps=3, lib_graph=True, **extra):
        err = max_abs_err(torch, outs_k, outs_p)
        if err != 0:
            raise AssertionError(f"{name} at {site} {shape}: kernel differs "
                                 f"from its plain version (max abs err "
                                 f"{err})")
        ms = time_ms(torch, fn_k, reps, graph=True)
        plain_ms = time_ms(torch, fn_p, plain_reps, warmup=0)
        lib_ms = (time_ms(torch, fn_lib, reps, graph=lib_graph)
                  if fn_lib else None)
        b_ms, b_by = bound(nbytes, nops)
        row = dict(name=name, site=site, shape=shape, max_abs_err=err,
                   kernel_ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, library_ms=lib_ms, **extra)
        emit({"phase": "kernel", **row})
        results[(name, site)] = row

    def record_fold(site, rows, ranges, **extra):
        """The fold on (FIN, B_tot) rows: bytes, the rows and the genomes'
        (first bin, bin count) int32 read once and both (FIN, Gr) outputs
        written once; two operations a bin (the occupancy test and the
        add).  Library: one ``torch.segment_reduce`` of the masked
        identities over each genome's bins (sums only, in its own order;
        it reads lengths on the host, so it is timed outside a graph)."""
        FIN, B_tot = rows.shape
        Gr = ranges.shape[1]
        occ = rows >= 0
        masked = torch.where(occ, rows.view(torch.float32), 0.0)
        lengths = ranges[1].long().expand(FIN, Gr).contiguous()
        run_k = lambda: device_cgi.fold_rows(rows, ranges)
        run_p = lambda: device_cgi.fold_rows_plain(rows, ranges)
        want = list(run_p())
        record("fold", site, [FIN, B_tot, Gr], list(run_k()), want,
               run_k, run_p,
               nbytes=4 * FIN * B_tot + 8 * Gr + 8 * FIN * Gr,
               nops=2 * FIN * B_tot,
               fn_lib=lambda: torch.segment_reduce(masked, "sum",
                                                   lengths=lengths, axis=1),
               lib_graph=False, plain_reps=1,
               longest_bins=int(lengths.max()),
               occupied_share=float(occ.float().mean()),
               longest_chain=int(want[0].max()) if want[0].numel() else 0,
               **extra)
        return {**results[("fold", site)], "run": run_k}

    return record, record_fold


def kv_compares(R: int, n: int) -> int:
    """The compare-exchanges of a bitonic network over R rows of n keys
    padded to a power of two."""
    N = 1 << (n - 1).bit_length()
    lg = N.bit_length() - 1
    return R * (N // 2) * lg * (lg + 1) // 2


def time_site(torch, record, record_fold, kernel, site, a, kw, murmur,
              **extra):
    """The kernel line of one call site (``record``) on the inputs the
    path gave it (``a``, ``kw``), with its bytes and operations; ``extra``
    goes into the line (the site's launches).  The fold's site also gets
    its fused finalize line (``finalize_case``)."""
    from fastani_tpu_torch.models import device_cgi, l2walk
    from fastani_tpu_torch.ops import compact, sort, winnow
    from fastani_tpu_torch.ops.xputils import UMAX

    dev = torch.device("cuda")
    if kernel == "winnow":
        rows, ctg, base, tl, k, w = a
        R, W = rows.shape
        seg = W - (w - 1) - (k - 1)
        run_k = lambda: winnow.winnow_rows(rows, ctg, base, tl, k, w)
        run_p = lambda: winnow.winnow_rows_plain(rows, ctg, base, tl, k,
                                                 w)
        # the row-per-block kernel's formula: int64 hashes out (9
        # bytes a position); per position two murmur3 (~72 32-bit ops
        # each), packing two k-byte keys (4k), the w-long window scan
        old_ms, old_by = bound(
            rows.numel() + 12 * R + 9 * R * seg,
            R * (W - k + 1) * (2 * 72 + 4 * k) + R * seg * 2 * w)
        record("winnow", site, [R, W], list(run_k()), list(run_p()),
               run_k, run_p,
               # the rows and (ctg, base, len) read, 1-byte emits and
               # 4-byte hashes written; two murmur3 a k-mer start
               nbytes=rows.numel() + 12 * R + 5 * R * seg,
               nops=R * (W - k + 1) * 2 * murmur["ops"],
               plain_reps=1, **extra,
               bound_row_kernel_ms=old_ms, bound_row_kernel_by=old_by,
               murmur_sass=murmur,
               tiles=list(winnow.tile_geometry(seg)))
    elif kernel == "fold":
        # the main path's finalize: the read-only fold on the rows it
        # folds (the table's row), then the fused form
        tab, _, _, fin, ranges, n_slots = a
        rows = kw.get("rows")
        rows = tab[fin % n_slots] if rows is None else rows
        fold_k = record_fold(site, rows, ranges, **extra)
        run_fin, want = finalize_case(torch, a, kw)
        err = max(max_abs_err(torch, run_fin(form), want)
                  for form in ("fused", "composition"))
        if err != 0:
            raise AssertionError(f"fold at {site}: the fused finalize or "
                                 f"the composition differs from "
                                 f"finalize_rows_plain (max abs err "
                                 f"{err})")
        ms = {form: time_ms(torch, lambda f=form: run_fin(f), 20,
                            graph=True)
              for form in ("restore", "fused", "composition")}
        FIN, B_tot = rows.shape
        Gr = ranges.shape[1]
        # the rows read and cleared once, the accumulators' FIN x Gr
        # elements read and written once, the ranges and qnos read
        b_ms, b_by = bound(8 * FIN * B_tot + 16 * FIN * Gr + 8 * Gr
                           + 8 * FIN, 2 * FIN * B_tot)
        emit({"phase": "kernel", "name": "fold",
              "site": f"{site} fused", "shape": [FIN, B_tot, Gr],
              "n_slots": n_slots, "rows_given": kw.get("rows") is not None,
              "max_abs_err": err, "restore_ms": ms["restore"],
              "fused_ms": ms["fused"] - ms["restore"],
              "composition_ms": ms["composition"] - ms["restore"],
              "fused_with_restore_ms": ms["fused"],
              "composition_with_restore_ms": ms["composition"],
              "fold_rows_ms": fold_k["kernel_ms"], "bound_ms": b_ms,
              "bound_by": b_by, **extra})
    elif kernel == "events":
        qh, frag, u_sid, b0, mi_hash = a[0], a[2], a[3], a[5], a[7]
        ncap = a[13]
        U, scap, M = u_sid.shape[0], qh.shape[1], mi_hash.shape[0]
        T = 2 * ncap + 1
        # the distinct entries of the units' windows and sketch rows,
        # each read once; the (U, T) keys and records and five
        # per-unit words written once
        b0c = b0.clamp(0, M - ncap)
        entries = int(torch.unique(
            b0c[:, None] + torch.arange(ncap, device=dev)).numel())
        n_rows = int(torch.unique(frag).numel())
        run_k = lambda: l2walk.events(*a, **kw)
        run_p = lambda: l2walk.events_plain(*a, **kw)
        record("events", site, [U, T, scap],
               tensors_of(torch, run_k()), tensors_of(torch, run_p()),
               run_k, run_p,
               nbytes=(entries * sum(x.element_size() for x in a[7:12])
                       + n_rows * (scap + 1) * 8 + U * 29
                       + 8 * U * T + 17 * U),
               nops=U * ncap * (4 * (scap + 1).bit_length()
                                + EVENTS_OPS_PER_ENTRY),
               **extra, distinct_entries=entries,
               sketch_rows=n_rows)
    elif kernel == "events_scan":
        keys = a[0]
        U, T = keys.shape
        run_k = lambda: l2walk.events_scan(*a, **kw)
        run_p = lambda: l2walk.events_scan_plain(*a, **kw)
        got_k = tensors_of(torch, run_k())
        # the sorted keys and records read once, 13 bytes a unit; the
        # six (U, T) rows and n_ev written once
        record("events_scan", site, [U, T], got_k,
               tensors_of(torch, run_p()), run_k, run_p,
               nbytes=8 * U * T + 13 * U + 24 * U * T + 4 * U,
               nops=U * T * EVENTS_SCAN_OPS_PER_EVENT,
               **extra,
               n_ev_mean=float(got_k[-1].float().mean()))
    elif kernel == "compact":
        flags, pays = a[0], a[1]
        width = kw.get("width", a[2] if len(a) > 2 else flags.shape[1])
        R, n = flags.shape
        # the flag bytes, one word per payload at each flagged position
        # below the width, the (R, width) outputs written once
        moved = int(flags.sum(dim=1).clamp(max=width).sum())
        run_k = lambda: compact.compact_rows(flags, pays, width)
        run_p = lambda: compact.compact_rows_plain(flags, pays, width)
        record("compact", site, [R, n, len(pays)], list(run_k()),
               list(run_p()), run_k, run_p,
               nbytes=R * n + sum(x.element_size() * (moved + R * width)
                                  for x, _ in pays),
               nops=R * n, width=width,
               words=[str(x.dtype).replace("torch.", "") for x, _ in pays],
               flag_share=float(flags.float().mean()),
               **extra)
    elif kernel == "sort_kv":
        keys, pay = a
        R, n = keys.shape
        run_k = lambda: sort.sort_rows_u32_kv(keys, pay)
        run_p = lambda: sort.sort_rows_u32_kv_plain(keys, pay)
        # 8-byte composites read and written once; two operations a
        # compare of the bitonic network
        record("sort_kv", site, [R, n], list(run_k()), list(run_p()), run_k,
               run_p, nbytes=R * n * 16, nops=kv_compares(R, n) * 2,
               fn_lib=lambda: torch.sort(keys, dim=-1, stable=True), **extra)
    elif kernel == "walk":
        ev, s_u, n_ev, scap = a
        U = s_u.shape[0]
        n_sum = float(n_ev.sum())
        run_k = lambda: l2walk.walk(ev, s_u, n_ev, scap)
        run_p = lambda: l2walk.walk_plain(ev, s_u, n_ev, scap)
        record("walk", site, [U, ev["dn"].shape[1], scap], list(run_k()),
               list(run_p()), run_k, run_p, nbytes=n_sum * 24 + U * 20,
               nops=n_sum * WALK_OPS_PER_EVENT, plain_reps=1,
               n_ev_mean=n_sum / U, n_ev_max=int(n_ev.max()), **extra)
    else:
        x = a[0]
        R, n = x.shape
        # torch.sort over the same int32 words where every key is below
        # 2^31 (UMAX pads, -1, sort first there: the time is the
        # yardstick), else over u32 values in int64 words
        lib_words = "int64"
        xl = x if x.dtype == torch.int64 else (x.to(torch.int64) & UMAX)
        if x.dtype == torch.int32 and bool(((x >= 0) | (x == -1)).all()):
            xl, lib_words = x, "int32"
        pad = -1 if x.dtype == torch.int32 else UMAX
        run_k = lambda: sort.sort_rows_u32(x)
        run_p = lambda: sort.sort_rows_u32_plain(x)
        # 4-byte keys read once and written once; one operation a key
        # (no design-free count of a sort's operations)
        record("sort", site, [R, n], [run_k()], [run_p()], run_k, run_p,
               nbytes=R * n * 8, nops=R * n,
               fn_lib=lambda: torch.sort(xl, dim=-1),
               words=str(x.dtype).replace("torch.", ""),
               library_words=lib_words,
               real_share=float((x != pad).float().mean()),
               **extra)


def check_kernels(torch, np, mid_paths, mid_batches, mid_launches):
    from fastani_tpu_torch.config import Parameters, scale_caps
    from fastani_tpu_torch.ops import cuda as kc

    dev = torch.device("cuda")
    p = Parameters().finalize()
    scale_caps(N_GENOMES, p)
    B, scap = p.frag_batch, p.sketch_cap
    U = min(512, B)                               # L2 chunk of units
    results = {}

    record, record_fold = kernel_recorders(torch, results)

    # K1-K3, the fold, E1 and E2 on the inputs of their call sites;
    # launches on mid per site (E1's and E2's: mid's own, once a chunk)
    sites, cap_batches, event_runs = capture_sites(torch, mid_paths)
    for path, (seen, run_launches) in event_runs.items():
        check_sites(torch, path, seen, run_launches)
    per_kernel = {}
    launches = {}
    for (kernel, site), v in sites.items():
        n = v["calls"]
        if kernel in EVENTS:
            n = mid_launches[kernel]
        elif v["per_batch"]:
            if n % cap_batches:
                raise AssertionError(f"{kernel} at {site}: {n} calls in "
                                     f"{cap_batches} batches")
            n = n // cap_batches * mid_batches
        launches[(kernel, site)] = n
        per_kernel[kernel] = per_kernel.get(kernel, 0) + n
    for kernel, n in per_kernel.items():
        if n != mid_launches[kernel]:
            raise AssertionError(f"{kernel}: call sites add up to {n} "
                                 f"launches, mid made {mid_launches[kernel]}")

    murmur = murmur_sass_ops(kc)
    for (kernel, site), v in sorted(sites.items()):
        time_site(torch, record, record_fold, kernel, site, v["args"],
                  v["kw"], murmur, launches_mid=launches[(kernel, site)])
    del sites

    # K4 key-value sort at the L2 event merge's shape
    time_site(torch, record, record_fold, "sort_kv", "L2 events",
              kv_inputs(torch, dev), {}, murmur)

    # K5 walk: real event streams at the main path's chunk (U 512, scap
    # 320) and at U 4096; bound from the bytes these streams need read once
    # and the design's operations per event
    streams, s_cap = real_streams(torch, np, dev)
    if s_cap != scap:
        raise AssertionError(f"stream scap {s_cap} != {scap}")
    for Uw, (ev, s_u, n_ev) in streams.items():
        time_site(torch, record, record_fold, "walk", f"U {Uw}",
                  (ev, s_u, n_ev, scap), {}, murmur)
    # the fold at FIN 4 against 32 reference genomes, the last stretched
    # to 1008, 2000 and 4000 bins; the cost of a step of the chain
    synth = [record_fold(f"{longest} bins", rows, ranges)
             for longest, (rows, ranges) in fold_inputs(torch, np,
                                                        dev).items()]
    fold_chain(torch, np, synth, results[("fold", TABLE_SITE["fold"])])
    return {**{k: results[(k, s)] for k, s in TABLE_SITE.items()},
            "sort_kv": results[("sort_kv", "L2 events")],
            "walk": results[("walk", f"U {U}")]}


# ---------------------------------------------------------------------------
# phase 2: frozen goldens
# ---------------------------------------------------------------------------

def run_golden(np):
    """Returns the fixtures' directory (kept for the redo phase)."""
    from fastani_tpu_torch import cli

    wd = WORK / "golden"
    wd.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(2024)
    base = genome_bytes(np, rng, 150_000)
    strain_a = mutate_genome(np, rng, base, sub_rate=0.02, indel_rate=0.0003)
    strain_b = mutate_genome(np, rng, base, sub_rate=0.05, indel_rate=0.0005)
    multi = [
        ("m_ctg1", mutate_genome(np, rng, base[:80_000], 0.01)),
        ("m_short", genome_bytes(np, rng, 800)),
        ("m_ctg2", mutate_genome(np, rng, base[80_000:], 0.03)),
    ]
    write_fasta(wd / "base.fa", [("base_ctg", base)])
    write_fasta(wd / "strainA.fa", [("sA_ctg", strain_a)])
    write_fasta(wd / "strainB.fa", [("sB_ctg", strain_b)])
    write_fasta(wd / "multi.fa", multi)
    (wd / "refs.txt").write_text("strainA.fa\nstrainB.fa\n")
    cwd = os.getcwd()
    os.chdir(wd)
    try:
        for args, golden in (
                (["-q", "base.fa", "-r", "strainA.fa", "-o", "g1.txt"],
                 "one2one.txt"),
                (["-q", "multi.fa", "--rl", "refs.txt", "-o", "g2.txt"],
                 "multi.txt")):
            if cli.main(args + ["--device", "cuda"]) != 0:
                raise AssertionError(f"CLI failed: {args}")
            ours = [ln.split("\t") for ln in open(args[-1]).read().split("\n")
                    if ln]
            want = [ln.split("\t") for ln in
                    (ROOT / "tests" / "golden" / golden).read_text().split("\n")
                    if ln]
            if sorted(r[:2] for r in ours) != sorted(r[:2] for r in want):
                raise AssertionError(f"{golden}: rows differ: {ours} vs {want}")
            by = {tuple(r[:2]): r for r in want}
            dev_max = 0.0
            for r in ours:
                g = by[tuple(r[:2])]
                if r[3:] != g[3:]:
                    raise AssertionError(f"{golden}: counts differ {r} vs {g}")
                dev_max = max(dev_max, abs(float(r[2]) - float(g[2])))
            if dev_max > 0.1:
                raise AssertionError(f"{golden}: ANI off by {dev_max}")
            emit({"phase": "golden", "golden": golden, "rows": len(ours),
                  "max_ani_diff": dev_max})
            out = "x_" + args[-1]
            if cli.main(args[:-1] + [out, "--exact", "--visualize",
                                     "--matrix", "--device", "cuda"]) != 0:
                raise AssertionError(f"exact CLI failed: {args}")
            lines = {}
            for suf in ("", ".matrix", ".visual"):
                ours = sorted(open(out + suf).read().splitlines())
                want = sorted((ROOT / "tests" / "golden" / (golden + suf))
                              .read_text().splitlines())
                if ours != want:
                    raise AssertionError(f"exact {golden}{suf} differs from "
                                         f"the golden")
                lines[suf or ".tsv"] = len(ours)
            emit({"phase": "golden_exact", "golden": golden,
                  "byte_equal_lines": lines})
    finally:
        os.chdir(cwd)
    return wd


# ---------------------------------------------------------------------------
# phase 3b: the exact redo of cap-overflowed query genomes
# ---------------------------------------------------------------------------

def run_redo(torch, wd: pathlib.Path):
    """The golden fixtures through ``run_fast`` on the card at
    ``l2_entry_cap`` 128 (a clean mapping spans ~480 index entries, so
    every mapped fragment overflows L2 and both query genomes are redone),
    against the port's run of the same inputs on the CPU."""
    from fastani_tpu_torch.config import Parameters
    from fastani_tpu_torch.models import pipeline
    from fastani_tpu_torch.ops import cuda as kc

    def run(device):
        stats = {}
        p = Parameters(query_sequences=[str(wd / "multi.fa"),
                                        str(wd / "base.fa")],
                       ref_sequences=[str(wd / "strainA.fa"),
                                      str(wd / "strainB.fa")],
                       l2_entry_cap=128)
        t0 = time.time()
        rows = pipeline.run_fast(p, device=device, log=lambda m: None,
                                 stats=stats)
        if device == "cuda":
            torch.cuda.synchronize()
        return {(e.qry_genome, e.ref_genome): e for e in rows}, stats, \
            time.time() - t0

    torch.cuda.synchronize()
    kc.reset_launches()
    got, st, t_card = run("cuda")
    launches = dict(kc.LAUNCHES)
    want, st_cpu, t_cpu = run("cpu")
    dev_max = max((abs(float(got[k].identity) - float(e.identity))
                   for k, e in want.items() if k in got), default=0.0)
    emit({"phase": "redo", "l2_entry_cap": 128,
          "queries_redone": st["redone_queries"],
          "fallback_frags": st["fallback_frags"],
          "fallback_frags_cpu": st_cpu["fallback_frags"],
          "rows": len(got), "max_ani_diff_vs_cpu": dev_max,
          "launches": launches, "t_card_s": t_card, "t_cpu_s": t_cpu})
    if not st["fallback_frags"] or st["redone_queries"] != 2:
        raise AssertionError("redo: no query genome was redone")
    if set(got) != set(want) or len(got) != 4:
        raise AssertionError(f"redo: rows {sorted(got)} vs {sorted(want)}")
    for k, e in want.items():
        if (got[k].count_seq, got[k].total_query_fragments) != \
                (e.count_seq, e.total_query_fragments):
            raise AssertionError(f"redo: counts differ at {k}")
    if dev_max > 1e-3:
        raise AssertionError(f"redo: ANI off the CPU run's by {dev_max}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"redo: kernels not launched: {missing}")


# ---------------------------------------------------------------------------
# phase 3c: the exact path at a real size
# ---------------------------------------------------------------------------

def tsv_rows(path) -> dict:
    return {tuple(ln.split("\t")[:2]): ln.split("\t")[2:]
            for ln in pathlib.Path(path).read_text().split("\n") if ln}


def run_exact_mid(torch, n_genomes: int):
    """Phase 3's genomes and list through the CLI's exact path; returns
    the kernels' launches in this run and its numbers."""
    from fastani_tpu_torch import cli
    from fastani_tpu_torch.utils import spans
    from fastani_tpu_torch.ops import cuda as kc

    wd = WORK / "mid"
    genomes, out = wd / "genomes.txt", wd / "mid_exact.txt"
    stats = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kc.reset_launches()
    t0 = time.time()
    rc = cli.main(["--ql", str(genomes), "--rl", str(genomes), "-o",
                   str(out), "--exact", "--matrix", "--visualize",
                   "--device", "cuda"], stats=stats)
    torch.cuda.synchronize()
    wall = time.time() - t0
    if rc != 0:
        raise AssertionError(f"exact CLI exited with {rc}")
    launches = dict(kc.LAUNCHES)
    got, want = tsv_rows(out), tsv_rows(wd / "mid.txt")
    visual = pathlib.Path(f"{out}.visual")
    with open(visual, "rb") as f:
        n_visual = sum(1 for _ in f)
    visual_bytes = visual.stat().st_size
    visual_sha = file_sha256(visual)
    visual.unlink()
    n_pairs = n_genomes * n_genomes
    dev_max = max((abs(float(got[k][0]) - float(want[k][0]))
                   for k in want if k in got), default=0.0)
    mapped = sum(int(r[1]) for r in got.values())
    # the device fold sums as the host fold does, so the fast path's TSV
    # and .matrix are the exact path's bytes
    same_fast = [(wd / ("mid.txt" + suf)).read_bytes()
                 == pathlib.Path(f"{out}{suf}").read_bytes()
                 for suf in ("", ".matrix")]
    emit({"phase": "exact", "genomes": n_genomes, "pairs": n_pairs,
          "wall_s": wall, "pairs_per_s": n_pairs / wall,
          "t_index_build_s": stats["t_index_build"],
          "t_mapper_init_s": stats["t_mapper_init"],
          "t_map_s": stats["t_map"], "t_rows_s": spans.seconds("batch.collect", stats),
          "t_fold_s": stats["t_fold"], "t_visual_s": stats["t_visual"],
          "t_write_s": stats["t_write"],
          "map_fold_s": stats["t_map"] + stats["t_fold"],
          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          **graph_numbers(stats),
          "batches": stats["batches"],
          "fallback_frags": stats["fallback_frags"],
          "oracle_frags": stats["oracle_frags"], "launches": launches,
          "tsv_rows": len(got), "max_ani_diff_vs_fast": dev_max,
          "byte_equal_fast": same_fast,
          "visual_lines": n_visual, "visual_bytes": visual_bytes,
          "visual_sha256": visual_sha, "mapped_fragments": mapped})
    missing = [k for k, v in launches.items()
               if v <= 0 and k not in FAST_ONLY]
    if missing:
        raise AssertionError(f"exact: kernels not launched: {missing}")
    events_at_k4("exact", launches)
    if stats["fallback_frags"]:
        raise AssertionError(f"exact: {stats['fallback_frags']} fragments "
                             f"fell back")
    if set(got) != set(want) or len(got) != n_pairs:
        raise AssertionError(f"exact: {len(got)} rows, fast path "
                             f"{len(want)}")
    for k, r in want.items():
        if got[k][1:] != r[1:]:
            raise AssertionError(f"exact: counts differ at {k}: {got[k]} "
                                 f"vs {r}")
    if dev_max > 1e-3 or not all(same_fast):
        raise AssertionError(f"exact: TSV and .matrix not the fast path's "
                             f"bytes ({same_fast}; ANI off by {dev_max})")
    # every CGI row is in the TSV (all pairs pass), and each of its mapped
    # fragments is one .visual line
    if n_visual != mapped:
        raise AssertionError(f"exact: {n_visual} .visual lines for "
                             f"{mapped} mapped fragments")
    return launches, {"wall_s": wall, **graph_numbers(stats),
                            "t_map_s": stats["t_map"],
                            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                            "batches": stats["batches"],
                            "visual_sha256": visual_sha}


# ---------------------------------------------------------------------------
# phase graphs: the map step as CUDA graphs against the eager step
# ---------------------------------------------------------------------------

def file_sha256(path) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 22), b""):
            h.update(block)
    return h.hexdigest()


def graph_numbers(stats: dict) -> dict:
    """A path's graphs and batches (``Mapper.graph_stats`` in its
    stats)."""
    return {"graphs": stats["graphs"], "t_capture_s": stats["t_capture"],
            "t_warmup_s": stats["t_warmup"],
            "graph_pool_bytes": stats["graph_pool_bytes"],
            "eager_batches": stats["eager_batches"],
            "replays": stats["replays"],
            "warmup_launches": stats["warmup_launches"]}


def less_warmup(launches: dict, stats: dict) -> dict:
    """A run's kernel launches less those of its mappers' warm-ups (each
    stage once eagerly before a capture): what the batches themselves
    launched, as an eager run of the same batches launches them."""
    warm = stats["warmup_launches"]
    return {k: n - warm.get(k, 0) for k, n in launches.items()}


def no_eager_batches(what: str, stats: dict) -> None:
    """With graphs on, every batch replays the mapper's one key."""
    if stats["eager_batches"] or not stats["replays"] or not stats["graphs"]:
        raise AssertionError(f"{what}: {stats['eager_batches']} batches ran "
                             f"eagerly with graphs on, {stats['replays']} "
                             f"replayed, {stats['graphs']} graphs")


def events_at_k4(what: str, launches: dict) -> None:
    """E1 and E2 run once a chunk each, as K4 does."""
    if not launches["events"] == launches["events_scan"] == \
            launches["sort_kv"] > 0:
        raise AssertionError(f"{what}: E1, E2 and K4 launched "
                             f"{launches['events']}, "
                             f"{launches['events_scan']}, "
                             f"{launches['sort_kv']} times")


# the tensor methods that read a tensor's values to the host
READS = ("tolist", "item", "__int__", "__bool__", "__float__", "__index__",
         "cpu", "numpy")


def read_counter(torch):
    """A ``TorchFunctionMode`` that counts, by name, the calls that read
    a tensor on the card to the host while it is active: READS on a card
    tensor, and ``copy_`` from the card into a host tensor."""
    from torch.overrides import TorchFunctionMode

    class Reads(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.counts = {}

        def __torch_function__(self, func, types, args=(), kwargs=None):
            name = getattr(func, "__name__", "")
            on_card = [getattr(a, "is_cuda", None) for a in args[:2]]
            if (name in READS and on_card[:1] == [True]) or \
                    (name == "copy_" and on_card == [False, True]):
                self.counts[name] = self.counts.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    return Reads()


def host_calls(torch, fn) -> dict:
    """The host's launch calls (CUDA API calls whose name holds
    ``Launch``: kernels, graphs) and memory copies while ``fn`` runs, by
    name, from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    calls = {}
    # the raw events: key_averages would build a Python event tree first
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if any(w in name for w in ("Launch", "Memcpy", "Memset")):
            calls[name] = calls.get(name, 0) + 1
    return calls


def batch_host_calls(torch, paths) -> dict:
    """The host's launches and reads for one mid batch on each path, with
    graphs and eagerly: the index, a mapper as ``run_fast`` makes it,
    batches 0 and 1 (with graphs: the mapper's warm-up, capture and first
    replay, then a replay), then batch 2 under the profiler and a read
    counter (``read_counter``) through ``pipeline.map_batch_cgi`` (fast:
    dispatch, CGI update, counts and mask into the device stacks) and
    ``Mapper.dispatch(to_host=True)`` + ``pipeline.batch_rows`` (exact:
    the rows read); on the fast path also, under the profiler alone, the
    finalize the stream runs before batch 2
    (``StreamingCGI.finalize_list`` of the query genomes
    ``cgi_stream_schedule`` closes there: ``finalize_launches``).
    ``seconds`` splits the function's own wall."""
    from fastani_tpu_torch.config import Parameters, scale_caps
    from fastani_tpu_torch.models import device_cgi, jitmap, pipeline

    t0 = time.time()
    seconds = {}
    p = Parameters(query_sequences=paths, ref_sequences=paths).finalize()
    index = pipeline.reference_index(p, torch.device("cuda"), {},
                                     lambda m: None)
    scale_caps(len(paths), p)
    stream = pipeline.FragmentStream(paths, p)
    B = p.frag_batch
    batches = [stream.make_batch(b0, B) for b0 in (0, B, 2 * B)]
    closed = pipeline.cgi_stream_schedule(stream, B, len(paths))[1][2]
    out = {"seconds": seconds}
    seconds["index_and_batches"] = time.time() - t0
    for mode in ("graphs", "eager"):
        t0 = time.time()
        with (eager_mappers() if mode == "eager" else
              contextlib.nullcontext()):
            mapper = jitmap.job_mapper(p, index, len(paths), B)
        cgi = device_cgi.StreamingCGI(index, p, len(paths), len(paths),
                                      n_slots=4, frag_cap=B)
        counts = torch.zeros((3, len(jitmap.COUNT_NAMES)), dtype=torch.int64,
                             device="cuda")
        masks = torch.zeros((3, B), dtype=torch.bool, device="cuda")
        st = {}
        fast = lambda i: pipeline.map_batch_cgi(*batches[i], mapper, cgi,
                                                counts[i], masks[i])
        exact = lambda i: pipeline.batch_rows(
            mapper, mapper.dispatch(*batches[i], to_host=True),
            *batches[i][:3], mapper, p, st)
        fast(0)
        fast(1)
        torch.cuda.synchronize()
        seconds[f"mapper_and_batches01_{mode}"] = time.time() - t0
        for path, fn in (("fast", fast), ("exact", exact)):
            t0 = time.time()
            reads = read_counter(torch)

            def batch():
                with reads:
                    fn(2)

            calls = host_calls(torch, batch)
            seconds[f"profiled_{path}_{mode}"] = time.time() - t0
            out[(path, mode)] = {
                "launches": sum(n for k, n in calls.items() if "Launch" in k),
                "copies": sum(n for k, n in calls.items()
                              if "Launch" not in k), "calls": calls,
                "d2h_reads": sum(reads.counts.values()),
                "d2h_reads_by_call": reads.counts}
            if path == "fast":
                fin = host_calls(torch, lambda: cgi.finalize_list(closed))
                out[(path, mode)].update(
                    finalize_fin=len(closed), finalize_calls=fin,
                    finalize_launches=sum(n for k, n in fin.items()
                                          if "Launch" in k))
        out[("batches", mode)] = mapper.graph_stats()
        del mapper, cgi
    return out


def run_graphs(torch, n_genomes: int, graph_rows: dict) -> None:
    """Mid through the CLI's fast path and exact path (``--exact --matrix
    --visualize``) with every mapper eager, against phases 3 and 3c, which
    ran the same with the map step's CUDA graphs: TSV, .matrix and .visual
    byte-equal, the kernels' launches equal once the warm-up's are taken
    out (``less_warmup``), no batch eager with graphs on; each path's
    walls, graphs, capture and warm-up seconds, pool bytes, peak device
    bytes, batches eager and replayed, and the host launches and reads of
    the card for one batch (``batch_host_calls``) in both modes.  A
    replayed fast batch must read the card once, the map step's
    ``n_live``."""
    from fastani_tpu_torch.ops import cuda as kc

    wd = WORK / "mid"
    lst = str(wd / "genomes.txt")
    paths = (wd / "genomes.txt").read_text().split()
    n_pairs = n_genomes * n_genomes
    per_batch = batch_host_calls(torch, paths)
    emit({"phase": "graphs_host_calls", "seconds": per_batch.pop("seconds")})
    for path, extra, ref, sufs in (
            ("fast", ["--matrix"], "mid.txt", ("", ".matrix")),
            ("exact", ["--exact", "--matrix", "--visualize"], "mid_exact.txt",
             ("", ".matrix"))):
        out = wd / f"eager_{path}.txt"
        stats = {}
        kc.reset_launches()
        with eager_mappers():
            wall = timed_cli(torch, ["--ql", lst, "--rl", lst, "-o", str(out)]
                             + extra, stats)
        eager = {"wall_s": wall,
                 # the map loop: map + fold on the fast path, map on the
                 # exact path
                 "t_map_s": stats["t_map_fold" if path == "fast" else "t_map"],
                 **graph_numbers(stats),
                 "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                 "launches": dict(kc.LAUNCHES)}
        graph = dict(graph_rows[path])
        same = [(wd / (ref + suf)).read_bytes()
                == pathlib.Path(f"{out}{suf}").read_bytes() for suf in sufs]
        if path == "exact":
            visual = pathlib.Path(f"{out}.visual")
            same.append(file_sha256(visual) == graph.pop("visual_sha256"))
            visual.unlink()
        for mode, row in (("graphs", graph), ("eager", eager)):
            calls = per_batch[(path, mode)]
            row.update(host_launches_per_batch=calls["launches"],
                       host_copies_per_batch=calls["copies"],
                       host_calls_per_batch=calls["calls"],
                       d2h_reads_per_batch=calls["d2h_reads"],
                       d2h_reads_by_call=calls["d2h_reads_by_call"],
                       batch_probe=per_batch[("batches", mode)])
            if path == "fast":
                row.update(host_launches_finalize=calls["finalize_launches"],
                           host_calls_finalize=calls["finalize_calls"],
                           finalize_fin=calls["finalize_fin"])
                # the fused finalize: one kernel, no other launch
                if calls["finalize_launches"] != 1 or \
                        not calls["finalize_fin"]:
                    raise AssertionError(
                        f"graphs fast: the finalize of "
                        f"{calls['finalize_fin']} query genomes made "
                        f"{calls['finalize_calls']}")
        equal = less_warmup(graph["launches"], graph) == eager["launches"]
        emit({"phase": "graphs", "path": path, "pairs": n_pairs,
              "graphs": graph, "eager": eager, "byte_equal": same,
              "launches_equal_less_warmup": equal})
        if not all(same):
            raise AssertionError(f"graphs {path}: files differ from the "
                                 f"eager run's: {same}")
        if not equal:
            raise AssertionError(f"graphs {path}: launches {graph['launches']}"
                                 f" (warm-up {graph['warmup_launches']}) "
                                 f"against eager {eager['launches']}")
        no_eager_batches(f"graphs {path}", graph)
        no_eager_batches(f"graphs {path}, one batch",
                         per_batch[("batches", "graphs")])
        if graph["graphs"] != 3 or eager["graphs"] or \
                eager["eager_batches"] != graph["batches"]:
            raise AssertionError(f"graphs {path}: {graph['graphs']} graphs "
                                 f"captured, eager {eager['graphs']}, "
                                 f"{eager['eager_batches']} eager batches")
        reads = graph["d2h_reads_by_call"]
        if path == "fast" and reads != {"__int__": 1}:
            raise AssertionError(f"graphs fast: a replayed batch read the "
                                 f"card {reads}, not once for n_live")


# ---------------------------------------------------------------------------
# phase 3d: the sanity check and the scalar oracle's route
# ---------------------------------------------------------------------------

def run_sanity_and_oracle(torch, np, wd: pathlib.Path):
    from fastani_tpu_torch import cli
    from fastani_tpu_torch.config import Parameters
    from fastani_tpu_torch.models import glue, pipeline
    from fastani_tpu_torch.ops import cuda as kc

    def rpt(unit):
        return np.frombuffer((unit * (300_000 // len(unit) + 1))[:300_000],
                             np.uint8).copy()

    write_fasta(wd / "rpt_q.fa", [("q", rpt(b"A" * 32))])
    write_fasta(wd / "rpt_r.fa", [("r", rpt(b"A" * 8 + b"T"))])
    stats = {}
    rc = cli.main(["-q", str(wd / "rpt_q.fa"), "-r", str(wd / "rpt_r.fa"),
                   "-o", str(wd / "rpt.txt"), "-s", "--matrix",
                   "--device", "cuda"], stats=stats)
    rows = (wd / "rpt.txt").read_text()
    emit({"phase": "sanity", "rc": rc, "tsv_bytes": len(rows),
          "mapped": "batches" in stats})
    if rc != 0 or rows or "batches" in stats:
        raise AssertionError("sanity: the repeat pair was mapped")

    counter, step, limit, holder = glue._CAPS["l2_entry_cap"]
    glue._CAPS["l2_entry_cap"] = (counter, step, 730, holder)

    def run(device):
        stats = {}
        out = str(wd / f"oracle_{device}.txt")
        pipeline.run(Parameters(
            query_sequences=[str(wd / "multi.fa"), str(wd / "base.fa")],
            ref_sequences=[str(wd / "strainA.fa"), str(wd / "strainB.fa")],
            l2_entry_cap=128, visualize=True, matrix_output=True,
            out_file_name=out), device=device, log=lambda m: None,
            stats=stats)
        return [open(out + suf, "rb").read()
                for suf in ("", ".matrix", ".visual")], stats

    try:
        torch.cuda.synchronize()
        kc.reset_launches()
        t0 = time.time()
        got, st = run("cuda")
        torch.cuda.synchronize()
        t_card = time.time() - t0
        launches = dict(kc.LAUNCHES)
        t0 = time.time()
        want, st_cpu = run("cpu")
        t_cpu = time.time() - t0
    finally:
        glue._CAPS["l2_entry_cap"] = (counter, step, limit, holder)
    emit({"phase": "oracle", "l2_entry_cap": 128, "l2_limit": 730,
          "fallback_frags": st["fallback_frags"],
          "oracle_frags": st["oracle_frags"],
          "oracle_frags_cpu": st_cpu["oracle_frags"],
          "byte_equal": got == want, "visual_lines": got[2].count(b"\n"),
          "launches": launches, "t_card_s": t_card, "t_cpu_s": t_cpu})
    if not st["oracle_frags"] or st["oracle_frags"] != st_cpu["oracle_frags"]:
        raise AssertionError("oracle: no fragment reached the oracle, or not "
                             "the CPU run's")
    if got != want:
        raise AssertionError("oracle: card and CPU outputs differ")


# ---------------------------------------------------------------------------
# phase 3e: the 2x2 grid, index persistence, the hits_cap auto-tune
# ---------------------------------------------------------------------------

def timed_cli(torch, args, stats=None) -> float:
    """The port's CLI on the card; its wall in seconds (synchronised)."""
    from fastani_tpu_torch import cli

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    rc = cli.main(args + ["--device", "cuda"], stats=stats)
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"CLI exited with {rc}: {args}")
    return time.time() - t0


def run_metrics(torch, wall: float, n_pairs: int) -> dict:
    return {"wall_s": wall, "pairs_per_s": n_pairs / wall,
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def same_rows(got: dict, want: dict, what: str, tol: float = 1e-3) -> float:
    """Equal rows and counts, ANI within ``tol``; returns the largest ANI
    difference."""
    if set(got) != set(want):
        raise AssertionError(f"{what}: rows differ ({len(got)} vs "
                             f"{len(want)})")
    dev_max = 0.0
    for k, r in want.items():
        if got[k][1:] != r[1:]:
            raise AssertionError(f"{what}: counts differ at {k}")
        dev_max = max(dev_max, abs(float(got[k][0]) - float(r[0])))
    if dev_max > tol:
        raise AssertionError(f"{what}: ANI off by {dev_max}")
    return dev_max


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_mesh(torch, np, n_genomes: int, golden: pathlib.Path):
    """Phase 3e; returns the kernels' launches on mid through ``--mesh
    2x2`` (the fast path), counted from 0 just before that run, and
    ``check_sites``'s result on that run's call sites."""
    from fastani_tpu_torch.models import pipeline
    from fastani_tpu_torch.ops import cuda as kc

    wd = WORK / "mid"
    lst = str(wd / "genomes.txt")
    n_pairs = n_genomes * n_genomes
    mid = ["--ql", lst, "--rl", lst, "--matrix", "--mesh", "2x2"]

    # mid, fast path, 2 reference shards x 2 batch slices on one card
    stats = {}
    kc.reset_launches()
    with kernel_sites(torch, kc.KERNELS, shapes_per_site=3) as seen:
        wall = timed_cli(torch, mid + ["-o", str(wd / "mesh.txt")], stats)
    launches = dict(kc.LAUNCHES)
    dev = same_rows(tsv_rows(wd / "mesh.txt"), tsv_rows(wd / "mid.txt"),
                    "mesh fast")
    # each genome's sum is a fold over its own bins in bin order, so a
    # shard's sums are the single run's bits
    same = [(wd / ("mesh.txt" + suf)).read_bytes()
            == (wd / ("mid.txt" + suf)).read_bytes()
            for suf in ("", ".matrix")]
    emit({"phase": "mesh_fast", "mesh": "2x2", "pairs": n_pairs,
          **run_metrics(torch, wall, n_pairs),
          "t_index_build_s": stats["t_index_build"],
          "t_map_fold_s": stats["t_map_fold"], "batches": stats["batches"],
          "fallback_frags": stats["fallback_frags"],
          "max_hits": stats["max_hits"], "launches": launches,
          "max_ani_diff_vs_single": dev, "byte_equal_single": same})
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"mesh: kernels not launched: {missing}")
    events_at_k4("mesh", launches)
    if not all(same):
        raise AssertionError(f"mesh fast: files differ from phase 3's: {same}")
    # every kernel at the mesh's own call sites and shapes (B_local rows,
    # the shards' caps and index builds) against its plain version
    mesh_sites = check_sites(torch, "mesh 2x2", seen, launches)
    del seen
    # the same run with the map step's graphs, one key a shard, which the
    # shard's cells share: files byte-equal to the eager run's, launches
    # equal less the warm-ups', no slice eager, and each replayed cell
    # batch reads the card once (its n_live; a read counter runs inside
    # each cell's pipeline.map_batch_cgi); the first replayed cell batch
    # runs under the profiler for its host launches
    stats = {}
    kc.reset_launches()
    out = wd / "mesh_graphs.txt"
    cell_reads, cell_calls = [], {}
    map_cell = pipeline.map_batch_cgi

    def counted(*args):
        replayed = args[4].replays > 0          # its mapper has captured
        reads = read_counter(torch)

        def cell():
            with reads:
                map_cell(*args)

        if replayed and not cell_calls:
            cell_calls.update(host_calls(torch, cell))
        else:
            cell()
        if replayed:
            cell_reads.append(reads.counts)

    pipeline.map_batch_cgi = counted
    try:
        wall = timed_cli(torch, mid + ["-o", str(out)], stats)
    finally:
        pipeline.map_batch_cgi = map_cell
    same = [(wd / ("mesh.txt" + suf)).read_bytes()
            == pathlib.Path(f"{out}{suf}").read_bytes()
            for suf in ("", ".matrix")]
    equal = less_warmup(dict(kc.LAUNCHES), stats) == launches
    reads_ok = bool(cell_reads) and all(c == {"__int__": 1}
                                        for c in cell_reads)
    emit({"phase": "mesh_fast_graphs", "mesh": "2x2", "pairs": n_pairs,
          **run_metrics(torch, wall, n_pairs), **graph_numbers(stats),
          "t_map_fold_s": stats["t_map_fold"], "batches": stats["batches"],
          "launches": dict(kc.LAUNCHES), "byte_equal_eager": same,
          "launches_equal_less_warmup": equal,
          "replayed_cell_batches": len(cell_reads),
          "d2h_reads_per_cell_batch": (sum(sum(c.values())
                                           for c in cell_reads)
                                       / max(len(cell_reads), 1)),
          "host_launches_per_cell_batch": sum(
              n for k, n in cell_calls.items() if "Launch" in k),
          "host_copies_per_cell_batch": sum(
              n for k, n in cell_calls.items() if "Launch" not in k),
          "host_calls_per_cell_batch": cell_calls})
    if not all(same) or not equal or not reads_ok:
        raise AssertionError(f"mesh fast with graphs: files equal to the "
                             f"eager run's {same}, launches {kc.LAUNCHES} "
                             f"(warm-up {stats['warmup_launches']}) against "
                             f"{launches}, replayed cells' reads "
                             f"{cell_reads[:4]}")
    no_eager_batches("mesh fast with graphs", stats)
    if stats["graphs"] != 6:
        raise AssertionError(f"mesh fast with graphs: {stats['graphs']} "
                             f"graphs, not one key a shard")

    # mid's first 16 query genomes, exact path: the TSV is phase 3c's
    # lines of those queries, byte for byte (the goldens below hold the
    # mesh's .matrix and .visual)
    stats = {}
    out = wd / "mesh_exact.txt"
    half = first_queries(wd, n_genomes // 2)
    wall = timed_cli(torch, ["--ql", half, "--rl", lst, "--mesh", "2x2",
                             "-o", str(out), "--exact"], stats)
    same = out.read_bytes() == tsv_of_queries(wd / "mid_exact.txt", half)
    emit({"phase": "mesh_exact", "mesh": "2x2", "queries": n_genomes // 2,
          **run_metrics(torch, wall, n_pairs // 2), "t_map_s": stats["t_map"],
          "t_fold_s": stats["t_fold"], "fallback_frags":
          stats["fallback_frags"], **graph_numbers(stats),
          "byte_equal_tsv": same})
    if not same:
        raise AssertionError("mesh exact: TSV differs from phase 3c's")
    no_eager_batches("mesh exact", stats)

    cwd = os.getcwd()
    os.chdir(golden)
    try:
        # the goldens, every exact output, byte-equal to phase 2's
        q2 = ["-q", "multi.fa", "--rl", "refs.txt"]
        wall = timed_cli(torch, q2 + ["-o", "mx_g2.txt", "--mesh", "2x2",
                                      "--exact", "--visualize", "-s",
                                      "--matrix"])
        same = [pathlib.Path("x_g2.txt" + suf).read_bytes()
                == pathlib.Path("mx_g2.txt" + suf).read_bytes()
                for suf in ("", ".matrix", ".visual")]
        emit({"phase": "mesh_golden_exact", "mesh": "2x2",
              **run_metrics(torch, wall, 2), "byte_equal": same})
        if not all(same):
            raise AssertionError("mesh golden exact: files differ")

        # --saveIndex, then --loadIndex without --rl: the fresh run's TSV
        # bytes, on both paths
        persist = {}
        for tag, extra, idx in (("single", [], "ix.npz"),
                                ("mesh", ["--mesh", "2x2"], "ixm")):
            for path in ("fast", "exact"):
                flag = ["--exact"] if path == "exact" else []
                fresh, loaded = f"s_{tag}_{path}.txt", f"l_{tag}_{path}.txt"
                wall_s = timed_cli(torch, q2 + extra + flag + [
                    "-o", fresh, "--saveIndex", idx])
                wall_l = timed_cli(torch, ["-q", "multi.fa", "--loadIndex",
                                           idx, "-o", loaded] + extra + flag)
                same = pathlib.Path(fresh).read_bytes() == \
                    pathlib.Path(loaded).read_bytes()
                persist[f"{tag}_{path}"] = {
                    "save_wall_s": wall_s, "load_wall_s": wall_l,
                    "load_pairs_per_s": 2 / wall_l,
                    "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                    "byte_equal": same,
                    "max_ani_diff": same_rows(tsv_rows(loaded),
                                              tsv_rows(fresh),
                                              f"--loadIndex {tag} {path}")}
                if not same:
                    raise AssertionError(f"--loadIndex {tag} {path}: the "
                                         f"TSV differs from the fresh run")
        emit({"phase": "mesh_persist", **persist})

        # one process over NCCL (a process of its own: the group is
        # created and destroyed there) against the single-device fast path
        t0 = time.time()
        res = subprocess.run(
            [sys.executable, "-m", "fastani_tpu_torch.cli"] + q2
            + ["-o", "nccl.txt", "--coordinator",
               f"127.0.0.1:{free_port()}", "--nprocs", "1", "--procid", "0",
               "--device", "cuda"],
            capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=str(ROOT)))
        wall = time.time() - t0
        backend = [ln for ln in res.stderr.splitlines() if "backend" in ln]
        if res.returncode != 0:
            raise AssertionError(f"NCCL run failed: {res.stderr[-2000:]}")
        emit({"phase": "mesh_nccl", "rc": res.returncode,
              "wall_s": wall, "pairs_per_s": 2 / wall,
              "peak_mem_bytes": "not measured (another process)",
              "log": backend,
              "byte_equal_single": pathlib.Path("nccl.txt").read_bytes()
              == pathlib.Path("g2.txt").read_bytes(),
              "max_ani_diff_vs_single": same_rows(
                  tsv_rows("nccl.txt"), tsv_rows("g2.txt"), "NCCL run")})
        if not backend or "backend nccl" not in backend[0]:
            raise AssertionError(f"NCCL run: wrong backend: {backend}")
        if pathlib.Path("nccl.txt").read_bytes() != \
                pathlib.Path("g2.txt").read_bytes():
            raise AssertionError("NCCL run: TSV differs from phase 2's")
    finally:
        os.chdir(cwd)

    # the auto-tune where it engages: 40 genomes (static hits_cap 10240)
    aw = WORK / "autotune"
    aw.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    paths = build_workload(np, aw, 40, AUTOTUNE_BP)
    (aw / "g.txt").write_text("\n".join(paths) + "\n")
    gen_s = time.time() - t0
    args = ["--ql", str(aw / "g.txt"), "--rl", str(aw / "g.txt")]
    tuned, static = {}, {}
    kc.reset_launches()
    with kernel_sites(torch, kc.KERNELS, shapes_per_site=3) as seen:
        wall_t = timed_cli(torch, args + ["-o", str(aw / "tuned.txt")],
                           tuned)
    metrics_t = run_metrics(torch, wall_t, 1600)
    # K1-K3 under Mapper.probe_hits, and every kernel at the tuned width
    tune_sites = check_sites(torch, "autotune", seen, dict(kc.LAUNCHES))
    del seen
    probed = {k for k, v in tune_sites.items()
              if any(s.startswith("probe ") for s in v["sites"])}
    if probed != {"winnow", "compact", "sort"}:
        raise AssertionError(f"autotune: probe_hits launched {probed}")
    orig = pipeline.autotune_hits_cap
    pipeline.autotune_hits_cap = lambda mapper, stream, params: mapper
    try:
        wall_s = timed_cli(torch, args + ["-o", str(aw / "static.txt")],
                           static)
    finally:
        pipeline.autotune_hits_cap = orig
    same = (aw / "tuned.txt").read_bytes() == (aw / "static.txt").read_bytes()
    ani_diff = same_rows(tsv_rows(aw / "tuned.txt"),
                         tsv_rows(aw / "static.txt"), "autotune")
    emit({"phase": "autotune", "genomes": 40, "genome_bp": AUTOTUNE_BP,
          "gen_s": gen_s, "hits_cap_static": tuned["hits_cap_static"],
          "hits_cap_tuned": tuned["hits_cap"], "max_hits": tuned["max_hits"],
          "fallback_frags": tuned["fallback_frags"],
          "tuned": {**metrics_t, "t_map_fold_s": tuned["t_map_fold"]},
          "static": {**run_metrics(torch, wall_s, 1600),
                     "t_map_fold_s": static["t_map_fold"],
                     "hits_cap": static["hits_cap"]},
          "byte_equal": same, "max_ani_diff_vs_static": ani_diff})
    shutil.rmtree(aw, ignore_errors=True)
    if not tuned["hits_cap"] < tuned["hits_cap_static"] == 10240:
        raise AssertionError("autotune: hits_cap did not shrink below 10240")
    if not same:
        raise AssertionError("autotune: tuned and static TSVs differ")
    return launches, mesh_sites


# ---------------------------------------------------------------------------
# phases native_io and profile
# ---------------------------------------------------------------------------

def run_native_io(paths) -> None:
    """The native parser (built from the checkout by ``native.load``) on
    mid's FASTAs and a gzipped copy of the first: names and bytes equal to
    the Python parser's; each reader's seconds."""
    import gzip

    from fastani_tpu_torch import native
    from fastani_tpu_torch.io import fasta

    if os.environ.get("FASTANI_TPU_NO_NATIVE"):
        raise AssertionError("native_io: FASTANI_TPU_NO_NATIVE is set")
    gz = WORK / "mid" / "g0.fa.gz"
    gz.write_bytes(gzip.compress(pathlib.Path(paths[0]).read_bytes()))
    files = list(paths) + [str(gz)]
    parses, parse = [], native.parse
    native.parse = lambda data: (parses.append(len(data)), parse(data))[1]
    try:
        t0 = time.time()
        nat = [list(fasta.read_sequences(p)) for p in files]
        t_native = time.time() - t0
    finally:
        native.parse = parse
    t0 = time.time()
    py = [list(fasta.read_sequences_py(p)) for p in files]
    t_python = time.time() - t0
    same = all([n for n, _ in a] == [n for n, _ in b]
               and all(x.tobytes() == y.tobytes()
                       for (_, x), (_, y) in zip(a, b))
               for a, b in zip(nat, py))
    emit({"phase": "native_io", "library": str(native.lib_path()),
          "files": len(paths), "gz_files": 1, "native_parses": len(parses),
          "bytes_read": sum(parses),
          "seq_bytes": int(sum(len(x) for a in nat for _, x in a)),
          "native_s": t_native, "python_s": t_python,
          "byte_equal": same})
    gz.unlink()
    if len(parses) != len(files) or not native.lib_path().exists():
        raise AssertionError("native_io: the native parser did not run")
    if not same:
        raise AssertionError("native_io: the parsers' records differ")


# the CUDA function names of each kernel, as the profiler's trace shows
# them
KERNEL_FUNCS = {
    "winnow": ("winnow_tile_kernel",),
    "compact": ("compact_chunks_kernel",),
    "sort": ("sort_rows_net_kernel", "sort_rows_radix_kernel"),
    "sort_kv": ("sort_rows_kv_kernel",),
    "walk": ("walk_kernel",),
    "fold": ("fold_rows_kernel",),
    "events": ("events_kernel",),
    "events_scan": ("events_scan_kernel",),
}


def trace_events(path: str) -> list:
    """A Chrome trace's complete events (``ph`` X)."""
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def trace_summary(events: list, top: int = 10) -> dict:
    """A trace's kernels (``trace_events``): their count and summed device
    time, the profiled window (first event to last), the device's idle
    share of it, the top kernels by device time and the launches of each
    kernel of KERNEL_FUNCS."""
    lo = min(float(e["ts"]) for e in events)
    hi = max(float(e["ts"]) + float(e.get("dur", 0)) for e in events)
    by_name = {}
    for e in events:
        if e.get("cat") == "kernel":
            t = by_name.setdefault(e["name"], [0.0, 0])
            t[0] += float(e.get("dur", 0))
            t[1] += 1
    dev_us = sum(t for t, _ in by_name.values())
    seen = {k: sum(n for name, (_, n) in by_name.items()
                   if any(f in name for f in funcs))
            for k, funcs in KERNEL_FUNCS.items()}
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"events": len(events), "window_s": (hi - lo) / 1e6,
            "device_kernels": sum(n for _, n in by_name.values()),
            "device_kernel_s": dev_us / 1e6,
            "device_idle_share": 1.0 - dev_us / (hi - lo),
            "kernel_launches_in_trace": seen,
            "top_kernels": [{"name": name[:90], "device_ms": t / 1e3,
                             "share": t / dev_us, "calls": n}
                            for name, (t, n) in rows]}


def run_profile(torch, n_genomes: int, golden: pathlib.Path) -> dict:
    """``--profile`` through the CLI: the goldens on both paths (files
    byte-equal to phase 2's), then mid's first PROFILE_QUERIES query
    genomes against all of mid on the fast path (TSV byte-equal to phase
    3's lines of those queries; every kernel named in the trace).  Returns
    the kernels' launches in the mid run (counted from 0 just before)."""
    from fastani_tpu_torch.ops import cuda as kc

    cwd = os.getcwd()
    os.chdir(golden)
    try:
        same = []
        for args, out, want, sufs in (
                (["-q", "base.fa", "-r", "strainA.fa"], "p_g1.txt",
                 "g1.txt", ("",)),
                (["-q", "multi.fa", "--rl", "refs.txt", "--exact",
                  "--visualize", "--matrix"], "px_g2.txt", "x_g2.txt",
                 ("", ".matrix", ".visual"))):
            st = {}
            timed_cli(torch, args + ["-o", out, "--profile", "prof"], st)
            same += [pathlib.Path(out + suf).read_bytes()
                     == pathlib.Path(want + suf).read_bytes()
                     for suf in sufs]
            same.append(os.path.exists(st["profile_trace"]))
        shutil.rmtree("prof")
    finally:
        os.chdir(cwd)
    emit({"phase": "profile_golden", "byte_equal_and_traced": same})
    if not all(same):
        raise AssertionError(f"profile: goldens differ or untraced: {same}")

    wd = WORK / "mid"
    lst = str(wd / "genomes.txt")
    queries = first_queries(wd, PROFILE_QUERIES)
    n_pairs = PROFILE_QUERIES * n_genomes
    stats = {}
    kc.reset_launches()
    wall = timed_cli(torch, ["--ql", queries, "--rl", lst, "-o",
                             str(wd / "prof.txt"), "--profile",
                             str(wd / "prof")], stats)
    launches = dict(kc.LAUNCHES)
    t0 = time.time()
    summary = {"trace_bytes": os.path.getsize(stats["profile_trace"]),
               **trace_summary(trace_events(stats["profile_trace"]))}
    same = [(wd / "prof.txt").read_bytes()
            == tsv_of_queries(wd / "mid.txt", queries)]
    emit({"phase": "profile", "queries": PROFILE_QUERIES, "pairs": n_pairs,
          "batches": stats["batches"],
          **run_metrics(torch, wall, n_pairs),
          "t_map_fold_s": stats["t_map_fold"],
          "t_trace_export_s": stats["t_trace_export"],
          "t_trace_read_s": time.time() - t0, "launches": launches,
          "launches_traced": stats["profile_launches"],
          "byte_equal_fast": same, **summary})
    shutil.rmtree(wd / "prof")
    # each wrapper launch of the traced window is one kernel in the trace,
    # replayed graphs' included: the counts added a replay are what ran
    in_trace = summary["kernel_launches_in_trace"]
    events_at_k4("profile", launches)
    unnamed = [k for k, n in in_trace.items() if not n]
    if unnamed or in_trace != stats["profile_launches"] or not all(same):
        raise AssertionError(f"profile: kernels not in the trace: {unnamed}; "
                             f"in the trace {in_trace} against launches "
                             f"{stats['profile_launches']}; files equal to "
                             f"phase 3's: {same}")
    return launches


# ---------------------------------------------------------------------------
# phase 3: the main path at a real size
# ---------------------------------------------------------------------------

def build_workload(np, workdir: pathlib.Path, n_genomes: int, size: int):
    """bench.py's generator (seed 123): one random genome, each genome a
    copy with 1%..5% substitutions and small indels."""
    rng = np.random.default_rng(123)
    base = genome_bytes(np, rng, size)
    paths = []
    for i in range(n_genomes):
        g = mutate_genome(np, rng, base,
                          0.01 + 0.04 * (i / max(n_genomes - 1, 1)),
                          indel_rate=0.0002)
        p = workdir / f"g{i}.fa"
        write_fasta(p, [(f"g{i}", g)])
        paths.append(str(p))
    return paths


def build_clustered(np, workdir: pathlib.Path, n_genomes: int, size: int,
                    clusters: int, seed: int = 1234):
    """scripts/run_scale1000.py's generator: ``clusters`` unrelated random
    genomes, each the base of ceil(n / clusters) strains with 1%..5%
    substitutions and small indels (genome i is g{i}.fa, in cluster
    i // per).  Files already in ``workdir`` are kept, as that script
    keeps them."""
    paths = [workdir / f"g{i}.fa" for i in range(n_genomes)]
    if all(p.exists() and p.stat().st_size > size for p in paths):
        return [str(p) for p in paths]
    rng = np.random.default_rng(seed)
    per = -(-n_genomes // clusters)
    i = 0
    for _ in range(clusters):
        base = genome_bytes(np, rng, size)
        for j in range(min(per, n_genomes - i)):
            g = mutate_genome(np, rng, base,
                              0.01 + 0.04 * (j / max(per - 1, 1)),
                              indel_rate=0.0002)
            write_fasta(paths[i], [(f"g{i}", g)])
            i += 1
    return [str(p) for p in paths]


def build_draft_panel(np, workdir: pathlib.Path, seed: int = 2101,
                      big: int = 2_000_000, n_small: int = 2100,
                      small: int = 20, query_bp: int = 150_000):
    """References whose L1 hit keys overflow 32 bits: a draft assembly of
    ``n_small`` random contigs of ``small`` bases and then one contig of
    ``big`` bases, and a strain of that contig's last ``query_bp`` bases
    (3% substitutions, small indels).  Every contig counts a seqId, so
    the seqIds up to 2101 need 12 bits beside the 21 of the positions
    (``MapperConfig.from_params``: ``wpos_bits`` None, the int64 key
    route), and the hits on the last two seqIds have keys above 2^32.
    Contigs of ``small`` bases above the window put index entries on every
    seqId, as a real draft assembly does; shorter ones give no index rows
    (an index build row each: cheap on the card, slow on one CPU thread).
    The query genome is that last stretch with 2% substitutions and small
    indels.  Returns ([draft path, strain path], query path)."""
    rng = np.random.default_rng(seed)
    base = genome_bytes(np, rng, big)
    tail = base[-query_bp:]
    contigs = [(f"c{i}", genome_bytes(np, rng, small))
               for i in range(n_small)] + [("big", base)]
    refs = [workdir / "draft.fa", workdir / "strain.fa"]
    query = workdir / "draft_query.fa"
    write_fasta(refs[0], contigs)
    write_fasta(refs[1], [("s", mutate_genome(np, rng, tail, 0.03, 0.0003))])
    write_fasta(query, [("q", mutate_genome(np, rng, tail, 0.02, 0.0003))])
    return [str(r) for r in refs], str(query)


def run_main_path(torch, np, n_genomes: int, size: int):
    """Returns (launches, genome paths, batches, the phase's line, the
    run's stats); the genomes stay in .smokework/mid for phase 4."""
    from fastani_tpu_torch import cli
    from fastani_tpu_torch.config import Parameters, scale_caps
    from fastani_tpu_torch.models import jitmap
    from fastani_tpu_torch.ops import cuda as kc

    wd = WORK / "mid"
    wd.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    paths = build_workload(np, wd, n_genomes, size)
    emit({"phase": "workload", "genomes": n_genomes, "genome_bp": size,
          "frag_len": 3000, "seed": 123, "gen_s": time.time() - t0})
    genomes = wd / "genomes.txt"
    genomes.write_text("\n".join(paths) + "\n")
    out = wd / "mid.txt"
    stats = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kc.reset_launches()
    t0 = time.time()
    rc = cli.main(["--ql", str(genomes), "--rl", str(genomes), "-o", str(out),
                   "--matrix", "--device", "cuda"], stats=stats)
    torch.cuda.synchronize()
    wall = time.time() - t0
    if rc != 0:
        raise AssertionError(f"CLI exited with {rc}")
    launches = dict(kc.LAUNCHES)
    n_pairs = n_genomes * n_genomes
    lines = [ln for ln in out.read_text().split("\n") if ln]
    ani = [float(ln.split("\t")[2]) for ln in lines]
    matrix_rows = len(pathlib.Path(f"{out}.matrix").read_text().splitlines())
    caps = Parameters().finalize()
    scale_caps(n_genomes, caps)
    row = {"phase": "main_path", "genomes": n_genomes, "pairs": n_pairs,
           "wall_s": wall, "pairs_per_s": n_pairs / wall,
           "t_index_build_s": stats["t_index_build"],
           "t_mapper_init_s": stats["t_mapper_init"],
           "t_map_fold_s": stats["t_map_fold"], "t_write_s": stats["t_write"],
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           **graph_numbers(stats),
           "batches": stats["batches"], "fallback_frags": stats["fallback_frags"],
           "counters_max": {k: stats[k] for k in jitmap.COUNT_NAMES},
           "launches": launches, "tsv_rows": len(lines),
           "ani_min": min(ani) if ani else None,
           "ani_max": max(ani) if ani else None,
           "matrix_rows": matrix_rows,
           "caps": {"hits_cap": caps.hits_cap, "cand_cap": caps.cand_cap,
                    "l2_entry_cap": caps.l2_entry_cap,
                    "sketch_cap": caps.sketch_cap}}
    emit(row)
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    events_at_k4("main path", launches)
    if stats["fallback_frags"]:
        raise AssertionError(f"{stats['fallback_frags']} fragments fell back")
    if len(lines) != n_pairs or matrix_rows != n_genomes + 1:
        raise AssertionError(f"{len(lines)} TSV rows for {n_pairs} pairs, "
                             f"{matrix_rows} matrix lines")
    if not all(75.0 < a <= 100.0 for a in ani):
        raise AssertionError(f"ANI out of range: {min(ani)}..{max(ani)}")
    return launches, paths, stats["batches"], row, stats


# ---------------------------------------------------------------------------
# phase scale: the main path at the JAX package's own scale
# ---------------------------------------------------------------------------

QUICK = (8, 1_000_000)            # bench.py's quick: 8 genomes x 1 Mbp
FULL = (100, 3_000_000)           # bench.py's full: 100 genomes x 3 Mbp
# scripts/run_scale1000.py: 1000 genomes x 1 Mbp in 20 clusters of 50
SCALE1000 = (1000, 1_000_000, 20)
# the query genomes of the fast/exact subset and of the site-checked run
SUBSET_QUERIES = 8
# the 64-bit key panel's short contigs: above the window, as a draft
# assembly's are
DRAFT_CONTIG_BP = 200
# the scale sites timed for the kernels table (the others are mid's
# shapes): (kernel, site label)
SCALE_TIMED = (("sort", "L1 hits"), ("compact", "L1 leaders"),
               ("compact", "valid units"), ("fold", "finalize"),
               ("events", "L2 events"), ("sort_kv", "L2 events"),
               ("events_scan", "L2 events"), ("walk", "L2 walk"))


def scale_line(torch, run: str, stats: dict, wall: float, n_pairs: int,
               launches: dict) -> dict:
    """One scale run's line: wall, pairs/s, phase seconds, peak device
    bytes, graphs and batches, caps, the counters' maxima, fallback and
    redone work, every kernel's launches (counted from 0 before it)."""
    return {"phase": "scale", "run": run, "pairs": n_pairs, "wall_s": wall,
            "pairs_per_s": n_pairs / wall,
            **{f"{k}_s": stats.get(k) for k in (
                "t_index_build", "t_mapper_init", "t_autotune", "t_map_fold",
                "t_map", "t_fold", "t_write")},
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            **graph_numbers(stats), "batches": stats["batches"],
            "hits_cap_static": stats.get("hits_cap_static"),
            "hits_cap": stats.get("hits_cap"),
            "counters_max": {k: stats[k] for k in (
                "max_hits", "max_groups", "max_s", "max_span", "n_units")},
            "fallback_frags": stats["fallback_frags"],
            "oracle_frags": stats["oracle_frags"],
            "redone_queries": stats.get("redone_queries"),
            "launches": launches}


def scale_whole(torch, tag: str, wd: pathlib.Path, paths: list):
    """A panel all against all through the CLI's fast path (``--matrix``,
    graphs on): every kernel launched, no batch eager, 0 fallback
    fragments.  Returns (its line, its TSV rows, the TSV's path)."""
    from fastani_tpu_torch.ops import cuda as kc

    lst = wd / "genomes.txt"
    lst.write_text("\n".join(paths) + "\n")
    n = len(paths)
    out = wd / "all.txt"
    stats = {}
    kc.reset_launches()
    wall = timed_cli(torch, ["--ql", str(lst), "--rl", str(lst), "-o",
                             str(out), "--matrix"], stats)
    row = scale_line(torch, f"{tag} fast", stats, wall, n * n,
                     dict(kc.LAUNCHES))
    rows = tsv_rows(out)
    row.update(tsv_rows=len(rows), matrix_lines=len(pathlib.Path(
        f"{out}.matrix").read_text().splitlines()))
    emit(row)
    missing = [k for k, v in row["launches"].items() if v <= 0]
    if missing:
        raise AssertionError(f"{tag}: kernels not launched: {missing}")
    events_at_k4(tag, row["launches"])
    if stats["fallback_frags"] or row["matrix_lines"] != n + 1:
        raise AssertionError(f"{tag}: {stats['fallback_frags']} fragments "
                             f"fell back, {row['matrix_lines']} matrix lines")
    no_eager_batches(tag, stats)
    return row, rows, out


def scale_panel(torch, tag: str, wd: pathlib.Path, paths: list):
    """``scale_whole``, then the panel's first SUBSET_QUERIES query genomes
    against all: the fast path eagerly with every kernel's wrapper wrapped
    (``kernel_sites``) and the exact path (``--exact``), each TSV
    byte-equal to the whole run's lines of those queries; every kernel
    held bit-equal to its plain version at each call site of the eager
    run (``check_sites``).  Returns (the whole run's line, its TSV rows,
    ``site_labels`` of the eager run, that run's batches)."""
    from fastani_tpu_torch.ops import cuda as kc

    row, rows, out = scale_whole(torch, tag, wd, paths)
    lst = wd / "genomes.txt"
    n = len(paths)
    sub = first_queries(wd, SUBSET_QUERIES)
    want = tsv_of_queries(out, sub)
    stats = {}
    kc.reset_launches()
    with kernel_sites(torch, kc.KERNELS, shapes_per_site=3) as seen:
        wall = timed_cli(torch, ["--ql", sub, "--rl", str(lst), "-o",
                                 str(wd / "sub_fast.txt")], stats)
    launches = dict(kc.LAUNCHES)
    same = [(wd / "sub_fast.txt").read_bytes() == want]
    sub_row = scale_line(torch, f"{tag} first {SUBSET_QUERIES} fast eager",
                         stats, wall, SUBSET_QUERIES * n, launches)
    sub_batches = stats["batches"]
    stats = {}
    wall = timed_cli(torch, ["--ql", sub, "--rl", str(lst), "-o",
                             str(wd / "sub_exact.txt"), "--exact"], stats)
    same.append((wd / "sub_exact.txt").read_bytes() == want)
    emit({**sub_row, "byte_equal_whole_run": same[0]})
    emit({**scale_line(torch, f"{tag} first {SUBSET_QUERIES} exact", stats,
                       wall, SUBSET_QUERIES * n, {}),
          "byte_equal_whole_run": same[1]})
    if not all(same) or not want:
        raise AssertionError(f"{tag}: the first {SUBSET_QUERIES} queries' "
                             f"fast and exact TSVs against the whole run's "
                             f"lines: {same}")
    check_sites(torch, f"{tag} first {SUBSET_QUERIES}", seen, launches)
    return row, rows, site_labels(seen), sub_batches


def time_scale_sites(torch, tag: str, sites: dict, batches: int,
                     whole: dict, results: dict, murmur: dict) -> None:
    """Kernel lines (``time_site``) at a panel's SCALE_TIMED sites, on the
    first input each got in the eager subset run; ``launches_whole`` is the
    site's launches in the whole run: for L1 and the unit compaction
    worked out, the subset's calls a batch (a whole number, else the
    phase fails) times the whole run's batches; for the rest counted, the
    kernel's launches less the mapper's warm-up (all their calls are that
    site's)."""
    record, record_fold = kernel_recorders(torch, results)
    warm = whole["warmup_launches"]
    for kernel, label in SCALE_TIMED:
        v = sites[(kernel, label)]
        if kernel in ("sort", "compact"):
            if v["calls"] % batches:
                raise AssertionError(f"{tag}: {kernel} at {label}: "
                                     f"{v['calls']} calls in {batches} "
                                     f"batches")
            n = v["calls"] // batches * whole["batches"]
        else:
            n = whole["launches"][kernel] - warm.get(kernel, 0)
        (a, kw), = map_tensors(torch, lambda x: x.to("cuda"), v["inputs"][:1])
        time_site(torch, record, record_fold, kernel, f"{tag} {label}", a, kw,
                  murmur, launches_whole=n, launches_subset=v["launches"])
        del a, kw


def site_width(sites: dict, kernel: str, label: str) -> int:
    """The width of a site's first input (its first argument's last
    dimension; the compaction's ``width`` keyword where given)."""
    (a, kw), = sites[(kernel, label)]["inputs"][:1]
    return kw["width"] if "width" in kw else a[0].shape[-1]


def run_int64_route(torch, np) -> dict:
    """``build_draft_panel`` with DRAFT_CONTIG_BP contigs through the CLI's
    fast path on the card and on the CPU: L1 hit keys past 32 bits
    (``wpos_bits`` None, L1's sort by ``torch.sort``) on every seqId, the
    same rows, equal counts, ANI within 1e-3."""
    from fastani_tpu_torch import cli
    from fastani_tpu_torch.models import jitmap
    from fastani_tpu_torch.ops import cuda as kc

    wd = WORK / "draft"
    wd.mkdir(parents=True, exist_ok=True)
    refs, query = build_draft_panel(np, wd, small=DRAFT_CONTIG_BP)
    (wd / "refs.txt").write_text("\n".join(refs) + "\n")
    mappers, make = [], jitmap.job_mapper
    jitmap.job_mapper = lambda *a: mappers.append(make(*a)) or mappers[-1]
    runs = {}
    try:
        for device in ("cuda", "cpu"):
            stats = {}
            torch.cuda.synchronize()
            kc.reset_launches()
            t0 = time.time()
            rc = cli.main(["-q", query, "--rl", str(wd / "refs.txt"), "-o",
                           str(wd / f"{device}.txt"), "--device", device],
                          stats=stats)
            torch.cuda.synchronize()
            if rc != 0:
                raise AssertionError(f"int64 route: the CLI exited with {rc}")
            runs[device] = {"wall_s": time.time() - t0,
                            "launches": dict(kc.LAUNCHES),
                            "fallback_frags": stats["fallback_frags"],
                            "max_hits": stats["max_hits"]}
    finally:
        jitmap.job_mapper = make
    cfg, t = mappers[0].cfg, mappers[0].tables
    dev = same_rows(tsv_rows(wd / "cuda.txt"), tsv_rows(wd / "cpu.txt"),
                    "int64 route")
    keys = t.occ_keys[: t.n_occ]
    contigs = len(mappers[0].index.metadata)
    row = {"phase": "scale", "run": "int64 keys", "contigs": contigs,
           "contig_bp": DRAFT_CONTIG_BP, "wpos_bits": cfg.wpos_bits,
           "key_dtype": str(keys.dtype),
           "seqids_keyed": int((keys >> 32).unique().numel()),
           "max_key": int(keys.max()), "rows": len(tsv_rows(wd / "cuda.txt")),
           "max_ani_diff_vs_cpu": dev, "card": runs["cuda"],
           "cpu": runs["cpu"]}
    emit(row)
    shutil.rmtree(wd, ignore_errors=True)
    if cfg.wpos_bits is not None or keys.dtype != torch.int64 or \
            row["max_key"] < 1 << 32 or row["seqids_keyed"] != contigs or \
            not row["rows"]:
        raise AssertionError(f"int64 route: wpos_bits {cfg.wpos_bits}, keys "
                             f"{keys.dtype} up to {row['max_key']} on "
                             f"{row['seqids_keyed']} of {contigs} seqIds, "
                             f"{row['rows']} rows")
    return row


def run_scale(torch, np) -> dict:
    """Phase scale: bench.py's ``quick`` (QUICK, seed 123; the whole run
    only), its ``full`` (FULL) and the clustered
    1000-genome all-vs-all (SCALE1000, seed 1234) through ``scale_panel``,
    the latter also against ``scripts/torch_scale1000.py``'s run (its
    per-cluster caps; same rows, equal counts, ANI within 1e-3), each
    panel's new call sites timed (``time_scale_sites``), then the int64
    key route (``run_int64_route``).  Returns {"full", "scale1000"}: each
    whole run's kernel launches."""
    import importlib.util

    from fastani_tpu_torch.ops import cuda as kc

    spec = importlib.util.spec_from_file_location(
        "torch_scale1000", ROOT / "scripts" / "torch_scale1000.py")
    torch_scale1000 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(torch_scale1000)
    murmur = murmur_sass_ops(kc)
    results = {}
    n, size = QUICK
    wd = WORK / "quick"
    wd.mkdir(parents=True, exist_ok=True)
    _, rows, _ = scale_whole(torch, "quick", wd,
                             build_workload(np, wd, n, size))
    shutil.rmtree(wd, ignore_errors=True)
    if len(rows) != n * n:
        raise AssertionError(f"quick: {len(rows)} TSV rows of {n * n}")

    n, size = FULL
    wd = WORK / "full"
    wd.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    paths = build_workload(np, wd, n, size)
    emit({"phase": "scale_workload", "run": "full", "genomes": n,
          "genome_bp": size, "seed": 123, "gen_s": time.time() - t0})
    full, rows, sites, batches = scale_panel(torch, "full", wd, paths)
    widths = {"L1 hits": site_width(sites, "sort", "L1 hits"),
              "L1 leaders": site_width(sites, "compact", "L1 leaders")}
    emit({"phase": "scale_sites", "run": "full", "widths": widths})
    if len(rows) != n * n or widths["L1 hits"] <= 16384 or \
            widths["L1 leaders"] != 256:
        raise AssertionError(f"full: {len(rows)} TSV rows of {n * n}, L1 "
                             f"site widths {widths}")
    time_scale_sites(torch, "full", sites, batches, full, results, murmur)
    del sites
    shutil.rmtree(wd, ignore_errors=True)

    n, size, clusters = SCALE1000
    per = -(-n // clusters)
    wd = WORK / "scale1000"
    wd.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    paths = build_clustered(np, wd, n, size, clusters)
    emit({"phase": "scale_workload", "run": "scale1000", "genomes": n,
          "genome_bp": size, "clusters": clusters, "seed": 1234,
          "gen_s": time.time() - t0})
    big, rows, sites, batches = scale_panel(torch, "scale1000", wd, paths)
    gid = {p: i for i, p in enumerate(paths)}
    same = {(q, r) for q, r in rows if gid[q] // per == gid[r] // per}
    fold_gr = sites[("fold", "finalize")]["inputs"][0][0][4].shape[1]
    widths = {"valid units": site_width(sites, "compact", "valid units"),
              "fold genomes": fold_gr}
    emit({"phase": "scale_sites", "run": "scale1000", "widths": widths,
          "same_cluster_rows": len(same), "other_rows": len(rows) - len(same)})
    if len(same) != n * per or widths != {"valid units": 524288,
                                          "fold genomes": n}:
        raise AssertionError(f"scale1000: {len(same)} same-cluster rows of "
                             f"{n * per}, site widths {widths}")
    time_scale_sites(torch, "scale1000", sites, batches, big, results,
                     murmur)
    del sites
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    script = torch_scale1000.run(paths, clusters, tsv=str(wd / "script.txt"))
    script_rows = tsv_rows(wd / "script.txt")
    dev = same_rows(script_rows, rows, "scale1000 script against the CLI")
    emit({"phase": "scale", "run": "scale1000 script", **script,
          "wall_s": time.time() - t0, "tsv_rows": len(script_rows),
          "max_ani_diff_vs_cli": dev})
    if script["fallback_frags"]:
        raise AssertionError(f"scale1000 script: {script['fallback_frags']} "
                             f"fragments fell back")
    shutil.rmtree(wd, ignore_errors=True)
    run_int64_route(torch, np)
    return {"full": full["launches"], "scale1000": big["launches"]}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from fastani_tpu_torch.ops import cuda as kc

    t_all = time.time()
    smi = nvidia_smi()
    print(smi, flush=True)
    t0 = time.time()
    built = kc.build_all()
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.time() - t0, "built": built})

    golden_dir = run_golden(np)
    launches, paths, batches, fast_row, fast_stats = run_main_path(
        torch, np, N_GENOMES, GENOME_BP)
    run_native_io(paths)
    run_redo(torch, golden_dir)
    launches_exact, exact_row = run_exact_mid(torch, N_GENOMES)
    run_graphs(torch, N_GENOMES, {
        "fast": {k: fast_row[k] for k in ("wall_s", "peak_mem_bytes",
                                          "batches", *graph_numbers(
                                              fast_stats))}
        | {"t_map_s": fast_row["t_map_fold_s"], "launches": launches},
        "exact": exact_row | {"launches": launches_exact}})
    run_sanity_and_oracle(torch, np, golden_dir)
    launches_mesh, mesh_sites = run_mesh(torch, np, N_GENOMES, golden_dir)
    launches_profile = run_profile(torch, N_GENOMES, golden_dir)
    # phase 4 counts the batches' launches, as the eager capture makes them
    kernels = check_kernels(torch, np, paths, batches,
                            less_warmup(launches, fast_stats))
    launches_scale = run_scale(torch, np)

    table = []
    for name in kc.KERNELS:
        r = kernels[name]
        table.append({"name": name, "route": "cuda", "source": SOURCE[name],
                      "replaces": REPLACES[name], "launches": launches[name],
                      "launches_exact": launches_exact[name],
                      "launches_mesh": launches_mesh[name],
                      "launches_profile": launches_profile[name],
                      "launches_full": launches_scale["full"][name],
                      "launches_scale1000": launches_scale["scale1000"][name],
                      "max_abs_err": r["max_abs_err"],
                      "max_abs_err_mesh": mesh_sites[name]["max_abs_err"],
                      "ms": r["kernel_ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"],
                      "library_ms": r["library_ms"]})
    emit({"kernels": table})
    for sub in ("golden", "mid"):
        shutil.rmtree(WORK / sub, ignore_errors=True)
    print(f"total_s {time.time() - t_all:.1f}", flush=True)
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
