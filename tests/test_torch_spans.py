"""The port's spans and counters (``fastani_tpu_torch/utils/spans.py``) on
the CPU, over the 150 kbp golden fixture (both genomes against both, in
batches of 64 fragments): the span tree of a job, the ``stats`` phase
seconds as their spans' sums, the spans as profiler ranges, nothing
entered or counted on the device without a profiler, the FASTA parses and
memo hits by purpose, ``l2.window_entries`` against a recount, and the
exact path's spans."""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fastani_tpu_torch.config import Parameters
from fastani_tpu_torch.models import jitmap, pipeline
from fastani_tpu_torch.utils import spans
from tests import synth

# one intra-op thread: the suite runs several xdist workers per core, and
# torch's thread pool on top of them stalls every small CPU op
torch.set_num_threads(1)

B = 64               # 99 fragments: two batches, the second a short tail
PHASES = ["index_build", "mapper_init", "map_loop", "write"]
FAST_TIMES = {"t_index_build": "index_build", "t_mapper_init": "mapper_init",
              "t_autotune": "autotune", "t_map_fold": "map_loop",
              "t_write": "write"}
EXACT_TIMES = {"t_index_build": "index_build", "t_mapper_init": "mapper_init",
               "t_map": "map_loop", "t_fold": "fold", "t_visual": "visual",
               "t_write": "write"}


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    """tests/test_golden_frozen.py's one-to-one fixture (seed 2024)."""
    wd = tmp_path_factory.mktemp("torch_spans")
    rng = np.random.default_rng(2024)
    base = synth.random_genome(rng, 150_000)
    strain_a = synth.mutate_genome(rng, base, sub_rate=0.02, indel_rate=0.0003)
    synth.write_fasta(wd / "base.fa", [("base_ctg", base)])
    synth.write_fasta(wd / "strainA.fa", [("sA_ctg", strain_a)])
    return wd, [str(wd / "base.fa"), str(wd / "strainA.fa")]


def _params(genomes, out, **kw):
    _, paths = genomes
    return Parameters(query_sequences=paths, ref_sequences=paths,
                      out_file_name=str(out), matrix_output=True,
                      frag_batch=B, **kw)


@pytest.fixture(scope="module")
def jobs(genomes):
    """``run_fast`` without a profiler and under ``torch.profiler`` on the
    CPU, with ``spans.profiler_range`` and ``jitmap.window_entries``
    counted and every dispatched batch kept (the mapper's config and
    tables, its height, the batch's rows): {"plain", "traced"} -> (stats,
    ranges entered, window_entries calls, batches), and the traced run's
    profiler ranges named as spans (name, start ns, end ns)."""
    wd, _ = genomes
    out = {}
    real_rf, real_we = spans.profiler_range, jitmap.window_entries
    dispatch = jitmap.Mapper.dispatch
    with pytest.MonkeyPatch.context() as mp:
        for name in ("plain", "traced"):
            entered, calls, batches = [], [], []

            class Counted:
                def __init__(self, span_name):
                    self.name, self.rf = span_name, real_rf(span_name)

                def __enter__(self):
                    entered.append(self.name)
                    return self.rf.__enter__()

                def __exit__(self, *exc):
                    return self.rf.__exit__(*exc)

            def counted_we(*a, _calls=calls):
                _calls.append(1)
                return real_we(*a)

            def kept_dispatch(self, frags, *a, _batches=batches, **kw):
                _batches.append((self.cfg, self.tables, self.height,
                                 np.array(frags)))
                return dispatch(self, frags, *a, **kw)

            mp.setattr(spans, "profiler_range", Counted)
            mp.setattr(jitmap, "window_entries", counted_we)
            mp.setattr(jitmap.Mapper, "dispatch", kept_dispatch)
            stats = {}
            params = _params(genomes, wd / f"{name}.txt")
            if name == "traced":
                with profile(activities=[ProfilerActivity.CPU]) as prof:
                    pipeline.run_fast(params, device="cpu",
                                      log=lambda m: None, stats=stats)
                names = {s["name"] for s in stats["spans"]}
                out["ranges"] = [
                    (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() in names and "CPU" in str(e.device_type())]
            else:
                pipeline.run_fast(params, device="cpu", log=lambda m: None,
                                  stats=stats)
            out[name] = (stats, entered, calls, batches)
    return out


@pytest.fixture(scope="module")
def exact(genomes):
    """The exact path's stats, with ``.visual``."""
    wd, _ = genomes
    stats = {}
    pipeline.run(_params(genomes, wd / "x.txt", visualize=True),
                 device="cpu", log=lambda m: None, stats=stats)
    return stats


def _children(sp, i):
    return [s["name"] for s in sp if s["parent"] == i]


def _check_tree(sp):
    """Every span closed, after its parent opened, inside its parent; one
    root, the ``job`` span."""
    assert [s["name"] for s in sp if s["parent"] < 0] == ["job"]
    assert sp[0]["name"] == "job"
    for i, s in enumerate(sp):
        assert 0 < s["start_ns"] <= s["end_ns"]
        p = s["parent"]
        if p >= 0:
            assert p < i
            assert sp[p]["start_ns"] <= s["start_ns"]
            assert s["end_ns"] <= sp[p]["end_ns"]


@pytest.mark.parametrize("name", ["plain", "traced"])
def test_fast_job_span_tree_is_well_formed(jobs, name):
    stats = jobs[name][0]
    sp = stats["spans"]
    _check_tree(sp)
    assert _children(sp, 0) == PHASES
    by = collections.defaultdict(list)
    for i, s in enumerate(sp):
        by[s["name"]].append(i)
    assert _children(sp, by["index_build"][0])[:2] == ["index.parse"] * 2
    assert _children(sp, by["mapper_init"][0]) == ["mapper.tables",
                                                   "query_plan", "autotune"]
    loop = _children(sp, by["map_loop"][0])
    n = stats["batches"]
    assert n == 2 == loop.count("batch")
    assert loop[-1] == "map_finish" and "cgi.finalize" in loop
    assert [sp[i]["attrs"]["i"] for i in by["batch"]] == list(range(n))
    for i in by["batch"]:
        kids = _children(sp, i)
        assert kids[0] == "batch.make"
        assert {"batch.upload", "batch.n_live_read", "cgi.update"} <= set(kids)
    assert len(by["query.load"]) == 2
    assert all(sp[sp[i]["parent"]]["name"] == "batch.make"
               for i in by["query.load"])
    assert _children(sp, by["map_finish"][0]) == ["map_finish.read"]
    assert _children(sp, by["write"][0]) == ["write.results", "write.lengths",
                                             "write.tsv", "write.matrix"]
    # the tracing-only count, and its span, only under a profiler
    windows = len(by["l2.window_count"])
    assert windows == (n if name == "traced" else 0)
    assert all(sp[sp[i]["parent"]]["name"] == "batch"
               for i in by["l2.window_count"])
    assert stats["counters"]["l2.event_slots"] > 0


def test_phase_seconds_are_their_spans_sums(jobs, exact):
    stats = jobs["plain"][0]
    for key, name in FAST_TIMES.items():
        assert stats[key] == spans.seconds(name, stats) > 0, key
    for key, name in EXACT_TIMES.items():
        assert exact[key] == spans.seconds(name, exact) > 0, key
    # no job open: nothing recorded, the pieces run as before
    assert spans.seconds("index_build") == 0.0 and not spans.tracing()
    with spans.span("index_build"):
        spans.count("fasta.parses")


def test_spans_are_profiler_ranges_with_the_same_nesting(jobs):
    stats, entered, _, _ = jobs["traced"]
    sp = stats["spans"]
    assert sorted(entered) == sorted(s["name"] for s in sp)

    # each range's parent: the innermost range that holds it
    got, open_ = [], []
    for name, start, end in sorted(jobs["ranges"],
                                   key=lambda r: (r[1], -r[2])):
        while open_ and open_[-1][2] < end:
            open_.pop()
        got.append((name, open_[-1][0] if open_ else None))
        open_.append((name, start, end))
    got.sort()
    want = sorted((s["name"], sp[s["parent"]]["name"] if s["parent"] >= 0
                   else None) for s in sp)
    assert got == want


def test_without_a_profiler_nothing_is_entered_or_counted_on_the_device(
        jobs):
    stats, entered, calls, batches = jobs["plain"]
    assert entered == [] and calls == []
    assert "l2.window_entries" not in stats["counters"]
    traced, entered_t, calls_t, _ = jobs["traced"]
    assert len(calls_t) == len(batches) == traced["batches"]
    assert len(entered_t) == len(traced["spans"])


def test_fasta_parses_by_purpose(jobs, genomes):
    # one parse a file a job, the index build's; the batch plan, the
    # batches' loads and the write's lengths take the reader's memo
    _, paths = genomes
    c = jobs["plain"][0]["counters"]
    assert c["fasta.parses[index.parse]"] == len(paths)
    readers = ("query_plan", "query.load", "write.lengths")
    for purpose in readers:
        assert c[f"fasta.memo_hits[{purpose}]"] == len(paths), purpose
    assert c["fasta.parses"] == len(paths) and c["fasta.files"] == 2
    assert c["fasta.memo_hits"] == len(readers) * len(paths)
    assert sorted(c) == sorted(
        ["fasta.parses", "fasta.files", "fasta.parses[index.parse]",
         "fasta.memo_hits", "l2.event_slots", "l2.chunks",
         "l2.chunk_units", "index.bytes", "index.peak_bytes", "l1.key_bits",
         "index.parse_threads", "index.parse_ready", "index.parse_work_ns"]
        + [f"fasta.memo_hits[{p}]" for p in readers])


def test_window_entries_equal_a_recount_from_locate_units(jobs):
    stats, _, _, batches = jobs["traced"]
    entries = slots = 0
    for cfg, tables, height, frags in batches:
        rows = np.zeros((height, frags.shape[1]), np.uint8)
        rows[:len(frags)] = frags
        u = jitmap.locate_units(cfg, torch.from_numpy(rows), tables)
        U = cfg.unit_cap
        ent = (u["eL"][:U] - u["b0"][:U]).clamp(0, cfg.l2_entry_cap)
        entries += int(ent[u["u_valid"][:U]].sum())
        n_live = int(u["n_live"])
        slots += (-(-n_live // cfg.unit_chunk) * cfg.unit_chunk
                  * (2 * cfg.l2_entry_cap + 1))
    c = stats["counters"]
    assert c["l2.window_entries"] == entries > 0
    assert c["l2.event_slots"] == slots
    assert 0 < 200 * entries / slots <= 100
    assert jobs["plain"][0]["counters"]["l2.event_slots"] == slots


def test_exact_path_spans(exact):
    stats = exact
    sp = stats["spans"]
    _check_tree(sp)
    # the host fold and the .visual write, a query genome each, come
    # between the map loop and the write
    top = _children(sp, 0)
    assert top[:3] == PHASES[:3] and top[-1] == "write"
    assert top[3:-1] == ["fold", "visual"] * 2
    names = collections.Counter(s["name"] for s in sp)
    n = stats["batches"]
    assert names["batch"] == names["batch.collect"] == names["batch.make"] \
        == names["batch.n_live_read"] == n
    assert names["fold"] == names["visual"] == 2
    assert "t_rows" not in stats
    assert stats["counters"]["fasta.parses"] == 2
