"""The FASTA reader's memo of one job (``fastani_tpu_torch/io/fasta.py``
``memo``, ``contigs``, ``contig_lengths``, ``release``) on the CPU: the
batch plan from contig lengths against the JAX package's
``load_query_fragments``; the rows ``make_batch`` gives with and without
the memo, and past its host-memory guard; one parse a file a job over two
jobs in one process, and the reader outside a job as before; a job's TSV,
``.matrix`` and ``.visual`` byte-equal with the memo and without it; the
index build's bookkeeping on its own thread while workers parse."""

import contextlib
import threading

import numpy as np
import pytest
import torch

from fastani_tpu_torch.config import Parameters
from fastani_tpu_torch.io import fasta
from fastani_tpu_torch.models import pipeline
from fastani_tpu_torch.utils import spans
from tests import synth

# one intra-op thread: the suite runs several xdist workers per core, and
# torch's thread pool on top of them stalls every small CPU op
torch.set_num_threads(1)

B = 64

# contig lengths of each plan case (frag_len 3000, k 16, w 24 by default)
PLAN_CASES = {
    "short": [10, 20, 2999, 7000, 5],
    "multiple": [3000, 6000, 9000],
    "gzip": [100, 4500, 3100],
    "fastq": [4500, 50, 6100],
    "lower_n": [5000, 17, 3500],
}


def _contigs(rng, lengths):
    return [(f"c{i}", synth.random_genome(rng, n))
            for i, n in enumerate(lengths)]


def _write_case(path_dir, name, rng):
    contigs = _contigs(rng, PLAN_CASES[name])
    if name == "gzip":
        path = path_dir / "q.fa.gz"
        synth.write_fasta_gz(path, contigs)
    elif name == "fastq":
        path = path_dir / "q.fq"
        synth.write_fastq(path, contigs)
    else:
        if name == "lower_n":
            for _, seq in contigs:
                seq[::3] = ord("n")
                seq[1::7] = ord("a")
                seq[5::11] = ord("N")
        path = path_dir / "q.fa"
        synth.write_fasta(path, contigs)
    return str(path)


@pytest.mark.parametrize("in_memo", [False, True], ids=["alone", "memo"])
@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_plan_from_lengths_matches_load_query_fragments(tmp_path, name,
                                                        in_memo):
    """The stream's fragment counts and .visual offsets, from contig lengths
    alone, equal the JAX package's ``load_query_fragments``; the loaded
    fragments equal its bytes."""
    from fastani_tpu.config import Parameters as JParams
    from fastani_tpu.models import pipeline as jpipe

    path = _write_case(tmp_path, name, np.random.default_rng(7))
    want = jpipe.load_query_fragments(path, JParams().finalize())
    params = Parameters().finalize()
    with fasta.memo([path]) if in_memo else contextlib.nullcontext():
        stream = pipeline.FragmentStream([path], params)
        got = stream.get_query(0)
    assert stream.counts == [want.total_fragments]
    np.testing.assert_array_equal(stream.vis_offsets(0), want.vis_offsets)
    assert stream.vis_offsets(0).dtype == np.int64
    np.testing.assert_array_equal(got.frags, want.frags)
    np.testing.assert_array_equal(got.frag_ids, want.frag_ids)
    np.testing.assert_array_equal(got.vis_offsets, want.vis_offsets)
    assert got.total_fragments == want.total_fragments


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """Three strains of a 60 kbp genome, the third of three contigs with
    a short one between them."""
    wd = tmp_path_factory.mktemp("torch_fasta_memo")
    rng = np.random.default_rng(2025)
    base = synth.random_genome(rng, 60_000)
    a = synth.mutate_genome(rng, base, sub_rate=0.02, indel_rate=0.0003)
    c = synth.mutate_genome(rng, base, sub_rate=0.04, indel_rate=0.0003)
    synth.write_fasta(wd / "base.fa", [("base_ctg", base)])
    synth.write_fasta(wd / "strainA.fa", [("sA_ctg", a)])
    synth.write_fasta(wd / "strainC.fa", [("sC_1", c[:35_000]),
                                          ("sC_short", c[35_000:36_500]),
                                          ("sC_2", c[36_500:])])
    return wd, [str(wd / n) for n in ("base.fa", "strainA.fa", "strainC.fa")]


def _all_rows(paths, held: str):
    """Every ``make_batch`` of a stream over ``paths`` in batches of 8,
    evicting as the loops do: without a memo, with one that the index
    build's parse filled, or with one past its guard.  Returns (the
    batches, the job's counters)."""
    params = Parameters(query_sequences=paths, ref_sequences=paths)
    params.finalize()
    stats = {}
    memo = (fasta.memo(paths) if held != "none"
            else contextlib.nullcontext())
    with spans.job(stats), memo:
        if held == "guard":
            fasta._MEMO.get().limit = 0
        for p in dict.fromkeys(paths):
            fasta.contigs(p)                  # the index build's parse
        stream = pipeline.FragmentStream(paths, params)
        rows = []
        for b0 in range(0, stream.F, 8):
            rows.append(stream.make_batch(b0, 8))
            stream.evict_up_to(stream.qno_of_row(b0))
    return rows, stats["counters"]


@pytest.mark.parametrize("held", ["memo", "guard"])
def test_memo_loads_give_the_same_rows(panel, held):
    _, paths = panel
    listed = [paths[0], paths[2], paths[0], paths[1]]   # one path twice
    want, plain = _all_rows(listed, "none")
    got, c = _all_rows(listed, held)
    assert len(got) == len(want) >= 8
    for g, w in zip(got, want):
        for a, b in zip(g[:3], w[:3]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert g[3] == w[3]
    assert c["fasta.files"] == plain["fasta.files"] == 3
    assert plain["fasta.parses"] == 3 + 4 + 4   # index, plan, loads
    if held == "memo":
        # the one parse a file; the twice-listed path kept its bytes
        assert c["fasta.parses"] == 3
        assert c["fasta.memo_hits[query_plan]"] == 4
        assert c["fasta.memo_hits[query.load]"] == 4
    else:
        # past the guard only lengths are held: the loads parse again
        assert c["fasta.parses"] == 3 + 4
        assert c["fasta.memo_hits[query_plan]"] == c["fasta.memo_hits"] == 4


def _run(fn, paths, queries, out, **kw):
    params = Parameters(query_sequences=queries, ref_sequences=paths,
                        out_file_name=str(out), matrix_output=True,
                        frag_batch=B, **kw)
    stats = {}
    fn(params, device="cpu", log=lambda m: None, stats=stats)
    return stats["counters"]


def test_each_job_parses_each_file_once(panel, tmp_path, monkeypatch):
    """Two ``run_fast`` jobs back to back: each parses every file once
    (the memo starts empty with each job); outside a job the reader parses
    every call and logs each to ``FASTANI_TRACE_READS`` as before."""
    _, paths = panel
    trace = tmp_path / "reads.log"
    monkeypatch.setenv("FASTANI_TRACE_READS", str(trace))
    for i in range(2):
        c = _run(pipeline.run_fast, paths, paths, tmp_path / f"j{i}.txt")
        assert c["fasta.parses"] == c["fasta.files"] == len(paths)
        assert c["fasta.parses[index.parse]"] == len(paths)
    assert sorted(trace.read_text().split()) == sorted(paths * 2)
    assert fasta._MEMO.get() is None

    trace.write_text("")
    p = paths[2]
    list(fasta.read_sequences(p))
    lengths = fasta.contig_lengths(p)
    assert len(lengths) == 3 and lengths[:2].tolist() == [35_000, 1_500]
    assert fasta.genome_length_for_ani(p, 3000) == (
        33_000 + int(lengths[2]) // 3000 * 3000)
    recs = fasta.contigs(p)
    assert recs.names == ["sC_1", "sC_short", "sC_2"]
    assert trace.read_text().split() == [p] * 4


LISTS = {"all_vs_all": (None, None), "disjoint": ([2], [0, 1])}


@pytest.mark.parametrize("path", ["fast", "exact"])
@pytest.mark.parametrize("lists", sorted(LISTS))
def test_outputs_equal_without_the_memo(panel, tmp_path, monkeypatch, lists,
                                        path):
    """A job's TSV and ``.matrix`` (and on the exact path its ``.visual``)
    byte-equal with the memo and with the reader parsing each call, as
    the path did before it had one."""
    _, paths = panel
    q, r = LISTS[lists]
    queries = paths if q is None else [paths[i] for i in q]
    refs = paths if r is None else [paths[i] for i in r]
    fn, kw = ((pipeline.run_fast, {}) if path == "fast"
              else (pipeline.run, {"visualize": True}))
    c = _run(fn, refs, queries, tmp_path / "memo.txt", **kw)
    monkeypatch.setattr(fasta, "memo",
                        lambda queries: contextlib.nullcontext())
    c0 = _run(fn, refs, queries, tmp_path / "parse.txt", **kw)
    n = len(set(queries) | set(refs))
    assert c["fasta.parses"] == c["fasta.files"] == c0["fasta.files"] == n
    assert "fasta.memo_hits" not in c0 and c0["fasta.parses"] > n
    sufs = ["", ".matrix"] + ([".visual"] if path == "exact" else [])
    for suf in sufs:
        got = (tmp_path / f"memo.txt{suf}").read_bytes()
        assert got == (tmp_path / f"parse.txt{suf}").read_bytes(), suf
        assert got.strip(), suf


@pytest.mark.parametrize("held", ["fresh", "query_held"])
def test_index_build_bookkeeping_on_the_build_thread(panel, monkeypatch,
                                                     held):
    """The index build's parse on worker threads: the workers run only the
    uncounted parse; the counters, the memo and the spans are the build's
    own thread's.  A file whose bytes the memo holds is not parsed again."""
    from fastani_tpu_torch.index import device_build
    from fastani_tpu_torch.index.sketch import ReferenceIndex

    _, paths = panel
    monkeypatch.setattr(device_build.os, "sched_getaffinity",
                        lambda pid: set(range(4)))
    main = threading.current_thread()
    calls, off_thread = [], []
    real_read = fasta.read_contigs

    def read_contigs(path, upper=True):
        calls.append((path, threading.current_thread() is main))
        return real_read(path, upper)

    monkeypatch.setattr(fasta, "read_contigs", read_contigs)
    for name in ("span", "count", "gauge", "distinct"):
        real = getattr(spans, name)

        def wrapped(*a, _real=real, **kw):
            if threading.current_thread() is not main:
                off_thread.append(a[0])
            return _real(*a, **kw)

        monkeypatch.setattr(spans, name, wrapped)
    queries = [paths[1]] if held == "query_held" else []
    params = Parameters(ref_sequences=paths).finalize()
    stats = {}
    with spans.job(stats), fasta.memo(queries):
        for p in queries:
            fasta.contigs(p)              # the bytes a job already holds
        with spans.span("index_build"):
            ReferenceIndex.build_device(params, device="cpu")
    c, sp = stats["counters"], stats["spans"]
    assert not off_thread
    n = len(paths) - len(queries)
    assert c["fasta.parses[index.parse]"] == n
    assert c["fasta.files"] == len(paths)
    assert c.get("fasta.memo_hits[index.parse]", 0) == len(queries)
    assert c["index.parse_threads"] == min(3, len(paths))
    assert c["index.parse_work_ns"] > 0
    assert 0 <= c["index.parse_ready"] <= n
    # each file read once: the held one by the job's own read, the others
    # by the pool's workers
    assert sorted(p for p, _ in calls) == sorted(paths)
    assert [p for p, on_main in calls if on_main] == queries
    build = [i for i, s in enumerate(sp) if s["name"] == "index_build"]
    parse = [s for s in sp if s["name"] == "index.parse"]
    assert [s["attrs"]["file"] for s in parse] == list(range(len(paths)))
    assert all(s["parent"] == build[0] for s in parse)
    assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(parse, parse[1:]))
