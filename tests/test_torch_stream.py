"""The JAX package's batch contract in the port, on the CPU: padded
batches (``FragmentStream.make_batch``), the deferred readout of the fast
path (``map_queries_cgi_stream`` + ``map_queries_cgi_finish``, the redo
set rebuilt from the stacked fallback masks) and the exact path's
dispatch/collect pipeline (``map_queries_batched``), each against its JAX
counterpart on the 150 kbp fixtures of ``tests/test_torch_e2e.py``, with a
batch height that leaves a short tail; and the reads of the device in the
stream's loop, counted by a ``TorchFunctionMode``."""

import collections

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from fastani_tpu.config import Parameters as JParams
from fastani_tpu.config import scale_caps as jscale_caps
from fastani_tpu.index.sketch import ReferenceIndex as JIndex
from fastani_tpu.models import device_cgi as jcgi
from fastani_tpu.models import jitmap as jjit
from fastani_tpu.models import pipeline as jpipe
from fastani_tpu_torch.config import Parameters, scale_caps
from fastani_tpu_torch.index.sketch import ReferenceIndex
from fastani_tpu_torch.models import device_cgi, jitmap, l2walk, pipeline
from fastani_tpu_torch.ops import compact, sort, winnow
from tests.test_torch_e2e import workdir  # noqa: F401  (the fixture)

# one intra-op thread: the suite runs several xdist workers per core, and
# torch's thread pool on top of them stalls every small CPU op
torch.set_num_threads(1)

B = 40              # 99 query fragments: batches of 40, 40 and a tail of 19
QUERIES = ("multi.fa", "base.fa")
REFS = ("strainA.fa", "strainB.fa", "base.fa")

# the kernels' wrappers: on the CPU they run plain versions, which read
# the host's tensors; on a card they launch a kernel and read nothing
WRAPPERS = ((winnow, "winnow_rows"), (compact, "compact_rows"),
            (sort, "sort_rows_u32"), (sort, "sort_rows_u32_kv"),
            (l2walk, "walk"), (device_cgi, "finalize_rows"))
# the tensor methods that read a tensor's values to the host
READS = {"tolist", "item", "__int__", "__bool__", "__float__", "__index__",
         "cpu", "numpy"}


def _setup(workdir, **caps):
    """Both packages' parameters (caps as both runs scale them, then
    ``caps``), indexes, streams and mappers, the JAX mapper in the JAX
    ``run_fast``'s geometry and the port's by ``jitmap.job_mapper``."""
    q = [str(workdir / f) for f in QUERIES]
    r = [str(workdir / f) for f in REFS]
    jp = JParams(query_sequences=q, ref_sequences=r, frag_batch=B).finalize()
    tp = Parameters(query_sequences=q, ref_sequences=r,
                    frag_batch=B).finalize()
    jscale_caps(len(r), jp)
    scale_caps(len(r), tp)
    for p in (jp, tp):
        for key, v in caps.items():
            setattr(p, key, v)
    jidx = JIndex.build_device(jp)
    tidx = ReferenceIndex.build_device(tp, device="cpu")
    G = len(r)
    jm = jjit.JitMapper(jp, jidx, unit_factor=max(G + 2, int(1.7 * G) + 8),
                        unit_chunk=min(512, B))
    tm = jitmap.job_mapper(tp, tidx, G, tp.frag_batch)
    assert tm.cfg.unit_cap == jm.cfg.unit_cap
    return (jp, jidx, jpipe.FragmentStream(q, jp), jm,
            tp, tidx, pipeline.FragmentStream(q, tp), tm)


def test_make_batch_matches_jax(workdir):
    """Every batch, the short tail included, equal in all four outputs:
    the rows zero-padded to B, and n_used."""
    q = [str(workdir / f) for f in QUERIES]
    js = jpipe.FragmentStream(q, JParams(query_sequences=q,
                                         frag_batch=B).finalize())
    ts = pipeline.FragmentStream(q, Parameters(query_sequences=q,
                                               frag_batch=B).finalize())
    assert ts.F == js.F == 99 and ts.F % B
    for b0 in range(0, ts.F, B):
        got, want = ts.make_batch(b0, B), js.make_batch(b0, B)
        assert got[0].shape == (B, 3000) and got[3] == want[3]
        for g, w in zip(got[:3], want[:3]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert not got[0][got[3]:].any() and not got[1][got[3]:].any()
    assert got[3] == ts.F % B


def _jax_readout(monkeypatch, jp, jidx, js, jm, n_q, n_r, redone):
    """The JAX pair ``map_queries_cgi_stream`` + ``map_queries_cgi_finish``,
    the query genomes it redoes recorded in ``redone``."""
    # the JAX redo writes into the readout arrays, which np.asarray of a
    # JAX array on the CPU makes read-only: read them out as copies
    monkeypatch.setattr(jcgi.StreamingCGI, "result", lambda self: (
        np.array(self._counts), np.array(self._sums)))
    redo = jpipe._redo_query_exact

    def recorded(qno, *args, **kw):
        redone.append(qno)
        return redo(qno, *args, **kw)

    monkeypatch.setattr(jpipe, "_redo_query_exact", recorded)
    stats = {}
    h = jpipe.map_queries_cgi_stream(js, jidx, jp, jm, n_q, n_r)
    counts, sums = jpipe.map_queries_cgi_finish(h, jidx, jp, jm, stats)
    return np.asarray(counts), np.asarray(sums), stats


def _port_readout(monkeypatch, tp, tidx, ts, tm, n_q, n_r, redone):
    redo = pipeline._redo_query_exact

    def recorded(qno, *args, **kw):
        redone.append(qno)
        return redo(qno, *args, **kw)

    monkeypatch.setattr(pipeline, "_redo_query_exact", recorded)
    stats = {}
    grid = pipeline.Grid.single(tidx, tm)
    assert grid.n_local == {0: n_r}
    h = pipeline.map_queries_cgi_stream(ts, grid, tp, n_q)
    assert h.counts.shape == (3, 11) and h.fb_masks.shape == (3, B)
    counts, sums = pipeline.map_queries_cgi_finish(h, grid, tp, stats)
    return counts, sums, stats


def test_stream_and_finish_match_jax(workdir, monkeypatch):
    """Counts equal, sums within rtol 1e-6 (the port folds in bin order,
    the JAX package by segment sums), and every counter's maximum and
    ``batches`` equal: both mappers run at the same caps and geometry, so
    all 11 counters agree, the data-set maxima (max_hits, max_groups,
    max_s, max_span) among them.  No fragment overflows, nothing is
    redone."""
    jp, jidx, js, jm, tp, tidx, ts, tm = _setup(workdir)
    jr, tr = [], []
    jc, jsums, jst = _jax_readout(monkeypatch, jp, jidx, js, jm, 2, 3, jr)
    tc, tsums, tst = _port_readout(monkeypatch, tp, tidx, ts, tm, 2, 3, tr)
    np.testing.assert_array_equal(tc, jc)
    assert (tc > 0).sum() == 6
    np.testing.assert_allclose(tsums, jsums, rtol=1e-6)
    for key in jitmap.COUNT_NAMES + ("batches", "fallback_frags"):
        assert tst[key] == jst[key], key
    assert tst["batches"] == 3 and tst["max_hits"] > 0
    assert tst["fallback_frags"] == 0 and jr == tr == []
    assert tst["redone_queries"] == 0


def test_stream_overflow_redoes_the_jax_queries(workdir, monkeypatch):
    """At hits_cap 128, under what real fragments hit: the redo set that
    the finish rebuilds from the stacked fallback masks is the JAX
    finish's, the fallback fragments counted equal, and the final counts
    (after each package's exact redo) equal the JAX pair's, which is what
    the JAX ``run_fast`` returns; sums within rtol 1e-6."""
    jp, jidx, js, jm, tp, tidx, ts, tm = _setup(workdir, hits_cap=128)
    jr, tr = [], []
    jc, jsums, jst = _jax_readout(monkeypatch, jp, jidx, js, jm, 2, 3, jr)
    tc, tsums, tst = _port_readout(monkeypatch, tp, tidx, ts, tm, 2, 3, tr)
    assert tr == jr and len(tr) >= 1
    assert tst["fallback_frags"] == jst["fallback_frags"] > 0
    assert tst["l1_overflow"] == jst["l1_overflow"] == 1
    assert tst["redone_queries"] == len(tr)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(tsums, jsums, rtol=1e-6)


def test_map_queries_batched_matches_jax(workdir):
    """The exact path through dispatch/collect, two deep: each query
    genome's rows (qsid, sid, start, ident) as sorted tuples equal the
    JAX ``map_queries_batched``'s."""
    jp, jidx, js, jm, tp, tidx, ts, tm = _setup(workdir)
    want = jpipe.map_queries_batched(js, jidx, jp, jm)
    stats = {}
    got = pipeline.map_queries_batched(ts, pipeline.Grid.single(tidx, tm),
                                       tp, stats)
    assert stats["batches"] == 3 and stats["fallback_frags"] == 0
    assert len(got) == len(want) == 2
    keys = ("query_seq_id", "ref_seq_id", "ref_start_pos", "ident")
    for g, w in zip(got, want):
        rows = lambda m: sorted(zip(*(np.asarray(m[k]).tolist()
                                      for k in keys)))
        assert len(g["ident"]) > 40
        assert rows(g) == rows(w)


class _Reads(TorchFunctionMode):
    """Counts the calls that read a tensor to the host, by name, except
    inside the kernels' wrappers (``paused``)."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()
        self.paused = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if not self.paused and name in READS:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


def test_stream_reads_only_n_live(workdir, monkeypatch):
    """The stream's loop reads the device once a batch, the map step's
    ``n_live`` (``int`` in ``jitmap.n_chunks``), and nothing else: the
    counts, masks and rows stay on the device.  The finish then reads the
    counts stack and the two result matrices, and not the masks, since no
    batch overflowed.  Reads inside the kernels' wrappers are left out:
    on the CPU they run plain versions, on a card a kernel."""
    _, _, _, _, tp, tidx, ts, tm = _setup(workdir)
    mode = _Reads()
    for mod, name in WRAPPERS:
        fn = getattr(mod, name)

        def paused(*args, _fn=fn, **kw):
            mode.paused += 1
            try:
                return _fn(*args, **kw)
            finally:
                mode.paused -= 1

        monkeypatch.setattr(mod, name, paused)
    grid = pipeline.Grid.single(tidx, tm)
    with mode:
        h = pipeline.map_queries_cgi_stream(ts, grid, tp, 2)
    assert mode.counts == {"__int__": len(h.starts)} and len(h.starts) == 3
    mode.counts.clear()
    stats = {}
    with mode:
        pipeline.map_queries_cgi_finish(h, grid, tp, stats)
    assert mode.counts == {"cpu": 3, "numpy": 3}
    assert stats["batches"] == 3 and stats["fallback_frags"] == 0
    assert tm.graph_stats()["eager_batches"] == 3
