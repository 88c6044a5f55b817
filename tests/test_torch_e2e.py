"""The port's fast path end to end on the CPU: against the frozen goldens
(rows and counts equal, ANI within 0.1) and against the JAX package's
``run_fast`` (rows and counts equal, ANI within 1e-3 — only the float32
summation order differs)."""

import os
import pathlib

import numpy as np
import pytest
import torch

from fastani_tpu_torch import cli
from fastani_tpu_torch.config import Parameters
from fastani_tpu_torch.models import glue, pipeline
from tests import synth

# one intra-op thread: the suite runs several xdist workers per core, and
# torch's thread pool on top of them stalls every small CPU op
torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "golden"


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """tests/test_golden_frozen.py's fixtures (seed 2024)."""
    wd = tmp_path_factory.mktemp("torch_golden")
    rng = np.random.default_rng(2024)
    base = synth.random_genome(rng, 150_000)
    strain_a = synth.mutate_genome(rng, base, sub_rate=0.02, indel_rate=0.0003)
    strain_b = synth.mutate_genome(rng, base, sub_rate=0.05, indel_rate=0.0005)
    multi = [
        ("m_ctg1", synth.mutate_genome(rng, base[:80_000], 0.01)),
        ("m_short", synth.random_genome(rng, 800)),
        ("m_ctg2", synth.mutate_genome(rng, base[80_000:], 0.03)),
    ]
    synth.write_fasta(wd / "base.fa", [("base_ctg", base)])
    synth.write_fasta(wd / "strainA.fa", [("sA_ctg", strain_a)])
    synth.write_fasta(wd / "strainB.fa", [("sB_ctg", strain_b)])
    synth.write_fasta(wd / "multi.fa", multi)
    (wd / "refs.txt").write_text("strainA.fa\nstrainB.fa\n")
    return wd


def _rows(path):
    return {tuple(ln.split("\t")[:2]): ln.split("\t")[2:]
            for ln in open(path).read().split("\n") if ln}


@pytest.mark.parametrize("args,golden", [
    (["-q", "base.fa", "-r", "strainA.fa"], "one2one.txt"),
    (["-q", "multi.fa", "--rl", "refs.txt"], "multi.txt"),
])
def test_cli_cpu_matches_frozen_golden(workdir, args, golden):
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        out = f"t_{golden}"
        assert cli.main(args + ["-o", out, "--device", "cpu"]) == 0
        got, want = _rows(out), _rows(GOLDEN / golden)
    finally:
        os.chdir(cwd)
    assert set(got) == set(want)
    for key, (ani, mapped, total) in want.items():
        assert got[key][1:] == [mapped, total], key
        assert abs(float(got[key][0]) - float(ani)) <= 0.1, key


def test_run_fast_cpu_matches_jax_run_fast(workdir):
    from fastani_tpu.config import Parameters as JParams
    from fastani_tpu.models import pipeline as jpipe

    q = [str(workdir / "multi.fa"), str(workdir / "base.fa")]
    r = [str(workdir / "strainA.fa"), str(workdir / "strainB.fa"),
         str(workdir / "base.fa")]
    want = jpipe.run_fast(JParams(query_sequences=q, ref_sequences=r,
                                  frag_batch=64), log=lambda m: None)
    stats = {}
    got = pipeline.run_fast(Parameters(query_sequences=q, ref_sequences=r,
                                       frag_batch=64), device="cpu",
                            log=lambda m: None, stats=stats)
    key = lambda e: (e.qry_genome, e.ref_genome)
    want = {key(e): e for e in want}
    got = {key(e): e for e in got}
    assert set(got) == set(want) and len(got) == 6
    for k, e in want.items():
        g = got[k]
        assert (g.count_seq, g.total_query_fragments) == \
            (e.count_seq, e.total_query_fragments), k
        assert abs(float(g.identity) - float(e.identity)) <= 1e-3, k
    assert stats["fallback_frags"] == 0 and stats["batches"] == 2


def _by_pair(rows):
    return {(e.qry_genome, e.ref_genome): e for e in rows}


def test_run_fast_redo_matches_jax_run_fast(workdir, monkeypatch):
    """l2_entry_cap 128 under the ~480 entries a clean mapping spans: every
    mapped fragment overflows L2, and its query genome is redone exactly
    (the JAX package's through its numpy fallback, the port's through its
    own map step at grown caps)."""
    from fastani_tpu.config import Parameters as JParams
    from fastani_tpu.models import device_cgi as jcgi
    from fastani_tpu.models import pipeline as jpipe

    # the JAX redo writes into the readout arrays, which np.asarray of a
    # JAX array on the CPU makes read-only: read them out as copies
    monkeypatch.setattr(jcgi.StreamingCGI, "result", lambda self: (
        np.array(self._counts), np.array(self._sums)))

    q = [str(workdir / "base.fa")]
    r = [str(workdir / "strainA.fa"), str(workdir / "strainB.fa")]
    want = jpipe.run_fast(JParams(query_sequences=q, ref_sequences=r,
                                  frag_batch=64, l2_entry_cap=128),
                          log=lambda m: None)
    stats = {}
    got = pipeline.run_fast(Parameters(query_sequences=q, ref_sequences=r,
                                       frag_batch=64, l2_entry_cap=128),
                            device="cpu", log=lambda m: None, stats=stats)
    want, got = _by_pair(want), _by_pair(got)
    assert set(got) == set(want) and len(got) == 2
    for k, e in want.items():
        g = got[k]
        assert (g.count_seq, g.total_query_fragments) == \
            (e.count_seq, e.total_query_fragments), k
        assert abs(float(g.identity) - float(e.identity)) <= 1e-3, k
    assert stats["fallback_frags"] > 0 and stats["redone_queries"] == 1


@pytest.mark.parametrize("caps", [dict(sketch_cap=64),
                                  dict(l2_entry_cap=128, hits_cap=64)],
                         ids=["sketch_cap64", "l2_entry_cap128-hits_cap64"])
def test_map_queries_redo_matches_uncapped(workdir, caps):
    """The stream with caps that real fragments overflow (so their genomes
    are redone at grown caps) against the same call at caps that hold:
    counts equal, sums within rtol 1e-6 (the device CGI's float32 sums and
    the host fold's mean x count differ in the last bits)."""
    from fastani_tpu_torch.index.sketch import ReferenceIndex
    from fastani_tpu_torch.models import jitmap

    q = [str(workdir / "multi.fa"), str(workdir / "base.fa")]
    r = [str(workdir / "strainA.fa"), str(workdir / "strainB.fa")]

    def run(**kw):
        params = Parameters(query_sequences=q, ref_sequences=r,
                            frag_batch=64, **kw).finalize()
        index = ReferenceIndex.build_device(params, device="cpu")
        stream = pipeline.FragmentStream(params.query_sequences, params)
        stats = {}
        out = pipeline.map_queries_cgi_device(
            stream, pipeline.Grid.single(index, jitmap.Mapper(params, index)),
            params, 2, stats=stats)
        return out, stats

    (c0, s0), st0 = run()
    (c1, s1), st1 = run(**caps)
    assert st0["fallback_frags"] == 0 and st1["fallback_frags"] > 0
    assert st1["redone_queries"] == 2
    assert (c0 > 0).sum() == 4
    np.testing.assert_array_equal(c1, c0)
    np.testing.assert_allclose(s1, s0, rtol=1e-6)


@pytest.mark.parametrize("over,limit,clamped", [
    (dict(max_span=1100, l2_overflow=1), "limit of 1022 of the L2 event",
     dict(l2_entry_cap=1022)),
    (dict(max_s=1100, sk_overflow=1), "limit of 1023 of the L2 event",
     dict(sketch_cap=1023)),
    (dict(max_hits=40000, l1_overflow=1), "limit of 32768 of the K3 row",
     dict(hits_cap=32768)),
    (dict(max_span=700, l2_overflow=1, max_groups=130, l1_overflow=1,
          n_units=5000, unit_overflow=1), None, None)],
    ids=["l2_entry_cap", "sketch_cap", "hits_cap", "grow"])
def test_redo_caps_grow_to_counters_or_raise_at_kernel_limits(over, limit,
                                                              clamped):
    """The redo's caps hold what the counters saw, rounded up to the
    kernels' steps; past a kernel's width limit CapOverflowError names
    the cap, the need and the limit, and carries the growth clamped to
    the limit (what the caller maps with before the scalar oracle)."""
    from fastani_tpu_torch.models import jitmap

    cfg = jitmap.MapperConfig(
        kmer_size=16, window_size=24, frag_len=3000, sketch_cap=320,
        hits_cap=8192, cand_cap=128, l2_entry_cap=128, unit_cap=4096,
        unit_chunk=512, freq_threshold=1 << 30, wpos_bits=None)
    c = dict.fromkeys(jitmap.COUNT_NAMES, 0)
    c.update(max_s=250, max_hits=4000, max_groups=50, max_span=100,
             n_units=1000)
    c.update(over)
    if limit is not None:
        with pytest.raises(glue.CapOverflowError, match=limit) as err:
            glue._grown_caps(cfg, c)
        assert err.value.caps == clamped
    else:
        assert glue._grown_caps(cfg, c) == dict(
            cand_cap=192, l2_entry_cap=768, unit_cap=5120)
