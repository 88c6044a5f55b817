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
from fastani_tpu_torch.models import pipeline
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


def test_cap_overflow_of_a_real_fragment_raises(workdir):
    """A real fragment over a cap raises, naming the cap and the observed
    value (the exact redo is not ported): sketch_cap 64 < ~240 minimizers."""
    from fastani_tpu_torch.index.sketch import ReferenceIndex
    from fastani_tpu_torch.models import jitmap

    params = Parameters(query_sequences=[str(workdir / "base.fa")],
                        ref_sequences=[str(workdir / "strainA.fa")],
                        sketch_cap=64).finalize()
    index = ReferenceIndex.build_device(params, device="cpu")
    stream = pipeline.FragmentStream(params.query_sequences, params)
    with pytest.raises(pipeline.CapOverflowError,
                       match=r"50 real fragment.*sketch_cap=64 \(max unique "
                             r"minimizers per fragment 2\d\d\)"):
        pipeline.map_queries_cgi_device(stream, index, params,
                                        jitmap.Mapper(params, index), 1, 1)
