"""The hits_cap auto-tune of the port (``pipeline.autotune_hits_cap``,
``Mapper.probe_hits``) against the JAX package's: the same tuned cap on
the same genomes and batches, a no-op at 8192, the same map rows at the
tuned cap as at the static one, and a fragment of a batch the sample
missed that needs more than the tuned cap answered through the redo."""

import numpy as np
import pytest
import torch

from fastani_tpu_torch.config import Parameters
from fastani_tpu_torch.index.sketch import ReferenceIndex
from fastani_tpu_torch.models import jitmap, pipeline
from tests import synth

# one intra-op thread: the suite runs several xdist workers per core, and
# torch's thread pool on top of them stalls every small CPU op
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    """Two strains of a 60 kbp genome as references, the second also
    holding 24 copies of a 3 kbp block, 4 kbp apart (each copy its own
    candidate region), so one 3 kbp query fragment (rpt.fa) has ~24 x its
    sketch size of L1 hits and the others ~2x; queries: the block (one
    fragment) and two other strains (20 each)."""
    wd = tmp_path_factory.mktemp("torch_autotune")
    rng = np.random.default_rng(31)
    base = synth.random_genome(rng, 60_000)
    block = synth.random_genome(rng, 3000)
    repeats = np.concatenate([
        part for _ in range(24)
        for part in (synth.mutate_genome(rng, block, 0.01, 0.0),
                     synth.random_genome(rng, 4000))])
    synth.write_fasta(wd / "r0.fa", [("r0", synth.mutate_genome(
        rng, base, 0.02))])
    synth.write_fasta(wd / "r1.fa", [
        ("r1", synth.mutate_genome(rng, base, 0.03)), ("r1_rep", repeats)])
    synth.write_fasta(wd / "rpt.fa", [("rpt", synth.mutate_genome(
        rng, block, 0.01, 0.0))])
    for i in range(2):
        synth.write_fasta(wd / f"q{i}.fa", [(f"q{i}", synth.mutate_genome(
            rng, base, 0.01 * (i + 1)))])
    return wd


def _files(wd, names):
    return [str(wd / n) for n in names]


def _port_mapper(wd, queries, hits_cap):
    params = Parameters(ref_sequences=_files(wd, ["r0.fa", "r1.fa"]),
                        query_sequences=_files(wd, queries), frag_batch=3,
                        hits_cap=hits_cap).finalize()
    index = ReferenceIndex.build_device(params, device="cpu")
    stream = pipeline.FragmentStream(params.query_sequences, params)
    return params, jitmap.Mapper(params, index, unit_factor=16), stream


@pytest.mark.parametrize("static", [16384, 8192])
def test_tuned_cap_matches_jax(genomes, static):
    """The repeat fragment sits in the first batch, which both samples
    hold: at 16384 both packages tune to the same cap (above the 4096
    floor); at 8192 both leave it (the no-op)."""
    from fastani_tpu.config import Parameters as JParams
    from fastani_tpu.index.sketch import ReferenceIndex as JIndex
    from fastani_tpu.models import jitmap as jjitmap
    from fastani_tpu.models import pipeline as jpipe

    queries = ["rpt.fa", "q0.fa", "q1.fa"]
    params, mapper, stream = _port_mapper(genomes, queries, static)
    tuned = pipeline.autotune_hits_cap(mapper, stream, params)

    jparams = JParams(ref_sequences=_files(genomes, ["r0.fa", "r1.fa"]),
                      query_sequences=_files(genomes, queries),
                      frag_batch=3, hits_cap=static).finalize()
    jmapper = jjitmap.JitMapper(jparams, JIndex.build(jparams))
    want = jpipe.autotune_hits_cap(
        jmapper, jpipe.FragmentStream(jparams.query_sequences, jparams),
        jparams)
    assert tuned.cfg.hits_cap == params.hits_cap == want
    if static == 16384:
        assert 4096 < want < static
    else:
        assert want == static and tuned is mapper


def test_rows_at_tuned_cap_equal_static(genomes):
    params, mapper, stream = _port_mapper(genomes, ["rpt.fa", "q0.fa"],
                                          16384)
    tuned = pipeline.autotune_hits_cap(mapper, stream, params)
    assert tuned.cfg.hits_cap < mapper.cfg.hits_cap
    for b0 in range(0, stream.F, params.frag_batch):
        frags = torch.as_tensor(stream.make_batch(b0, params.frag_batch)[0])
        a, b = (jitmap.map_step_packed(m.cfg, frags, m.tables)
                for m in (mapper, tuned))
        ca, cb = a["counts"].tolist(), b["counts"].tolist()
        assert ca == cb and not jitmap.overflowed(
            dict(zip(jitmap.COUNT_NAMES, cb)))
        assert torch.equal(a["packed"][:, :ca[0]], b["packed"][:, :cb[0]])


def test_unsampled_batch_over_tuned_cap_takes_the_redo(genomes, tmp_path,
                                                       monkeypatch):
    """The repeat fragment comes last, in batch 13 of 14, and the 12
    samples are batches 0-11: the cap tunes to 4096, that fragment goes
    over it, and its query genome is redone.  The TSV is the one of the
    run at the static cap, where nothing overflows."""
    orig = pipeline.scale_caps

    def scale_caps(G, params):
        orig(G, params)
        params.hits_cap = 16384

    monkeypatch.setattr(pipeline, "scale_caps", scale_caps)

    def run(tag):
        stats = {}
        out = str(tmp_path / f"{tag}.txt")
        pipeline.run_fast(Parameters(
            ref_sequences=_files(genomes, ["r0.fa", "r1.fa"]),
            query_sequences=_files(genomes, ["q0.fa", "q1.fa", "rpt.fa"]),
            frag_batch=3, out_file_name=out), device="cpu",
            log=lambda m: None, stats=stats)
        return open(out).read(), stats

    tuned, st = run("tuned")
    assert st["hits_cap_static"] == 16384 and st["hits_cap"] == 4096
    assert st["max_hits"] > 4096 and st["fallback_frags"] == 1
    assert st["redone_queries"] == 1
    monkeypatch.setattr(pipeline, "autotune_hits_cap",
                        lambda mapper, stream, params: mapper)
    static, st0 = run("static")
    assert st0["hits_cap"] == 16384 and st0["fallback_frags"] == 0
    assert tuned == static and tuned.count("\n") == 5
