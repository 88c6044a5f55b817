"""The port's exact path (``pipeline.run``: ``--exact``, ``--visualize``,
``-s``) on the CPU: byte-equal to the frozen goldens and to the JAX
package's ``run``, the repeat sanity check, the scalar oracle against the
JAX one, and fragments over caps (grown on the device, or past a kernel's
limit sent to the oracle) giving the bytes of the uncapped run."""

import dataclasses
import os
import pathlib

import numpy as np
import pytest
import torch

from fastani_tpu_torch import cli
from fastani_tpu_torch.config import Parameters, scale_caps
from fastani_tpu_torch.index.sketch import ReferenceIndex
from fastani_tpu_torch.models import ani, glue, jitmap, pipeline
from fastani_tpu_torch.utils import refmodel
from tests import synth

# one intra-op thread: the suite runs several xdist workers per core, and
# torch's thread pool on top of them stalls every small CPU op
torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "golden"


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """tests/test_e2e_oracle.py's fixtures (seed 2024; the first four are
    those of the frozen goldens), plus the repeat pair of its sanity-check
    case."""
    wd = tmp_path_factory.mktemp("torch_exact")
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
    synth.write_fasta(wd / "shortfirst.fa", [
        ("sf_tiny", synth.random_genome(rng, 500)),
        ("sf_big", synth.mutate_genome(rng, base[:90_000], 0.02)),
    ])
    synth.write_fasta(wd / "shortlast.fa", [
        ("sl_big", synth.mutate_genome(rng, base[:90_000], 0.02)),
        ("sl_tiny", synth.random_genome(rng, 500)),
    ])
    (wd / "refs.txt").write_text("strainA.fa\nstrainB.fa\n")
    # pure-A query against an 8A+1T repeat reference
    rpt = lambda unit: np.frombuffer(
        (unit * (300_000 // len(unit) + 1))[:300_000], np.uint8).copy()
    synth.write_fasta(wd / "rpt_q.fa", [("q", rpt(b"A" * 32))])
    synth.write_fasta(wd / "rpt_r.fa", [("r", rpt(b"A" * 8 + b"T"))])
    return wd


def _sorted_lines(path):
    return sorted(open(path).read().splitlines())


def _cli(wd, args):
    cwd = os.getcwd()
    os.chdir(wd)
    try:
        assert cli.main(args + ["--device", "cpu"]) == 0
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("args,golden", [
    (["-q", "base.fa", "-r", "strainA.fa"], "one2one.txt"),
    (["-q", "multi.fa", "--rl", "refs.txt"], "multi.txt"),
])
def test_cli_exact_matches_frozen_golden(workdir, args, golden):
    out = f"x_{golden}"
    _cli(workdir, args + ["-o", out, "--exact", "--visualize", "--matrix"])
    for suf in ("", ".matrix", ".visual"):
        assert _sorted_lines(workdir / (out + suf)) == \
            _sorted_lines(GOLDEN / (golden + suf)), suf


@pytest.mark.parametrize("name", ["multi.fa", "shortfirst.fa", "shortlast.fa"])
def test_query_fragments_match_jax(workdir, name):
    """Fragments, querySeqIds and .visual metadata: a short contig adds a
    metadata entry and no fragment."""
    from fastani_tpu.config import Parameters as JParams
    from fastani_tpu.models import pipeline as jpipe

    want = jpipe.load_query_fragments(str(workdir / name), JParams().finalize())
    got = pipeline.load_query_fragments(str(workdir / name),
                                        Parameters().finalize())
    np.testing.assert_array_equal(got.frags, want.frags)
    np.testing.assert_array_equal(got.frag_ids, want.frag_ids)
    np.testing.assert_array_equal(got.vis_offsets, want.vis_offsets)
    assert got.total_fragments == want.total_fragments
    assert len(got.vis_offsets) == len(got.frags) + 1


@pytest.mark.parametrize("query", ["shortfirst.fa", "shortlast.fa"])
def test_visual_offsets_match_jax_run(workdir, query):
    """The reference's .visual offset quirk (tests/test_e2e_oracle.py:164):
    query offsets indexed by querySeqId while a short contig before the
    mapped one adds a metadata entry; TSV and .visual byte-equal to the
    JAX package's exact run."""
    from fastani_tpu.config import Parameters as JParams
    from fastani_tpu.models import pipeline as jpipe

    q, r = [str(workdir / query)], [str(workdir / "strainA.fa")]
    outs = {}
    for tag, P, run in (
            ("jax", JParams, lambda p: jpipe.run(p, backend="numpy",
                                                 log=lambda m: None)),
            ("torch", Parameters, lambda p: pipeline.run(
                p, device="cpu", log=lambda m: None))):
        out = str(workdir / f"vis_{tag}_{query}.txt")
        run(P(query_sequences=q, ref_sequences=r, visualize=True,
              out_file_name=out))
        outs[tag] = [open(out + suf).read() for suf in ("", ".visual")]
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][1].count("\n") > 20


def test_sanity_check_repeat_zero_rows(workdir):
    """-s on the repeat pair (tests/test_e2e_oracle.py:116): the reference
    fails the check, nothing is mapped, the TSV and .matrix are written
    empty of rows."""
    _cli(workdir, ["-q", "rpt_q.fa", "-r", "rpt_r.fa", "-o", "rpt.txt", "-s",
                   "--matrix"])
    assert (workdir / "rpt.txt").read_text() == ""
    assert (workdir / "rpt.txt.matrix").read_text().startswith("2\n")


@pytest.mark.parametrize("ref", ["rpt_r.fa", "strainA.fa"])
def test_sanity_ratios_match_jax(workdir, ref):
    """hash_ratio, uniq_hash_ratio and ratio_difference bit-equal to the
    JAX sanity_check's (float32), and the same verdict."""
    from fastani_tpu.config import Parameters as JParams
    from fastani_tpu.index.sketch import ReferenceIndex as JIndex

    want = JIndex.build(JParams(ref_sequences=[str(workdir / ref)]).finalize())
    got = ReferenceIndex.build_device(
        Parameters(ref_sequences=[str(workdir / ref)]).finalize(), device="cpu")
    assert got.sanity_check(100.0) == want.sanity_check(100.0) == \
        (ref == "strainA.fa")
    assert got.num_unique_hashes() == want.num_unique_hashes
    for field in ("hash_ratio", "uniq_hash_ratio", "ratio_difference"):
        g, w = getattr(got, field), getattr(want, field)
        assert type(g) is type(w) and np.float32(g) == np.float32(w), field


@pytest.fixture(scope="module")
def oracle_case(tmp_path_factory):
    """A reference of a random contig and a tandem-repeat contig (40
    near-identical copies of a 700 bp unit), indexed by the JAX host build
    and by the port (``host_view``), and four fragments."""
    from fastani_tpu.config import Parameters as JParams
    from fastani_tpu.index.sketch import ReferenceIndex as JIndex

    wd = tmp_path_factory.mktemp("torch_oracle")
    rng = np.random.default_rng(77)
    ctg = synth.random_genome(rng, 60_000)
    unit = synth.random_genome(rng, 700)
    tandem = np.concatenate([synth.mutate_genome(rng, unit, 0.01, 0.0)
                             for _ in range(40)])
    synth.write_fasta(wd / "ref.fa", [("ctg", ctg), ("rep", tandem)])
    clean = synth.mutate_genome(rng, ctg[20_000:23_000], 0.02, 0.0)
    with_n = clean.copy()
    with_n[1000:1400] = ord("N")
    frags = {"clean": clean,
             "tandem": synth.mutate_genome(rng, tandem[5000:8000], 0.01, 0.0),
             "with_n": with_n,
             "nowhere": synth.random_genome(rng, 3000)}
    jp = JParams(ref_sequences=[str(wd / "ref.fa")]).finalize()
    tp = Parameters(ref_sequences=[str(wd / "ref.fa")]).finalize()
    return (frags, (JIndex.build(jp), jp),
            (ReferenceIndex.build_device(tp, device="cpu").host_view(), tp))


def test_host_view_matches_jax_index(oracle_case):
    _, (jidx, _), (host, _) = oracle_case
    for name in ("mi_hash", "mi_seqid", "mi_wpos", "occ_hash", "occ_seqid",
                 "occ_wpos"):
        np.testing.assert_array_equal(getattr(host, name).astype(np.int64),
                                      getattr(jidx, name).astype(np.int64))
    assert host.num_entries == jidx.num_entries
    assert host.freq_threshold == jidx.freq_threshold


@pytest.mark.parametrize("name", ["clean", "tandem", "with_n", "nowhere"])
def test_refmodel_matches_jax_refmodel(oracle_case, name):
    """Mapping records equal field for field, identities bit-equal."""
    from fastani_tpu.utils import refmodel as jrefmodel

    frags, (jidx, jp), (host, tp) = oracle_case
    want = jrefmodel.map_fragment(frags[name], jidx, jp, 7)
    got = refmodel.map_fragment(frags[name], host, tp, 7)
    assert [dataclasses.astuple(m) for m in got] == \
        [dataclasses.astuple(m) for m in want]
    for g, w in zip(got, want):
        assert g.nuc_identity.tobytes() == np.float32(w.nuc_identity).tobytes()
    assert (len(got) == 0) == (name == "nowhere")


def _exact_run(wd, tag, **kw):
    """``run`` on multi.fa and base.fa against both strains, with the
    .visual and .matrix; returns (the three files' bytes, stats)."""
    out = str(wd / f"cap_{tag}.txt")
    stats = {}
    pipeline.run(Parameters(query_sequences=[str(wd / "multi.fa"),
                                             str(wd / "base.fa")],
                            ref_sequences=[str(wd / "strainA.fa"),
                                           str(wd / "strainB.fa")],
                            frag_batch=64, visualize=True, matrix_output=True,
                            out_file_name=out, **kw),
                 device="cpu", log=lambda m: None, stats=stats)
    return [open(out + suf, "rb").read() for suf in ("", ".matrix",
                                                     ".visual")], stats


@pytest.fixture(scope="module")
def uncapped(workdir):
    files, stats = _exact_run(workdir, "none")
    assert stats["fallback_frags"] == 0 and files[2].count(b"\n") > 90
    return files


# the L2 span limit patched down to 730 entries: the 14 of these 99
# fragments whose span passes it reach the scalar oracle
_L2_LIMIT = 730


@pytest.mark.parametrize("caps,limit", [
    (dict(sketch_cap=64), None),
    (dict(l2_entry_cap=128, hits_cap=64), None),
    (dict(l2_entry_cap=128), _L2_LIMIT)],
    ids=["sketch_cap64", "l2_entry_cap128-hits_cap64", "l2_limit730"])
def test_exact_capped_matches_uncapped(workdir, uncapped, monkeypatch, caps,
                                       limit):
    """Caps that real fragments overflow: their rows come from the map step
    at grown caps or, past a (patched) kernel limit, from the scalar
    oracle; the TSV, .matrix and .visual bytes are the uncapped run's."""
    def capped_scale_caps(n, params):
        scale_caps(n, params)
        for key, v in caps.items():
            setattr(params, key, v)

    monkeypatch.setattr(pipeline, "scale_caps", capped_scale_caps)
    if limit is not None:
        counter, step, _, holder = glue._CAPS["l2_entry_cap"]
        monkeypatch.setitem(glue._CAPS, "l2_entry_cap",
                            (counter, step, limit, holder))
    files, stats = _exact_run(workdir, "_".join(map(str, caps.values())))
    assert files == uncapped
    assert stats["fallback_frags"] > 0
    assert (stats["oracle_frags"] > 0) == (limit is not None)


def test_run_fast_answers_past_kernel_limits(workdir, monkeypatch):
    """run_fast with the L2 span limit patched down: the redo sends the
    fragments past it to the oracle instead of raising; counts equal to
    the uncapped run's, ANI within 1e-3."""
    q = [str(workdir / "multi.fa"), str(workdir / "base.fa")]
    r = [str(workdir / "strainA.fa"), str(workdir / "strainB.fa")]

    def run_fast(**kw):
        stats = {}
        rows = pipeline.run_fast(Parameters(query_sequences=q, ref_sequences=r,
                                            frag_batch=64, **kw),
                                 device="cpu", log=lambda m: None, stats=stats)
        return {(e.qry_genome, e.ref_genome): e for e in rows}, stats

    want, _ = run_fast()
    counter, step, _, holder = glue._CAPS["l2_entry_cap"]
    monkeypatch.setitem(glue._CAPS, "l2_entry_cap",
                        (counter, step, _L2_LIMIT, holder))
    got, stats = run_fast(l2_entry_cap=128)
    assert stats["redone_queries"] == 2 and stats["oracle_frags"] > 0
    assert set(got) == set(want) and len(got) == 4
    for k, e in want.items():
        assert (got[k].count_seq, got[k].total_query_fragments) == \
            (e.count_seq, e.total_query_fragments), k
        assert abs(float(got[k].identity) - float(e.identity)) <= 1e-3, k


def test_compute_cgi_arrays_ignores_row_order(workdir):
    """The device packs rows in its own order: the fold's 1-way and 2-way
    choices and its float32 sums do not depend on it."""
    params = Parameters(query_sequences=[str(workdir / "multi.fa")],
                        ref_sequences=[str(workdir / "strainA.fa"),
                                       str(workdir / "strainB.fa")],
                        frag_batch=64).finalize()
    index = ReferenceIndex.build_device(params, device="cpu")
    stream = pipeline.FragmentStream(params.query_sequences, params)
    (m,) = pipeline.map_queries_batched(
        stream, pipeline.Grid.single(index, jitmap.job_mapper(
            params, index, len(params.ref_sequences), params.frag_batch)),
        params)
    cols = [m[k] for k in ("ref_seq_id", "query_seq_id", "ref_start_pos",
                           "ident")]
    fold = lambda c: ani.compute_cgi_arrays(
        *c, index.genome_of_seq(), params.frag_len, 0,
        stream.total_fragments(0))
    want = fold(cols)
    assert len(want[0]) == 2 and len(want[1]) > 50
    rng = np.random.default_rng(5)
    for _ in range(3):
        perm = rng.permutation(len(cols[0]))
        assert fold([c[perm] for c in cols]) == want
