"""The port's sharded runner (``parallel/runner.py``; ``--mesh``,
``--coordinator``) on the CPU against the JAX package's and against the
port's single-device paths: the fast path's counts and ANI, the exact
path's bytes, the per-shard sanity check, per-shard index files both
ways, and a run over two gloo processes, which reads only its own shards'
reference files.  Small batches (``frag_batch`` 8) split each query
genome's fragments over the q cells, so the q-merge of the device CGI
decides the fast path's counts.  The per-query sharded step
(``mesh.make_sharded_step``) against the JAX package's on its 8-device CPU
mesh (tests/conftest.py)."""

import contextlib
import io
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from fastani_tpu_torch import cli
from fastani_tpu_torch.config import Parameters
from fastani_tpu_torch.io import fasta
from fastani_tpu_torch.models import glue, pipeline
from fastani_tpu_torch.parallel import distributed, mesh as pmesh, runner
from tests import synth

# one intra-op thread: the suite runs several xdist workers per core, and
# torch's thread pool on top of them stalls every small CPU op
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """tests/test_mesh.py's fixtures (seed 5): 4 x 24 kbp references, one
    query; the queries are it and reference 1."""
    wd = tmp_path_factory.mktemp("torch_mesh")
    rng = np.random.default_rng(5)
    base = synth.random_genome(rng, 24_000)
    refs = []
    for i in range(4):
        path = str(wd / f"ref{i}.fa")
        synth.write_fasta(path, [(f"r{i}", synth.mutate_genome(
            rng, base, 0.01 + 0.02 * i))])
        refs.append(path)
    synth.write_fasta(wd / "query.fa", [("q0", synth.mutate_genome(
        rng, base, 0.02))])
    (wd / "refs.txt").write_text("\n".join(refs) + "\n")
    return wd, refs, [str(wd / "query.fa"), refs[1]]


def _params(refs, queries, **kw):
    return Parameters(frag_len=1000, frag_batch=8, ref_sequences=list(refs),
                      query_sequences=list(queries), **kw)


def _matrices(rows, n_q, n_r):
    c = np.zeros((n_q, n_r), np.int64)
    a = np.zeros((n_q, n_r), np.float64)
    for e in rows:
        c[e.qry_genome, e.ref_genome] = e.count_seq
        a[e.qry_genome, e.ref_genome] = float(e.identity)
    return c, a


@pytest.mark.parametrize("n_r,n_q", [(1, 1), (2, 2), (2, 4)])
def test_fused_mesh_matches_jax_and_single_device(world, n_r, n_q):
    """Counts equal to the JAX run_sharded_fused's and to the port's
    run_fast, ANI within 1e-3 of both."""
    from fastani_tpu.config import Parameters as JParams
    from fastani_tpu.parallel import runner as jrunner

    _, refs, queries = world
    stats = {}
    got = _matrices(runner.run_sharded_fused(
        _params(refs, queries), n_r, n_q, device="cpu", stats=stats,
        log=lambda m: None), 2, 4)
    single = _matrices(pipeline.run_fast(_params(refs, queries),
                                         device="cpu", log=lambda m: None),
                       2, 4)
    jax = _matrices(jrunner.run_sharded_fused(
        JParams(frag_len=1000, frag_batch=8, ref_sequences=list(refs),
                query_sequences=list(queries)), n_r, n_q,
        log=lambda m: None), 2, 4)
    for want in (single, jax):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], atol=1e-3)
    assert (got[0] > 0).sum() == 8
    assert stats["fallback_frags"] == 0 and stats["batches"] == 6


def _read(out, suffixes=("", ".matrix", ".visual")):
    return [open(out + suf).read() for suf in suffixes]


def test_exact_mesh_cli_byte_equal(world, tmp_path):
    """--mesh 2x4 --exact --matrix -s --visualize: TSV, .matrix and .visual
    byte-equal to the port's single-device run and to the JAX CLI's
    --mesh 2x4 run."""
    from fastani_tpu import cli as jcli

    wd, _, _ = world
    args = ["-q", str(wd / "query.fa"), "--rl", str(wd / "refs.txt"),
            "--fragLen", "1000", "--exact", "--matrix", "-s", "--visualize"]
    outs = {k: str(tmp_path / f"{k}.txt") for k in ("single", "mesh", "jax")}
    assert cli.main(args + ["-o", outs["single"], "--device", "cpu"]) == 0
    assert cli.main(args + ["-o", outs["mesh"], "--mesh", "2x4",
                            "--device", "cpu"]) == 0
    jargs = [a for a in args if a != "--exact"]
    assert jcli.main(jargs + ["-o", outs["jax"], "--mesh", "2x4"]) == 0
    want = _read(outs["single"])
    assert want[2].strip() and want[0].count("\n") == 4
    assert _read(outs["mesh"]) == want
    assert _read(outs["jax"]) == want


@pytest.mark.parametrize("n_r,n_q", [(2, 4), (3, 3)])
def test_exact_mesh_split_batches_byte_equal(world, tmp_path, n_r, n_q):
    """run_sharded at frag_batch 8, each batch split over the q cells and
    the genomes over 2 or 3 shards (one of them with two files): the three
    files equal pipeline.run's."""
    _, refs, queries = world
    files = {}
    for tag in ("single", "mesh"):
        p = _params(refs, queries, visualize=True, matrix_output=True,
                    sanity_check=True, out_file_name=str(tmp_path / tag))
        if tag == "single":
            pipeline.run(p, device="cpu", log=lambda m: None)
        else:
            runner.run_sharded(p, n_r, n_q, device="cpu", log=lambda m: None)
        files[tag] = _read(p.out_file_name)
    assert files["mesh"] == files["single"]
    assert files["single"][0].count("\n") == 8


def test_mesh_sanity_rejects_repeats(world, tmp_path):
    """A repeat-degenerate shard (no valid k-mer: its ratio difference is
    nan) is flagged and adds no row (the reference skips the failing
    split's map loop); the other shard maps."""
    wd, refs, _ = world
    bad = str(tmp_path / "bad.fa")
    synth.write_fasta(bad, [("bad", np.frombuffer(b"AT" * 6000,
                                                  np.uint8).copy())])
    lst = tmp_path / "refs.txt"
    lst.write_text("\n".join([refs[0], bad, refs[2], bad]) + "\n")
    out = str(tmp_path / "mesh_s.txt")
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        assert cli.main(["-q", str(wd / "query.fa"), "--rl", str(lst),
                         "--fragLen", "1000", "-s", "-o", out, "--mesh",
                         "2x4", "--device", "cpu"]) == 0
    msgs = buf.getvalue()
    assert "SPLIT 1" in msgs and "exceeds maximum thresholds" in msgs
    assert "SPLIT 0" not in msgs
    rows = [ln.split("\t") for ln in open(out).read().splitlines()]
    assert len(rows) == 2 and all(r[1] != bad for r in rows)


def test_mesh_index_persist_roundtrip(world, tmp_path):
    """--mesh 2x4 --saveIndex writes PREFIX.r0of2.npz and PREFIX.r1of2.npz;
    --loadIndex of them without --rl, and of the JAX package's shard files
    of the same references, gives the TSV of the building run."""
    from fastani_tpu.config import Parameters as JParams
    from fastani_tpu.parallel import mesh as jmesh

    wd, refs, _ = world
    prefix, jprefix = str(tmp_path / "port"), str(tmp_path / "jax")
    base = ["-q", str(wd / "query.fa"), "--fragLen", "1000", "--mesh", "2x4",
            "--device", "cpu"]
    built = str(tmp_path / "built.txt")
    assert cli.main(base + ["--rl", str(wd / "refs.txt"), "-o", built,
                            "--saveIndex", prefix]) == 0
    assert all(os.path.exists(f"{prefix}.r{r}of2.npz") for r in (0, 1))
    jmesh.build_shards(JParams(frag_len=1000, ref_sequences=refs).finalize(),
                       refs, 2, save_prefix=jprefix)
    for tag, pre in (("port", prefix), ("jax", jprefix)):
        out = str(tmp_path / f"loaded_{tag}.txt")
        assert cli.main(base + ["-o", out, "--loadIndex", pre]) == 0
        assert open(out).read() == open(built).read(), tag
    assert open(built).read().count("\n") == 4


_PROCESS_SCRIPT = r"""
import sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, {repo!r})
from fastani_tpu_torch.config import Parameters
from fastani_tpu_torch.parallel import runner
p = Parameters(frag_len=1000, frag_batch=8, ref_sequences={refs!r},
               query_sequences={queries!r}, out_file_name={out!r},
               matrix_output=True, visualize={exact!r}, sanity_check={exact!r},
               save_index={prefix!r})
run = runner.run_sharded if {exact!r} else runner.run_sharded_fused
run(p, 3, 3, coordinator={coord!r}, num_processes=2,
    process_id=int(sys.argv[1]), device="cpu")
"""


@pytest.mark.parametrize("exact", [False, True], ids=["fast", "exact"])
def test_two_gloo_processes_match_one(world, tmp_path, tmp_path_factory,
                                      exact):
    """A 3x3 run over two gloo processes (process 0 runs cells (0, *) and
    (1, 0-1), process 1 runs (1, 2) and (2, *): shard 1's q-merge crosses
    the processes) writes the bytes of the one-process run.  Both
    processes build shard 1, and only process 0 saves it (--saveIndex);
    the one-process run loads the three shard files the two wrote.
    Process 1 never parses a reference file of shard 0 (files 0 and 3),
    which it does not run (tests/test_multihost.py's check of the JAX
    runner; process 0 reads every file for the output writers)."""
    _, refs, queries = world
    traces = [str(tmp_path_factory.mktemp("reads") / f"p{i}.log")
              for i in range(2)]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    out2, prefix = str(tmp_path / "two.txt"), str(tmp_path / "ix")
    code = _PROCESS_SCRIPT.format(repo=REPO, refs=refs, queries=queries,
                                  out=out2, exact=exact, coord=coord,
                                  prefix=prefix)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(i)],
                              env=dict(env, FASTANI_TRACE_READS=traces[i]),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for i in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-3000:]
    assert "backend gloo" in outs[0][1].decode()
    saved = [f"{prefix}.r{r}of3.npz" for r in range(3)]
    assert all(os.path.exists(f) for f in saved)
    assert sorted(os.listdir(tmp_path)) == sorted(
        [os.path.basename(f) for f in saved] + [
            os.path.basename(out2 + suf) for suf in
            (("", ".matrix", ".visual") if exact else ("", ".matrix"))])

    p1 = _params([], queries, out_file_name=str(tmp_path / "one.txt"),
                 matrix_output=True, visualize=exact, sanity_check=exact,
                 load_index=prefix)
    run = runner.run_sharded if exact else runner.run_sharded_fused
    run(p1, 3, 3, device="cpu", log=lambda m: None)
    suffixes = ("", ".matrix", ".visual") if exact else ("", ".matrix")
    assert _read(out2, suffixes) == _read(p1.out_file_name, suffixes)
    assert _read(out2, ("",))[0].count("\n") == 8

    reads = [set(open(t).read().split()) for t in traces]
    assert set(refs) | set(queries) <= reads[0]
    assert refs[2] in reads[1] and set(queries) <= reads[1]
    assert refs[0] not in reads[1] and refs[3] not in reads[1]


def _jax_sharded_step(refs, frags, n_r, n_q):
    """tests/test_mesh.py's JAX ``make_sharded_step`` on one query
    genome's fragments: (sum_ident, count) (n_r, G)."""
    import jax.numpy as jnp

    from fastani_tpu.models import jitmap as jjitmap
    from fastani_tpu.ops import stats as jstats
    from fastani_tpu.parallel import mesh as jmesh
    from tests.test_mapping_parity import make_params

    params = make_params(frag_len=1000)
    params.frag_batch, params.sketch_cap, params.hits_cap = 8, 256, 1024
    params.cand_cap, params.l2_entry_cap = 8, 256
    sidx = jmesh.build_sharded_index(params, refs, n_r)
    F, L = frags.shape
    F_local = -(-F // n_q)
    padded = np.zeros((n_q * F_local, L), np.uint8)
    padded[:F] = frags
    cfg = jjitmap.MapperConfig.from_params(params, sidx.freq_threshold,
                                           unit_factor=8, unit_chunk=8)
    cfg = cfg.__class__(**{**cfg.__dict__, "unit_cap": F_local * 8,
                           "unit_chunk": 8})
    s_max, k = params.sketch_cap, params.kmer_size
    step = jmesh.make_sharded_step(
        cfg, jmesh.make_mesh(n_r, n_q), s_max, k, params.percentage_identity,
        params.frag_len, sidx.max_local_genomes)
    sums, counts = step(
        jnp.asarray(padded.reshape(n_q, F_local, L)),
        *(jnp.asarray(getattr(sidx, a)) for a in (
            "occ_hash", "occ_sid", "occ_wpos", "mi_hash", "mi_sid",
            "mi_wpos", "seq_start", "genome_of_seq", "n_occ")),
        jnp.asarray(jstats.min_hits_lut(k, params.percentage_identity,
                                        s_max)),
        jnp.asarray(jjitmap.gate_lut_np(k, params.percentage_identity,
                                        s_max)),
        jnp.asarray(jmesh.point_identity_lut(s_max, k)))
    return np.asarray(sums), np.asarray(counts)


@pytest.mark.parametrize("n_r,n_q,caps", [
    (2, 2, {}), (2, 4, {}), (2, 4, {"l2_entry_cap": 128})],
    ids=["2x2", "2x4", "2x4-l2cap128"])
def test_sharded_step_matches_jax(world, monkeypatch, n_r, n_q, caps):
    """The port's make_sharded_step on the query genome (24 fragments of
    1000 bp, w 24 as in tests/test_mesh.py) against the JAX step: counts
    equal, ANI within 1e-3.  A fragment over a cap is mapped again by the
    fallback: at l2_entry_cap 128 every mapped fragment (the default cap,
    256, holds all but one)."""
    wd, refs, _ = world
    (_, seq), = fasta.read_sequences(str(wd / "query.fa"))
    F = len(seq) // 1000
    frags = seq[:F * 1000].reshape(F, 1000)
    js, jc = _jax_sharded_step(refs, frags, n_r, n_q)

    params = Parameters(frag_len=1000, window_size=24,
                        ref_sequences=list(refs), **caps)
    shards = pmesh.build_shards(params, distributed.plan(n_r, n_q),
                                torch.device("cpu"), {}, lambda m: None)
    step = pmesh.make_sharded_step(params, shards, n_r, n_q, -(-F // n_q))
    fallbacks = []
    map_fallback = glue.map_fallback_batch
    monkeypatch.setattr(glue, "map_fallback_batch", lambda *a, **kw: (
        fallbacks.append(1), map_fallback(*a, **kw))[1])
    sums, counts = (t.numpy() for t in step(frags))
    assert fallbacks or not caps
    assert counts.shape == jc.shape == (n_r, 2)
    np.testing.assert_array_equal(counts, jc)
    assert (counts > 0).all()
    np.testing.assert_allclose(sums / counts, js / jc, atol=1e-3)
