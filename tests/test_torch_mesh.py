"""The port's jobs on (r, q) grids (``models/pipeline.py``; ``--mesh``,
``--coordinator``) on the CPU against the JAX package's sharded runner and
against the port's 1x1 jobs: the fast path's counts and ANI, with and
without fragments over a cap (redone per shard), a query that maps
nowhere, the exact path's bytes, the per-shard sanity check, per-shard
index files both ways, and a run over two gloo processes, which reads
only its own shards' reference files.  Small batches (``frag_batch`` 8)
split each query genome's fragments over the q cells, so the q-merge of
the device CGI decides the fast path's counts.  The JAX runner runs on its
8-device CPU mesh (tests/conftest.py)."""

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
from fastani_tpu_torch.models import pipeline
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


@pytest.mark.parametrize("n_r,n_q,caps", [
    (1, 1, {}), (2, 2, {}), (2, 4, {}), (2, 2, {"l2_entry_cap": 128}),
    (2, 4, {"l2_entry_cap": 128})],
    ids=["1-1", "2-2", "2-4", "2-2-l2cap128", "2-4-l2cap128"])
def test_fused_mesh_matches_jax_and_single_device(world, n_r, n_q, caps):
    """Counts equal to the JAX run_sharded_fused's and to the port's 1x1
    run_fast at the same caps, ANI within 1e-3 of both.  At l2_entry_cap
    128 every mapped fragment overflows (the default cap, 256, holds all
    but one), and each query genome is redone exactly on every shard."""
    from fastani_tpu.config import Parameters as JParams
    from fastani_tpu.parallel import runner as jrunner

    _, refs, queries = world
    stats = {}
    got = _matrices(pipeline.run_fast(
        _params(refs, queries, **caps), device="cpu", stats=stats,
        log=lambda m: None, n_r=n_r, n_q=n_q), 2, 4)
    single = _matrices(pipeline.run_fast(_params(refs, queries, **caps),
                                         device="cpu", log=lambda m: None),
                       2, 4)
    jax = _matrices(jrunner.run_sharded_fused(
        JParams(frag_len=1000, frag_batch=8, ref_sequences=list(refs),
                query_sequences=list(queries), **caps), n_r, n_q,
        log=lambda m: None), 2, 4)
    for want in (single, jax):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], atol=1e-3)
    assert (got[0] > 0).sum() == 8 and stats["batches"] == 6
    if caps:
        assert stats["fallback_frags"] > 0 and stats["redone_queries"] == 2
    else:
        assert stats["fallback_frags"] == 0 == stats["redone_queries"]


@pytest.mark.parametrize("n_r,n_q", [(1, 1), (1, 2), (2, 2)])
def test_unrelated_query_maps_nowhere(world, tmp_path, n_r, n_q):
    """A query genome that shares no fragment with the references, through
    the fast job: every count 0, no TSV row, as the JAX run_fast."""
    from fastani_tpu.config import Parameters as JParams
    from fastani_tpu.models import pipeline as jpipe

    _, refs, _ = world
    query = str(tmp_path / "unrelated.fa")
    synth.write_fasta(query, [("u0", synth.random_genome(
        np.random.default_rng(77), 24_000))])
    out = str(tmp_path / "o.txt")
    stats = {}
    got = pipeline.run_fast(
        _params(refs, [query], out_file_name=out), device="cpu",
        stats=stats, log=lambda m: None, n_r=n_r, n_q=n_q)
    want = jpipe.run_fast(JParams(frag_len=1000, frag_batch=8,
                                  ref_sequences=list(refs),
                                  query_sequences=[query]),
                          log=lambda m: None)
    c, a = _matrices(got, 1, 4)
    assert not c.any() and not a.any()
    np.testing.assert_array_equal(c, _matrices(want, 1, 4)[0])
    assert [(e.count_seq, e.total_query_fragments) for e in got] == \
        [(e.count_seq, e.total_query_fragments) for e in want]
    assert open(out).read() == ""
    assert stats["batches"] == 3 and stats["n_valid"] == 0


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


@pytest.mark.parametrize("n_r,n_q,caps", [
    (2, 4, {}), (3, 3, {}), (2, 4, {"l2_entry_cap": 128})],
    ids=["2-4", "3-3", "2-4-l2cap128"])
def test_exact_mesh_split_batches_byte_equal(world, tmp_path, n_r, n_q,
                                             caps):
    """pipeline.run at frag_batch 8 on a grid, each batch split over the q
    cells and the genomes over 2 or 3 shards (one of them with two files):
    the three files equal the 1x1 job's; at l2_entry_cap 128 every mapped
    fragment overflows and is mapped again at grown caps, per shard."""
    _, refs, queries = world
    files, stats = {}, {}
    for tag, grid in (("single", (1, 1)), ("mesh", (n_r, n_q))):
        p = _params(refs, queries, visualize=True, matrix_output=True,
                    sanity_check=True, out_file_name=str(tmp_path / tag),
                    **caps)
        stats[tag] = {}
        pipeline.run(p, device="cpu", log=lambda m: None, stats=stats[tag],
                     n_r=grid[0], n_q=grid[1])
        files[tag] = _read(p.out_file_name)
    assert files["mesh"] == files["single"]
    assert files["single"][0].count("\n") == 8
    assert (stats["mesh"]["fallback_frags"] > 0) == bool(caps)


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
from fastani_tpu_torch.models import pipeline
p = Parameters(frag_len=1000, frag_batch=8, ref_sequences={refs!r},
               query_sequences={queries!r}, out_file_name={out!r},
               matrix_output=True, visualize={exact!r}, sanity_check={exact!r},
               save_index={prefix!r})
run = pipeline.run if {exact!r} else pipeline.run_fast
run(p, n_r=3, n_q=3, coordinator={coord!r}, num_processes=2,
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
    run = pipeline.run if exact else pipeline.run_fast
    run(p1, n_r=3, n_q=3, device="cpu", log=lambda m: None)
    suffixes = ("", ".matrix", ".visual") if exact else ("", ".matrix")
    assert _read(out2, suffixes) == _read(p1.out_file_name, suffixes)
    assert _read(out2, ("",))[0].count("\n") == 8

    reads = [set(open(t).read().split()) for t in traces]
    assert set(refs) | set(queries) <= reads[0]
    assert refs[2] in reads[1] and set(queries) <= reads[1]
    assert refs[0] not in reads[1] and refs[3] not in reads[1]
