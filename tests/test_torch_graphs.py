"""The map step's three stages (``jitmap.stage_pre``, ``stage_chunk`` at
its device offset, ``stage_post``) against the JAX package's
``map_step_packed`` and against the L2 chunk loop sliced on the host;
mapper copies and their graphs; the capture at a mapper's first batch and
the replay of a padded tail; the launch accounting of a capture;
and the fold's plain version (``device_cgi.fold_rows_plain``) against
``fold_sequential``.  The graphs themselves and the fold kernel run on the
card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from fastani_tpu.models import jitmap as jjit
from fastani_tpu_torch.models import device_cgi, jitmap, l2walk
from fastani_tpu_torch.ops import cuda
from tests.test_torch_map import B, world  # noqa: F401  (the fixture)

# one intra-op thread: the suite runs several xdist workers per core, and
# torch's thread pool on top of them stalls every small CPU op
torch.set_num_threads(1)

UNIT_CHUNK = 24      # unit_cap 256 is no multiple of it: the pad is exercised


def _staged(mapper, bufs):
    """stage_pre, stage_chunk n_chunks times (the offset checked before
    each), stage_post; returns n_live."""
    cfg, t = mapper.cfg, mapper.tables
    jitmap.stage_pre(cfg, t, bufs)
    n_live = int(bufs["n_live"])
    n = jitmap.n_chunks(cfg, bufs["n_live"])
    assert n == -(-n_live // cfg.unit_chunk)
    for i in range(n):
        assert int(bufs["off"]) == i * cfg.unit_chunk
        jitmap.stage_chunk(cfg, t, bufs)
    jitmap.stage_post(cfg, t, bufs)
    return n_live


def _sliced_l2(mapper, frags):
    """The L2 outputs of the chunk loop sliced on the host, chunk by chunk
    up to the last live unit, the last chunk cut at unit_cap."""
    cfg, t = mapper.cfg, mapper.tables
    u = jitmap.locate_units(cfg, frags, t)
    U = cfg.unit_cap
    out = [torch.zeros(U, dtype=dt) for dt in (torch.int32, torch.int32,
                                               torch.bool, torch.bool)]
    for c0 in range(0, int(u["n_live"]), cfg.unit_chunk):
        sl = slice(c0, min(c0 + cfg.unit_chunk, U))
        for o, r in zip(out, l2walk.l2_walk_units(
                *jitmap.l2_chunk_args(cfg, t, u, sl))):
            o[sl] = r
    return out


@pytest.mark.parametrize("padded", [False, True], ids=["rows", "row_valid"])
def test_staged_step_matches_jax_and_sliced_loop(world, padded):
    """The staged step bit-equal to the JAX map_step_packed (packed[:,
    :n_valid], counts, fallback mask), on a batch whose live unit count is
    no multiple of unit_chunk, and on the batch padded to B rows with
    row_valid; its L2 outputs bit-equal to the host-sliced chunk loop, and
    zero in the chunks past the live units."""
    jp, jidx, tp, tidx, frags = world
    F = len(frags)
    qno = np.full(F, 3, np.int32)
    qsid = np.arange(F, dtype=np.int32) + 100
    rv = None
    if padded:
        pad = np.zeros((B, frags.shape[1]), np.uint8)
        pad[:F] = frags
        frags = pad
        rv = torch.arange(B) < F
        padi = lambda a: np.concatenate([a, np.zeros(B - F, np.int32)])
        qno, qsid = padi(qno), padi(qsid)
    jm = jjit.JitMapper(jp, jidx, unit_factor=4, unit_chunk=32)
    h = jm.dispatch(frags[:F], qno[:F], qsid[:F])
    want = {key: np.asarray(h["out"][key]) for key in
            ("packed", "counts", "fallback_mask")}

    mapper = jitmap.Mapper(tp, tidx, unit_factor=4, unit_chunk=UNIT_CHUNK)
    assert mapper.cfg.unit_cap % UNIT_CHUNK
    f = torch.from_numpy(frags)
    bufs = dict(zip(jitmap.INPUTS, (f, torch.from_numpy(qno),
                                    torch.from_numpy(qsid), rv)))
    n_live = _staged(mapper, bufs)
    assert n_live % UNIT_CHUNK and n_live > 2 * UNIT_CHUNK
    counts = bufs["counts"].numpy()
    np.testing.assert_array_equal(counts, want["counts"].astype(np.int64))
    n = int(counts[0])
    assert n > 30
    np.testing.assert_array_equal(bufs["packed"].numpy()[:, :n],
                                  want["packed"][:, :n])
    np.testing.assert_array_equal(bufs["fallback_mask"].numpy()[:F],
                                  want["fallback_mask"][:F])
    assert not bufs["fallback_mask"][F:].any()

    U = mapper.cfg.unit_cap
    for name, ref in zip(("shared", "mean_pos", "l2_valid", "l2_over"),
                         _sliced_l2(mapper, f)):
        assert torch.equal(bufs[name][:U], ref), name
        assert not bufs[name][-(-n_live // UNIT_CHUNK) * UNIT_CHUNK:].any()
    # the eager map step is the same three stages
    out = jitmap.map_step_packed(mapper.cfg, f, mapper.tables,
                                 bufs["qno_row"], bufs["qsid_row"], rv)
    for name in jitmap.OUTPUTS:
        assert torch.equal(out[name], bufs[name]), name


def test_mapper_copies_keep_their_own_graphs(world):
    """with_caps gives a copy no graphs and no batches of its own and its
    own config; graphs are off on the CPU whatever the constructor is
    told."""
    _, _, tp, tidx, frags = world
    mapper = jitmap.Mapper(tp, tidx, unit_factor=4, unit_chunk=32,
                           graphs=True)
    assert mapper.graphs is False
    mapper._step = step = object()
    mapper.eager_batches = 2
    other = mapper.with_caps(hits_cap=2048, sketch_cap=256)
    assert other._step is None and mapper._step is step
    assert other.eager_batches == 0 and mapper.eager_batches == 2
    assert other.height == mapper.height == tp.frag_batch
    assert other.cfg.hits_cap == 2048 and mapper.cfg.hits_cap != 2048
    assert other.tables.gate.shape[0] == 257
    assert mapper.tables.gate.shape[0] == mapper.cfg.sketch_cap + 1
    assert other.graph_stats() == {
        "graphs": 0, "t_capture": 0, "t_warmup": 0.0, "graph_pool_bytes": 0,
        "eager_batches": 0, "replays": 0, "warmup_launches": {}}
    f = torch.from_numpy(frags)
    wide = mapper.with_caps(hits_cap=8192)
    a = jitmap.map_step_packed(wide.cfg, f, wide.tables)
    b = jitmap.map_step_packed(mapper.cfg, f, mapper.tables)
    for name in jitmap.OUTPUTS:
        assert torch.equal(a[name], b[name]), name


def test_mapper_captures_at_its_first_batch_and_replays_the_padded_tail(
        world, monkeypatch):
    """With graphs on, the mapper's first batch captures
    (``Mapper._capture``, which warms the stages up first) and replays,
    later batches replay the same graphs, and a tail batch padded to the
    mapper's height with row_valid replays them too: no batch runs
    eagerly.  Each handle holds the map step's outputs of its padded
    batch; ``graph_stats`` counts the graphs and the replays; ``collect``
    and ``dispatch`` reject a batch not dispatched ``to_host`` and one
    taller than the mapper.  The capture is stood in for on the CPU by a
    step that runs the stages eagerly."""
    _, _, tp, tidx, frags = world
    mapper = jitmap.Mapper(tp, tidx, unit_factor=4, unit_chunk=32)
    mapper.graphs = True
    H = mapper.height
    captured, runs = [], []

    class Step:
        capture_s, pool_bytes = 0.5, 1024

        def run(self, inputs):
            runs.append(inputs["frags"].shape[0])
            return jitmap.map_step_packed(
                mapper.cfg, inputs["frags"], mapper.tables,
                *(inputs[name] for name in jitmap.INPUTS[1:]))

    def capture(inputs):
        captured.append(inputs["frags"].shape[0])
        return Step()

    monkeypatch.setattr(mapper, "_capture", capture)
    F = len(frags)
    assert F < H
    qno = np.full(F, 2, np.int32)
    qsid = np.arange(F, dtype=np.int32)
    for i, n in enumerate((F, F, F, 7)):       # then a tail of 7 rows
        h = mapper.dispatch(frags[:n], qno[:n], qsid[:n], n)
        pad = np.zeros((H, frags.shape[1]), np.uint8)
        pad[:n] = frags[:n]
        padi = lambda a: torch.from_numpy(np.concatenate(
            [a[:n], np.zeros(H - n, np.int32)]))
        want = jitmap.map_step_packed(mapper.cfg, torch.from_numpy(pad),
                                      mapper.tables, padi(qno), padi(qsid),
                                      torch.arange(H) < n)
        got = mapper.collect_device(h)
        for name in jitmap.OUTPUTS:
            assert torch.equal(got[name], want[name]), (i, name)
        assert int(got["counts"][0]) > (30 if n == F else 0)
        assert captured == [H] and runs == [H] * (i + 1)
    assert mapper.graph_stats() == {
        "graphs": 3, "t_capture": 0.5, "t_warmup": 0.0,
        "graph_pool_bytes": 1024, "eager_batches": 0, "replays": 4,
        "warmup_launches": {}}
    with pytest.raises(ValueError):             # not dispatched to_host
        mapper.collect(h)
    with pytest.raises(ValueError):
        mapper.dispatch(np.zeros((H + 1, frags.shape[1]), np.uint8),
                        np.zeros(H + 1, np.int32), np.zeros(H + 1, np.int32),
                        H + 1)


def test_captured_launches_restore_and_replay():
    """A capture's wrapper counts go into the yielded dict and out of
    LAUNCHES; add_launches adds them once a replay; an error inside still
    restores LAUNCHES."""
    saved = dict(cuda.LAUNCHES)
    try:
        cuda.reset_launches()
        cuda.LAUNCHES["walk"] = 5
        with cuda.captured_launches() as got:
            cuda.LAUNCHES["walk"] += 2
            cuda.LAUNCHES["sort_kv"] += 1
        assert got == {"walk": 2, "sort_kv": 1}
        assert cuda.LAUNCHES["walk"] == 5 and cuda.LAUNCHES["sort_kv"] == 0
        for _ in range(3):
            cuda.add_launches(got)
        assert cuda.LAUNCHES["walk"] == 11 and cuda.LAUNCHES["sort_kv"] == 3
        with pytest.raises(RuntimeError):
            with cuda.captured_launches():
                cuda.LAUNCHES["fold"] += 1
                raise RuntimeError("capture failed")
        assert cuda.LAUNCHES["fold"] == 0
        assert "fold" in cuda.KERNELS and cuda.SOURCES["fold"] == "fold.cu"
    finally:
        cuda.LAUNCHES.update(saved)


@pytest.mark.parametrize("fin", [1, 2, 4])
def test_fold_plain_matches_fold_sequential(fin):
    """fold_rows_plain (the FOLD_BLOCK loop) on genomes of unequal bin
    counts, one over several FOLD_BLOCKs and one of a single bin: counts
    equal the occupied bins, sums bit-equal to fold_sequential of each
    genome's masked identities in bin order; finalize_rows folds the same
    into its accumulators."""
    rng = np.random.default_rng(40 + fin)
    n_bins = [1008, 70, 1, 2000, 129, 64]
    n_rg, B_tot = len(n_bins), sum(n_bins)
    gid_of_bin = np.repeat(np.arange(n_rg), n_bins)
    ident = rng.uniform(76.0, 100.0, (fin, B_tot)).astype(np.float32)
    rows = np.where(rng.uniform(size=(fin, B_tot)) < 0.6,
                    ident.view(np.int32), -1).astype(np.int32)
    bins = torch.as_tensor(device_cgi.genome_bins(gid_of_bin, n_rg))
    counts, sums = device_cgi.fold_rows_plain(torch.from_numpy(rows), bins)
    assert counts.shape == sums.shape == (fin, n_rg)
    assert counts.dtype == torch.int32 and sums.dtype == torch.float32
    lo = np.cumsum(n_bins) - n_bins
    for g, (a, n) in enumerate(zip(lo, n_bins)):
        part = rows[:, a:a + n]
        vals = torch.from_numpy(np.where(part >= 0, part.view(np.float32),
                                         np.float32(0)))
        want = device_cgi.fold_sequential(vals)
        assert torch.equal(sums[:, g].view(torch.int32),
                           want.view(torch.int32)), g
        np.testing.assert_array_equal(counts[:, g].numpy(),
                                      (part >= 0).sum(1))
    tab = torch.from_numpy(rows.copy())
    acc_c = torch.zeros((2 * fin, n_rg), dtype=torch.int32)
    acc_s = torch.zeros((2 * fin, n_rg), dtype=torch.float32)
    device_cgi.finalize_rows(tab, acc_c, acc_s, torch.arange(fin) + fin,
                             bins, fin)
    assert torch.equal(acc_c[fin:], counts)
    assert torch.equal(acc_s[fin:].view(torch.int32), sums.view(torch.int32))
    assert not acc_c[:fin].any() and bool((tab == -1).all())
