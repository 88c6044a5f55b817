"""The port's hashing, statistics and kernel plain versions (K1-K4, CPU)
against the JAX package: bit-equal, the same inputs made with numpy."""

import numpy as np
import pytest
import torch

from fastani_tpu.ops import hashing as jhash
from fastani_tpu.ops import minimizer as jmin
from fastani_tpu.ops import stats as jstats
from fastani_tpu_torch.index import device_build
from fastani_tpu_torch.ops import compact, hashing, sort, stats, winnow

# one intra-op thread: the suite runs several xdist workers per core, and
# torch's thread pool on top of them stalls every small CPU op
torch.set_num_threads(1)

_ALPHA = np.frombuffer(b"ACGTacgtN", np.uint8)


@pytest.mark.parametrize("k", [12, 16])
def test_kmer_hashes_match_numpy(k):
    rng = np.random.default_rng(k)
    seq = _ALPHA[rng.integers(0, 9, 4000)]
    want = jhash.kmer_hashes_np(seq, k).astype(np.int64)
    got = hashing.kmer_hashes(torch.from_numpy(seq.copy()), k).numpy()
    np.testing.assert_array_equal(got, want)
    t = torch.from_numpy(seq.copy())
    np.testing.assert_array_equal(hashing.upper(t).numpy(), jhash.upper_np(seq))
    np.testing.assert_array_equal(hashing.upper_np(seq), jhash.upper_np(seq))
    np.testing.assert_array_equal(hashing.revcomp(t).numpy(),
                                  jhash.revcomp_np(seq))


def _rows(contigs, k, w, seg):
    rows, ctg, base, tl = [], [], [], []
    for ci, s in enumerate(contigs):
        r, b = device_build.segment_rows(s, k, w, seg)
        rows.append(r)
        ctg.append(np.full(len(r), ci, np.int32))
        base.append(b)
        tl.append(np.full(len(r), len(s), np.int32))
    t = lambda a: torch.from_numpy(np.concatenate(a))
    return t(rows), t(ctg), t(base), t(tl)


@pytest.mark.parametrize("k,seg", [(16, 200), (16, 17 * 1024), (12, 333)])
def test_winnow_rows_match_deque_model(k, seg):
    """Lowercase and N bytes, contigs shorter than k+w, and contigs over
    many segment rows (the emit selection carries across rows)."""
    w = 24
    rng = np.random.default_rng(seg)
    contigs = [_ALPHA[rng.integers(0, 9, n)] for n in (6000, 30, 39, 40, 1200)]
    n_run = _ALPHA[rng.integers(0, 8, 3000)].copy()
    n_run[500:1400] = ord("N")            # whole rows without an event
    contigs.append(n_run)
    rows, ctg, base, tl = _rows(contigs, k, w, seg)
    emit, h = winnow.winnow_rows(rows, ctg, base, tl, k, w)
    wpos = winnow.positions(base, h.shape[1], w)
    assert h.dtype == torch.int32          # u32 bits in int32 words
    for ci, s in enumerate(contigs):
        m = ctg == ci
        e = emit[m].reshape(-1)
        want_h, want_w = jmin.winnow_model(s, k, w)
        np.testing.assert_array_equal(
            h[m].reshape(-1)[e].numpy().astype(np.int64) & 0xFFFFFFFF,
            want_h.astype(np.int64))
        np.testing.assert_array_equal(wpos[m].reshape(-1)[e].numpy(), want_w)


@pytest.mark.parametrize("seg,tile_max,want", [
    (17 * 1024, 2048, (1952, 9)), (2985, 2048, (1504, 2)),
    (200, 2048, (224, 1)), (4096, 2048, (2048, 2)), (4097, 1024, (832, 5))])
def test_winnow_tile_geometry(seg, tile_max, want):
    """K1's tiles: the index build's rows (17408 scored positions) in nine,
    the sketch's (2985) in two; multiples of 32, at most tile_max, the
    last tile the shortest, every position covered."""
    tile, n_tiles = winnow.tile_geometry(seg, tile_max)
    assert (tile, n_tiles) == want
    assert tile % 32 == 0 and tile <= max(tile_max, 32)
    assert (n_tiles - 1) * tile < seg <= n_tiles * tile


def test_compact_rows_matches_jax_fallback():
    """K2 plain vs the JAX device build's scatter fallback
    (index/device_build.py::_compact_rows without Pallas)."""
    import jax.numpy as jnp

    from fastani_tpu.index import device_build as jdb

    rng = np.random.default_rng(5)
    rows = 6
    emit = rng.random((rows, 1024)) < 0.1
    emit[0, :300] = True                  # a piece over the 256 cap
    h = rng.integers(0, 2 ** 32, (rows, 1024), dtype=np.uint32)
    wp = rng.integers(0, 2 ** 20, (rows, 1024), dtype=np.int32)
    want_h, want_w, want_cnt, _ = jdb._compact_rows(
        jnp, jnp.asarray(emit), jnp.asarray(h), jnp.asarray(wp), rows)
    got_h, got_w = compact.compact_rows(
        torch.from_numpy(emit), [(torch.from_numpy(h.astype(np.int64)),
                                  0xFFFFFFFF),
                                 (torch.from_numpy(wp), 2 ** 30)], width=256)
    np.testing.assert_array_equal(got_h.numpy(),
                                  np.asarray(want_h).astype(np.int64))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_array_equal(emit.sum(1), np.asarray(want_cnt))


@pytest.mark.parametrize("n,words", [(1024, "int64"), (2033, "int64"),
                                     (8192, "int64"), (8192, "int32")],
                         ids=["1024", "2033", "8192", "8192-int32_words"])
def test_sort_rows_match_jax_sort(n, words):
    """K3 plain vs the JAX package's non-Pallas row sort (``xp.sort``,
    models/mapping.py:345), on u32 values in int64 words and on int32 words
    holding the u32 bit patterns (bit 31 set in about half, ties, rows
    mostly of UMAX pads, the word -1), which must also equal the int64
    path."""
    import jax.numpy as jnp

    rng = np.random.default_rng(n)
    x = rng.integers(0, 2 ** 32, (4, n), dtype=np.uint32)
    x[0, :7] = [0xFFFFFFFF, 0, 5, 5, 5, 1, 0xFFFFFFFF]
    x[1, ::3] = x[1, 1]                       # ties
    x[2, 300:] = 0xFFFFFFFF                   # pads, as the main path's rows
    want = np.asarray(jnp.sort(jnp.asarray(x), axis=1))
    got64 = sort.sort_rows_u32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got64.numpy(), want.astype(np.int64))
    if words == "int32":
        got = sort.sort_rows_u32(torch.from_numpy(x.view(np.int32)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        np.testing.assert_array_equal(got.numpy().astype(np.int64)
                                      & 0xFFFFFFFF, got64.numpy())


def _compact_np(flags, pays, width):
    """Row by row: the flagged values in order, cut to width, then fill."""
    outs = []
    for a, fill in pays:
        out = np.full((flags.shape[0], width), fill, a.dtype)
        for r in range(flags.shape[0]):
            v = a[r][flags[r]][:width]
            out[r, :len(v)] = v
        outs.append(out)
    return outs


@pytest.mark.parametrize("R,n,width", [(1, 262144, 60000), (1, 262144, 65536),
                                       (1, 262144, 126976), (6, 8192, 128),
                                       (5, 2985, 2048)])
def test_compact_rows_int32_match_numpy(R, n, width):
    """K2 (its plain version on the CPU) with bool flags and int32 payloads
    beside an int64 one: a single row of 262144 (the valid-unit
    compaction) whose count (~65500) lies above, near and below the width,
    and rows with every or no position flagged."""
    rng = np.random.default_rng(n + width)
    flags = rng.random((R, n)) < 0.25
    if R > 1:
        flags[0] = True
        flags[1] = False
    pays = [(rng.integers(-2 ** 31, 2 ** 31, (R, n)).astype(np.int32), -1),
            (rng.integers(0, 2 ** 20, (R, n)).astype(np.int32), 0),
            (rng.integers(0, 2 ** 32, (R, n)), 0xFFFFFFFF)]
    got = compact.compact_rows(torch.from_numpy(flags),
                               [(torch.from_numpy(a), f) for a, f in pays],
                               width=width)
    for g, want in zip(got, _compact_np(flags, pays, width)):
        assert g.dtype == torch.from_numpy(want).dtype
        np.testing.assert_array_equal(g.numpy(), want)


@pytest.mark.parametrize("R,n", [(1, 262144), (1, 1), (2048, 8192),
                                 (34816, 1024), (16, 2985)])
def test_compact_geometry_covers_rows(R, n):
    """The kernel's launch shape: blocks of whole warps up to 256 threads,
    tiles of 16 flags a thread, chunks of whole tiles that cover the row,
    one block a row from 2048 rows up, a long single row over 64 blocks."""
    threads, chunks = compact.compact_geometry(R, n)
    assert threads % 32 == 0 and 32 <= threads <= 256
    tile = 16 * threads
    tiles = -(-n // tile)
    assert 1 <= chunks <= max(tiles, 1)
    assert -(-tiles // chunks) * tile * chunks >= n
    if R >= 2048:
        assert chunks == 1
    if (R, n) == (1, 262144):
        assert (threads, chunks) == (256, 64)


def test_sort_rows_kv_matches_jax_argsort():
    """K4 plain vs the JAX event merge's non-Pallas path (a stable argsort
    plus gathers, models/l2walk.py:226-229), compared on the real (unique)
    keys as the callers mask the tied pad/clamped ones."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    R, n = 5, 2033
    keys = np.stack([rng.permutation(1 << 20)[:n] for _ in range(R)])
    keys[:, 1500:] = (1 << 28) << 2       # tied clamped keys (masked)
    pay = rng.integers(0, 2 ** 32, (R, n), dtype=np.uint32)
    order = jnp.argsort(jnp.asarray(keys.astype(np.int32)), axis=-1)
    want_k = np.asarray(jnp.take_along_axis(jnp.asarray(keys), order, -1))
    want_p = np.asarray(jnp.take_along_axis(jnp.asarray(pay), order, -1))
    ko, po = sort.sort_rows_u32_kv(torch.from_numpy(keys.astype(np.int64)),
                                   torch.from_numpy(pay.astype(np.int64)))
    real = want_k < ((1 << 28) << 2)
    np.testing.assert_array_equal(ko.numpy(), want_k)
    np.testing.assert_array_equal(po.numpy()[real],
                                  want_p[real].astype(np.int64))


def test_stats_tables_match_scalar_functions():
    """The vectorized LUTs equal the JAX package's scalar functions."""
    ident, upper = stats.identity_tables(16, 320)
    for s in (1, 2, 7, 100, 276, 320):
        want_i, want_u = jstats.identity_lut(s, 16)
        np.testing.assert_array_equal(ident[s, : s + 1].view(np.int32),
                                      want_i.view(np.int32))
        np.testing.assert_array_equal(upper[s, : s + 1].view(np.int32),
                                      want_u.view(np.int32))
    np.testing.assert_array_equal(stats.min_hits_lut(16, 80.0, 320),
                                  jstats.min_hits_lut(16, 80.0, 320))
    assert stats.recommended_window_size(1e-3, 16, 4, 80.0, 3000,
                                         5_000_000) == 24


def test_gate_lut_matches_jax():
    from fastani_tpu.models import jitmap as jjit
    from fastani_tpu_torch.models import jitmap

    np.testing.assert_array_equal(jitmap.gate_lut_np(16, 80.0, 64),
                                  jjit.gate_lut_np(16, 80.0, 64))
