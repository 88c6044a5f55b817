"""The fold kernel's contract on the CPU (``csrc/fold.cu`` runs only on a
card): its order restated in torch (``device_cgi.fold_rows_tiled``: tiles
of a warp's width, a ballot count a tile, one add per occupied bin) is the
plain fold's and the sequential fold's bits at every tile width, on
values where the order of the adds matters and on edge genomes; the fused
finalize's plain version against the JAX ``finalize_rows`` (counts
equal, sums within rtol 1e-6: the JAX segment sums add in another order)
with recycled slots, accumulators already holding sums, and rows given;
and ``StreamingCGI``'s host checks of a finalize list and of its
genomes' bin ranges."""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastani_tpu.models import device_cgi as jcgi
from fastani_tpu_torch.models import device_cgi
from tests.test_torch_cuda import EDGE_BINS, adversarial_rows

# one intra-op thread: the suite runs several xdist workers per core, and
# torch's thread pool on top of them stalls every small CPU op
torch.set_num_threads(1)

def _sequential_by_genome(rows, n_bins):
    """(counts, sums) of each row and genome: occupied bins, and
    ``fold_sequential`` over the genome's masked identities."""
    lo = np.cumsum(n_bins) - n_bins
    counts = np.zeros((rows.shape[0], len(n_bins)), np.int32)
    sums = torch.zeros((rows.shape[0], len(n_bins)), dtype=torch.float32)
    for g, (a, n) in enumerate(zip(lo, n_bins)):
        part = rows[:, a:a + n]
        counts[:, g] = (part >= 0).sum(1)
        vals = np.where(part >= 0, part.view(np.float32), np.float32(0))
        sums[:, g] = device_cgi.fold_sequential(torch.from_numpy(vals))
    return torch.from_numpy(counts), sums


@pytest.mark.parametrize("tile", [1, 7, 32, 64])
def test_tiled_order_equals_plain_and_sequential(tile):
    """fold_rows_tiled at ``tile`` equals fold_rows_plain and the
    sequential fold bit for bit, counts and sums, on adversarial values
    (the order-sensitive row does depend on the order) and on genomes of
    0, 1, 31, 32, 33 bins at unaligned starts."""
    rng = np.random.default_rng(5)
    rows = adversarial_rows(rng, EDGE_BINS)
    ranges = torch.as_tensor(device_cgi.genome_bins(
        np.repeat(np.arange(len(EDGE_BINS)), EDGE_BINS), len(EDGE_BINS)))
    assert rows.shape[1] % 32 and int(ranges[0, 4]) % 32
    got = device_cgi.fold_rows_tiled(torch.from_numpy(rows), ranges, tile)
    plain = device_cgi.fold_rows_plain(torch.from_numpy(rows), ranges)
    seq = _sequential_by_genome(rows, EDGE_BINS)
    bits = lambda x: x.view(torch.int32)
    for want in (plain, seq):
        assert torch.equal(got[0], want[0])
        assert torch.equal(bits(got[1]), bits(want[1]))
    s = got[1]
    assert torch.isnan(s[2]).sum() == 1 and torch.isinf(s[2]).sum() == 1
    assert got[0][:, 1].eq(0).all() and bits(s[:, 1]).eq(0).all()   # +0.0
    # the order matters on row 1: its occupied values summed smallest
    # first differ from the fold somewhere
    lo = np.cumsum(EDGE_BINS) - EDGE_BINS
    differs = 0
    for g, (a, n) in enumerate(zip(lo, EDGE_BINS)):
        part = rows[1, a:a + n]
        v = np.sort(part[part >= 0].view(np.float32))
        alt = np.float32(0)
        for x in v:
            alt = np.float32(alt + x)
        differs += alt.view(np.int32) != bits(s[1, g]).item()
    assert differs > 0


def _table(rng, n_slots, B_tot):
    ident = rng.uniform(76.0, 100.0, (n_slots, B_tot)).astype(np.float32)
    return np.where(rng.uniform(size=(n_slots, B_tot)) < 0.6,
                    ident.view(np.int32), -1).astype(np.int32)


@pytest.mark.parametrize("case", ["recycled", "accumulated", "rows_given"])
def test_finalize_plain_matches_jax(case):
    """finalize_rows_plain (and finalize_rows, which runs it on the CPU)
    against the JAX finalize_rows on 9 reference genomes: counts and the
    table after the call equal, sums within rtol 1e-6 and bit-equal to
    the accumulators before the call plus the fold of each row.  Slots
    recycle (query genomes past n_slots); accumulators hold sums before the
    call; or the folded rows are given (the mesh's q-merged rows): the
    JAX side then folds a table holding them in the slots."""
    rng = np.random.default_rng({"recycled": 1, "accumulated": 2,
                                 "rows_given": 3}[case])
    n_bins = [40, 0, 33, 1, 70, 31, 12, 64, 9]
    n_rg, B_tot, n_slots, n_qg = len(n_bins), sum(n_bins), 3, 8
    gid_of_bin = np.repeat(np.arange(n_rg), n_bins).astype(np.int32)
    ranges = torch.as_tensor(device_cgi.genome_bins(gid_of_bin, n_rg))
    tab = _table(rng, n_slots, B_tot)
    fin = np.array([4, 5, 3], np.int64)                  # slots 1, 2, 0
    acc_c = np.zeros((n_qg, n_rg), np.int32)
    acc_s = np.zeros((n_qg, n_rg), np.float32)
    rows = None
    if case == "accumulated":
        acc_c = rng.integers(0, 50, (n_qg, n_rg)).astype(np.int32)
        acc_s = rng.uniform(0, 3000, (n_qg, n_rg)).astype(np.float32)
    if case == "rows_given":
        rows = _table(rng, len(fin), B_tot)
    jtab = tab.copy()
    if rows is not None:
        jtab[fin % n_slots] = rows
    jt, jc, js = jcgi.finalize_rows(
        jnp.asarray(jtab), jnp.asarray(acc_c), jnp.asarray(acc_s),
        jnp.asarray(fin.astype(np.int32)), jnp.asarray(gid_of_bin), n_slots,
        n_qg, n_rg)
    folded = device_cgi.fold_rows_plain(
        torch.from_numpy(tab[fin % n_slots] if rows is None else rows),
        ranges)
    for fn in (device_cgi.finalize_rows_plain, device_cgi.finalize_rows):
        t, c, sm = (torch.from_numpy(x.copy()) for x in (tab, acc_c, acc_s))
        fn(t, c, sm, torch.from_numpy(fin), ranges, n_slots,
           rows=None if rows is None else torch.from_numpy(rows))
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
        assert (t.numpy()[fin % n_slots] == -1).all()
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        assert c.sum() > acc_c.sum() + 50
        np.testing.assert_allclose(sm.numpy(), np.asarray(js), rtol=1e-6)
        want = torch.from_numpy(acc_s.copy())
        want[torch.from_numpy(fin)] += folded[1]
        assert torch.equal(sm.view(torch.int32), want.view(torch.int32))


def _streaming_cgi(n_slots, genome_of_seq, n_rg, n_qg=6):
    """A StreamingCGI over an index stand-in of three contigs on the CPU."""
    index = types.SimpleNamespace(
        device=torch.device("cpu"),
        metadata=[types.SimpleNamespace(length=n)
                  for n in (50_000, 30_000, 20_000)],
        genome_of_seq=lambda: np.asarray(genome_of_seq, np.int32))
    params = types.SimpleNamespace(frag_len=3000, sketch_cap=320,
                                   kmer_size=16)
    return device_cgi.StreamingCGI(index, params, n_qg, n_rg, n_slots,
                                   frag_cap=16)


def test_finalize_list_duplicate_slot_raises():
    """Two query genomes of one finalize_list call in one slot, or a query
    genome outside the accumulators, raise before anything runs; distinct
    slots fold and clear."""
    cgi = _streaming_cgi(3, [0, 0, 1], 2)
    cgi._tab[:] = torch.from_numpy(_table(np.random.default_rng(9), 3,
                                          cgi.B_tot))
    before = cgi._tab.clone()
    for qnos in ([1, 4], [0, 3, 5], [2, 6]):
        with pytest.raises(ValueError):
            cgi.finalize_list(qnos)
    assert torch.equal(cgi._tab, before) and not cgi._counts.any()
    cgi.finalize_list([3, 4, 5])
    assert bool((cgi._tab == -1).all()) and cgi._counts.sum() > 0


def test_streaming_cgi_ranges_cover_the_bins():
    """A genome id past the reference genomes leaves bins no genome's
    range covers: the fold kernel would not clear them, so the
    accumulator refuses to be built."""
    assert _streaming_cgi(2, [0, 1, 1], 2).B_tot == int(
        _streaming_cgi(2, [0, 1, 1], 2)._ranges[1].sum())
    with pytest.raises(ValueError):
        _streaming_cgi(2, [0, 1, 2], 2)
