"""The port's device CGI fold (update_tab, finalize_rows) against the JAX
package's on the same rows: counts equal, sums within rtol 1e-6 (the JAX
segment sums add in another order); the
port's sums bit-equal to the reference's sequential float32 fold; its host
fold (``compute_cgi_arrays``) and ``identities_for`` bit-equal to the JAX
package's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastani_tpu.models import ani as jani
from fastani_tpu.models import device_cgi as jcgi
from fastani_tpu.ops import stats as jstats
from fastani_tpu_torch.models import ani, device_cgi
from fastani_tpu_torch.ops import stats

# one intra-op thread: the suite runs several xdist workers per core, and
# torch's thread pool on top of them stalls every small CPU op
torch.set_num_threads(1)


def test_update_and_finalize_match_jax():
    rng = np.random.default_rng(17)
    frag_len, n_rg, n_qg, n_slots, B, U = 3000, 3, 4, 2, 16, 96
    lengths = [50_000, 30_000, 20_000, 40_000, 10_000]
    gos = np.array([0, 0, 1, 2, 2], np.int32)
    bin_start, gid_of_bin = device_cgi.make_bin_tables(lengths, gos, frag_len)
    jbs, jgob = jcgi.make_bin_tables(lengths, gos, frag_len)
    np.testing.assert_array_equal(bin_start, jbs)
    np.testing.assert_array_equal(gid_of_bin, jgob)
    lut = device_cgi.identity_lut_full(16, 320)     # rows held in test_torch_ops

    B_tot = len(gid_of_bin)
    tab_j = jnp.full((n_slots, B_tot), -1, jnp.int32)
    acc_cj = jnp.zeros((n_qg, n_rg), jnp.int32)
    acc_sj = jnp.zeros((n_qg, n_rg), jnp.float32)
    tab_t = torch.full((n_slots, B_tot), -1, dtype=torch.int32)
    acc_ct = torch.zeros((n_qg, n_rg), dtype=torch.int32)
    acc_st = torch.zeros((n_qg, n_rg), dtype=torch.float32)
    # query genomes 0,1 in batch 0; 1,2 in batch 1; 3 in batch 2; close
    # each as soon as its last batch has been folded
    plan = [((0, 1), ()), ((1, 2), (0,)), ((3,), (1, 2)), ((), (3,))]
    for qnos, fin in plan:
        if fin:
            f = np.asarray(fin, np.int32)
            tab_j, acc_cj, acc_sj = jcgi.finalize_rows(
                tab_j, acc_cj, acc_sj, jnp.asarray(f), jnp.asarray(gid_of_bin),
                n_slots, n_qg, n_rg)
            device_cgi.finalize_rows(
                tab_t, acc_ct, acc_st, torch.from_numpy(f.astype(np.int64)),
                torch.from_numpy(device_cgi.genome_bins(gid_of_bin, n_rg)),
                n_slots)
        if not qnos:
            continue
        n = int(rng.integers(U // 2, U))
        sid = rng.integers(0, len(lengths), U)
        sketch = rng.integers(100, 320, U)
        packed = np.stack([
            rng.integers(0, B, U),                       # frag
            rng.choice(qnos, U),                         # qno
            rng.integers(0, 1000, U),                    # qsid
            sid,
            (sketch * rng.uniform(0.3, 1.0, U)).astype(np.int64),  # shared
            sketch,
            rng.integers(0, np.asarray(lengths)[sid]),   # pos
        ]).astype(np.int32)
        packed[:, n:] = rng.integers(0, 5, (7, U - n))   # rows past n_valid
        tab_j = jcgi.update_tab(
            tab_j, jnp.asarray(packed), jnp.asarray([n], jnp.int32),
            jnp.zeros(B, bool), jnp.asarray(gos), jnp.asarray(bin_start),
            jnp.asarray(lut), frag_len, n_slots, n_rg, B)
        device_cgi.update_tab(tab_t, torch.from_numpy(packed), n,
                              torch.from_numpy(gos),
                              torch.from_numpy(bin_start),
                              torch.from_numpy(lut), frag_len, n_slots, n_rg,
                              B)
        np.testing.assert_array_equal(tab_t.numpy(), np.asarray(tab_j))
    np.testing.assert_array_equal(acc_ct.numpy(), np.asarray(acc_cj))
    assert acc_ct.sum() > 20
    np.testing.assert_allclose(acc_st.numpy(), np.asarray(acc_sj), rtol=1e-6)


def _mapping_rows(rng, n, k):
    """n mapping rows of one query genome: 6 reference contigs in 3 genomes,
    30 fragments, start positions on few bins (frag_len 3000: bins of 2980)
    with ties, identities from few (shared, sketch) pairs, so that they tie
    too."""
    sketch = rng.choice([150, 201, 240], n)
    shared = np.minimum(rng.integers(60, 200, n) // 20 * 20, sketch)
    ident, upper = stats.identities_for(shared, sketch, k)
    return dict(ref_sid=rng.integers(0, 6, n), qsid=rng.integers(0, 30, n),
                ref_start=rng.integers(0, 8, n) * 1490 + rng.integers(0, 3, n),
                ident=ident, shared=shared, sketch=sketch, upper=upper)


@pytest.mark.parametrize("seed", [3, 4])
def test_compute_cgi_arrays_matches_jax(seed):
    """Rows (genome, count, f32 mean: the sequential fold) and the .visual
    list equal, bit for bit."""
    rng = np.random.default_rng(seed)
    m = _mapping_rows(rng, 400, 16)
    gos = np.array([0, 0, 1, 1, 1, 2], np.int32)
    args = (m["ref_sid"], m["qsid"], m["ref_start"], m["ident"], gos, 3000,
            5, 30)
    got_rows, got_vis = ani.compute_cgi_arrays(*args)
    want_rows, want_vis = jani.compute_cgi_arrays(*args)
    assert len(got_rows) == 3 and len(got_vis) > 20
    as_t = lambda r: (r.qry_genome, r.ref_genome, r.count_seq,
                      r.total_query_fragments,
                      np.float32(r.identity).view(np.int32))
    assert [as_t(r) for r in got_rows] == [as_t(r) for r in want_rows]
    as_v = lambda v: (v.genome_id, v.ref_seq_id, v.query_seq_id, v.ref_start,
                      v.query_start, np.float32(v.identity).view(np.int32))
    assert [as_v(v) for v in got_vis] == [as_v(v) for v in want_vis]
    rows, vis = ani.compute_cgi_arrays(*args, want_visual=False)
    assert vis == [] and [as_t(r) for r in rows] == [as_t(r) for r in
                                                     want_rows]


def test_identities_for_matches_jax():
    """Identity and upper bound per (shared, sketch) row, bit-equal,
    including shared counts above the sketch size (clipped) and s = 0."""
    rng = np.random.default_rng(8)
    m = _mapping_rows(rng, 300, 16)
    shared, sketch = m["shared"].copy(), m["sketch"].copy()
    shared[:5] = sketch[:5] + 3
    sketch[5:8] = 0
    for k in (16, 12):
        got = stats.identities_for(shared, sketch, k)
        want = jstats.identities_for(shared, sketch, k)
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))


def _sequential(values) -> np.float32:
    """The reference's sum: a float32 left fold from 0."""
    acc = np.float32(0.0)
    for v in values:
        acc = np.float32(acc + np.float32(v))
    return acc


def test_finalize_rows_fixed_order_sum():
    """finalize_rows on a random (64, 40000) table of 7 genomes: counts
    equal the JAX finalize_rows', sums within rtol 1e-6 of them and
    bit-equal to each genome's sequential fold over its bins; a genome's
    sum is the same bits when the table holds only its bins (a shard)."""
    rng = np.random.default_rng(23)
    n_rg, n_qg, B_tot = 7, 64, 40_000
    gid_of_bin = np.sort(rng.integers(0, n_rg, B_tot)).astype(np.int32)
    ident = rng.uniform(76.0, 100.0, (n_qg, B_tot)).astype(np.float32)
    tab = np.where(rng.uniform(size=(n_qg, B_tot)) < 0.6,
                   ident.view(np.int32), -1).astype(np.int32)
    fin = np.arange(n_qg, dtype=np.int32)
    _, jc, js = jcgi.finalize_rows(
        jnp.asarray(tab), jnp.zeros((n_qg, n_rg), jnp.int32),
        jnp.zeros((n_qg, n_rg), jnp.float32), jnp.asarray(fin),
        jnp.asarray(gid_of_bin), n_qg, n_qg, n_rg)

    def port(t, gob, G):
        c = torch.zeros((n_qg, G), dtype=torch.int32)
        sm = torch.zeros((n_qg, G), dtype=torch.float32)
        device_cgi.finalize_rows(
            torch.from_numpy(t.copy()), c, sm,
            torch.from_numpy(fin.astype(np.int64)),
            torch.from_numpy(device_cgi.genome_bins(gob, G)), n_qg)
        return c.numpy(), sm.numpy()

    c, sm = port(tab, gid_of_bin, n_rg)
    np.testing.assert_array_equal(c, np.asarray(jc))
    np.testing.assert_allclose(sm, np.asarray(js), rtol=1e-6)
    for q in (0, 31, 63):
        for g in range(n_rg):
            row = tab[q, gid_of_bin == g]
            want = _sequential(row[row >= 0].view(np.float32))
            assert sm[q, g].view(np.int32) == want.view(np.int32), (q, g)
    g = 3
    cols = gid_of_bin == g
    c3, s3 = port(tab[:, cols], np.zeros(cols.sum(), np.int32), 1)
    np.testing.assert_array_equal(c3[:, 0], c[:, g])
    np.testing.assert_array_equal(s3[:, 0].view(np.int32),
                                  sm[:, g].view(np.int32))
