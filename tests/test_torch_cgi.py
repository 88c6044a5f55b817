"""The port's device CGI fold (update_tab, finalize_rows) against the JAX
package's on the same packed batches: counts equal, sums within rtol 1e-6
(float32 sums taken in another order)."""

import numpy as np
import torch

import jax.numpy as jnp

from fastani_tpu.models import device_cgi as jcgi
from fastani_tpu_torch.models import device_cgi

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
            device_cgi.finalize_rows(tab_t, acc_ct, acc_st,
                                     torch.from_numpy(f.astype(np.int64)),
                                     torch.from_numpy(gid_of_bin), n_slots,
                                     n_rg)
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
