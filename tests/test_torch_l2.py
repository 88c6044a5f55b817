"""The L2 event walk on real event streams (the port's own index, sketch,
L1 and ``build_events`` on the CPU, with a repeat-rich contig so that equal
hashes meet in one window), and the int32 event sort:

(a) along every stream, m stays strictly increasing and every presence
    stays 0 or 1 — the precondition of K5's O(1)-per-event design;
(b) ``walk_recurrence`` (K5's recurrence restated in plain PyTorch) equals
    ``walk_plain`` and the JAX package's ``walk_scan`` on those streams;
(c) the K4 plain version on int32 words (bit 31 set, tied keys) equals its
    int64 path and the JAX package's stable argsort path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastani_tpu.models import l2walk as jl2
from fastani_tpu_torch.config import Parameters
from fastani_tpu_torch.index.sketch import ReferenceIndex
from fastani_tpu_torch.models import jitmap, l2walk
from fastani_tpu_torch.ops import sort
from fastani_tpu_torch.ops.xputils import u32_as_i32
from tests import synth

# one intra-op thread: the suite runs several xdist workers per core, and
# torch's thread pool on top of them stalls every small CPU op
torch.set_num_threads(1)

B = 64


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """(ev, s_u, n_ev, scap) of every valid unit of one batch: 40
    fragments of a diverged strain and 24 of a repeat-rich contig (a 60
    kbp block three times around 40 near-identical tandem copies of a 700
    bp unit)."""
    wd = tmp_path_factory.mktemp("torch_l2")
    rng = np.random.default_rng(77)
    base = synth.random_genome(rng, 150_000)
    unit = synth.random_genome(rng, 700)
    tandem = np.concatenate([synth.mutate_genome(rng, unit, 0.01, 0.0)
                             for _ in range(40)])
    block = synth.random_genome(rng, 60_000)
    rep = np.concatenate([block, synth.random_genome(rng, 5000), block,
                          tandem, block])
    a = synth.mutate_genome(rng, base, 0.02, 0.0003)
    b = synth.mutate_genome(rng, base, 0.05, 0.0005)
    synth.write_fasta(wd / "a.fa", [("a", a), ("rep", rep)])
    synth.write_fasta(wd / "b.fa", [("b1", b[:70_000]), ("b2", b[70_000:])])
    params = Parameters(ref_sequences=[str(wd / "a.fa"), str(wd / "b.fa")],
                        frag_batch=B).finalize()
    mapper = jitmap.Mapper(params, ReferenceIndex.build_device(params,
                                                               device="cpu"))
    q = synth.mutate_genome(rng, base, 0.03, 0.0003)
    qrep = synth.mutate_genome(rng, rep[100_000:200_000], 0.01, 0.0)
    frags = np.concatenate([q[: 40 * 3000].reshape(40, 3000),
                            qrep[: 24 * 3000].reshape(24, 3000)])
    cfg, t = mapper.cfg, mapper.tables
    u = jitmap.locate_units(cfg, torch.from_numpy(frags), t)
    ev, s_u, _, n_ev = l2walk.build_events(
        *jitmap.l2_chunk_args(cfg, t, u, slice(0, u["n_live"])))
    return ev, s_u, n_ev, cfg.sketch_cap


def test_streams_keep_the_walk_invariant(streams):
    ev, s_u, n_ev, scap = streams
    U, T = ev["dn"].shape
    assert U > 100 and T == 2 * 768 + 1
    # equal hashes meet in one window: real events that change neither m
    # nor pres (a duplicate of a hash already in the window; one such event
    # a unit is the synthetic scoring event)
    t_idx = torch.arange(T)[None, :]
    inert = ((t_idx < n_ev[:, None]) & (ev["dn"] == 0) & (ev["dq"] == 0))
    assert int((inert.sum(dim=1) > 100).sum()) >= 5
    jrow = torch.arange(scap, dtype=torch.int32)[None, :]
    m = jrow.expand(U, scap).clone()
    pres = torch.zeros((U, scap), dtype=torch.int32)
    for t in range(int(n_ev.max())):
        live = (t < n_ev).int()
        m += (ev["dn"][:, t] * live)[:, None] * (jrow >= ev["jr"][:, t, None])
        pres += (ev["dq"][:, t] * live)[:, None] * (jrow == ev["jm"][:, t, None])
        assert bool((m[:, 0] >= 0).all()), t
        assert bool((m[:, 1:] > m[:, :-1]).all()), t
        assert bool(((pres == 0) | (pres == 1)).all()), t


def test_walk_recurrence_matches_plain_and_jax(streams):
    ev, s_u, n_ev, scap = streams
    got = l2walk.walk_recurrence(ev, s_u, n_ev, scap)
    plain = l2walk.walk_plain(ev, s_u, n_ev, scap)
    jev = {k: jnp.asarray(v.numpy()) for k, v in ev.items()}
    jev["scored"] = jev["scored"] != 0
    want = jl2.walk_scan(jev, jnp.asarray(s_u.numpy()), scap)
    for g, p, w, name in zip(got, plain, want, ("best", "posf", "posl")):
        np.testing.assert_array_equal(g.numpy(), p.numpy(), name)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    assert int((got[0] > 0).sum()) > 50


@pytest.mark.parametrize("n", [2033, 1000, 300])
def test_sort_kv_plain_int32_matches_int64_and_jax(n):
    """Keys with bit 31 set and ties, payload over all 32 bits: the int32
    words sort as u32, equal to the int64 carrier and to a stable argsort
    (the JAX event merge's non-Pallas path, models/l2walk.py:226-229)."""
    rng = np.random.default_rng(n)
    R = 4
    keys = rng.integers(0, 2 ** 32, (R, n), dtype=np.uint32)
    keys[:, ::3] = keys[:, :1]                        # ties
    keys[0, :4] = [0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0]
    pay = rng.integers(0, 2 ** 32, (R, n), dtype=np.uint32)
    k64 = torch.from_numpy(keys.astype(np.int64))
    p64 = torch.from_numpy(pay.astype(np.int64))
    ko32, po32 = sort.sort_rows_u32_kv(u32_as_i32(k64), u32_as_i32(p64))
    assert ko32.dtype == po32.dtype == torch.int32
    ko64, po64 = sort.sort_rows_u32_kv(k64, p64)
    np.testing.assert_array_equal(ko32.numpy(), u32_as_i32(ko64).numpy())
    np.testing.assert_array_equal(po32.numpy(), u32_as_i32(po64).numpy())
    order = jnp.argsort(jnp.asarray(keys), axis=-1, stable=True)
    want_k = np.asarray(jnp.take_along_axis(jnp.asarray(keys), order, -1))
    want_p = np.asarray(jnp.take_along_axis(jnp.asarray(pay), order, -1))
    np.testing.assert_array_equal(ko32.numpy().view(np.uint32), want_k)
    np.testing.assert_array_equal(po32.numpy().view(np.uint32), want_p)
