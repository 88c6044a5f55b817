"""The port's sketch, L1, L2 and packed map step against the JAX package on
one index (the JAX device build, handed to the port with ``from_numpy``):
integer outputs bit-equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastani_tpu.config import Parameters as JParams
from fastani_tpu.index.sketch import ReferenceIndex as JIndex
from fastani_tpu.models import jitmap as jjit
from fastani_tpu.models import l2walk as jl2
from fastani_tpu.models import mapping as jmap
from fastani_tpu.ops import stats as jstats
from fastani_tpu_torch.config import Parameters
from fastani_tpu_torch.index.sketch import ReferenceIndex
from fastani_tpu_torch.models import jitmap, l2walk, mapping
from tests import synth

# one intra-op thread: the suite runs several xdist workers per core, and
# torch's thread pool on top of them stalls every small CPU op
torch.set_num_threads(1)

B = 64


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    wd = tmp_path_factory.mktemp("torch_map")
    rng = np.random.default_rng(2024)
    base = synth.random_genome(rng, 150_000)
    a = synth.mutate_genome(rng, base, 0.02, 0.0003)
    b = synth.mutate_genome(rng, base, 0.05, 0.0005)
    synth.write_fasta(wd / "a.fa", [("a", a)])
    synth.write_fasta(wd / "b.fa", [("b1", b[:70_000]), ("b2", b[70_000:])])
    refs = [str(wd / "a.fa"), str(wd / "b.fa")]
    jp = JParams(ref_sequences=refs, frag_batch=B).finalize()
    jidx = JIndex.build_device(jp)
    arrays = {f: np.asarray(getattr(jidx, f)) for f in (
        "mi_hash", "mi_seqid", "mi_wpos", "occ_hash", "occ_seqid",
        "occ_wpos", "occ_order")}
    arrays["n_entries"] = int(jidx.num_entries)
    arrays["sequences_by_file"] = jidx.sequences_by_file
    tp = Parameters(ref_sequences=refs, frag_batch=B).finalize()
    tidx = ReferenceIndex.from_numpy(
        arrays, [(c.name, c.length) for c in jidx.metadata], "cpu")
    q = synth.mutate_genome(rng, base, 0.03, 0.0003)
    frags = q[: 50 * 3000].reshape(50, 3000)
    frags = np.concatenate([frags, synth.random_genome(rng, 3000)[None]])
    return jp, jidx, tp, tidx, frags


@pytest.mark.parametrize("layout", ["u32_keys", "u64_keys", "u32_keys_bit31"])
def test_sketch_and_l1_match_numpy_backend(world, layout):
    """Sketch and L1 against the JAX numpy backend, with the hit keys packed
    in int32 words (u32_keys), in int64 (u64_keys), and packed with every
    seqId offset by 1 << (31 - wpos_bits) in both, so that bit 31 of every
    packed key is set (u32_keys_bit31)."""
    jp, jidx, tp, tidx, frags = world
    k, w, l = jp.kmer_size, jp.window_size, jp.frag_len
    want_qh, want_s, want_ov = jmap.sketch_fragments(np, frags, k, w,
                                                     jp.sketch_cap)
    qh, s, ov = mapping.sketch_fragments(torch.from_numpy(frags), k, w,
                                         tp.sketch_cap)
    np.testing.assert_array_equal(qh.numpy(), want_qh.astype(np.int64))
    np.testing.assert_array_equal(s.numpy(), want_s)
    np.testing.assert_array_equal(ov.numpy(), want_ov)

    n = int(jidx.num_entries)
    occ_h = np.asarray(jidx.occ_hash)[:n]
    occ_s = np.asarray(jidx.occ_seqid)[:n]
    occ_w = np.asarray(jidx.occ_wpos)[:n]
    lut = jstats.min_hits_lut(k, jp.percentage_identity, jp.sketch_cap)
    hits_cap, cand_cap = 2048, 16
    wpos_bits = None if layout == "u64_keys" else jitmap.MapperConfig.from_params(
        tp, tidx.freq_threshold, index=tidx).wpos_bits
    off = 1 << (31 - wpos_bits) if layout == "u32_keys_bit31" else 0
    want = jmap.l1_candidates(np, want_qh, want_s, occ_h, occ_s + off, occ_w,
                              lut, jidx.freq_threshold, l, hits_cap, cand_cap)
    keys = mapping.hit_keys(tidx.occ_seqid + off, tidx.occ_wpos, n, wpos_bits)
    assert keys.dtype == (torch.int64 if wpos_bits is None else torch.int32)
    if off:
        assert bool((keys[:n] < -1).all())            # bit 31 set, not pads
    got = mapping.l1_candidates(
        qh, s, tidx.occ_hash, keys, n, torch.from_numpy(lut.astype(np.int64)),
        tidx.freq_threshold, l, hits_cap, cand_cap, wpos_bits)
    valid = np.asarray(want.valid)
    assert valid.sum() > 50
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    for f in ("sid", "start", "end"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[valid],
                                      np.asarray(getattr(want, f))[valid], f)
    for f in ("overflow", "n_hits", "n_groups"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


def test_l2_events_and_walk_match_jax(world):
    """build_events + the plain walk vs l2walk.build_events + walk_scan:
    shared, mean_pos, valid and overflow equal."""
    jp, jidx, tp, tidx, frags = world
    k, w, l = jp.kmer_size, jp.window_size, jp.frag_len
    ncap = jp.l2_entry_cap
    qh, s, _ = jmap.sketch_fragments(np, frags, k, w, jp.sketch_cap)
    n = int(jidx.num_entries)
    lut = jstats.min_hits_lut(k, jp.percentage_identity, jp.sketch_cap)
    l1 = jmap.l1_candidates(np, qh, s, np.asarray(jidx.occ_hash)[:n],
                            np.asarray(jidx.occ_seqid)[:n],
                            np.asarray(jidx.occ_wpos)[:n], lut,
                            jidx.freq_threshold, l, 2048, 16)
    fi, ci = np.nonzero(np.asarray(l1.valid))
    u_frag = fi.astype(np.int32)
    u_sid = np.asarray(l1.sid)[fi, ci]
    u_start = np.asarray(l1.start)[fi, ci]
    u_end = np.asarray(l1.end)[fi, ci]
    u_valid = np.ones(len(fi), bool)
    u_valid[::5] = False                  # masked units as in a chunk tail
    want = jl2.l2_walk_units(
        jnp.asarray(qh), jnp.asarray(s), jnp.asarray(u_frag),
        jnp.asarray(u_sid), jnp.asarray(u_start), jnp.asarray(u_end),
        jnp.asarray(u_valid), jidx.mi_hash, jidx.mi_seqid, jidx.mi_wpos,
        l, k, w, ncap, backend="scan")

    mapper = jitmap.Mapper(tp, tidx)
    t = mapper.tables
    T = lambda a: torch.from_numpy(np.asarray(a))
    sid_m = torch.where(T(u_valid), T(u_sid).long(), 0)
    b0 = mapping._searchsorted_pairs(t.mi_sid, t.mi_wpos, sid_m,
                                     T(u_start).long())
    eL = mapping._searchsorted_pairs(t.mi_sid, t.mi_wpos, sid_m,
                                     T(u_end).long() + l)
    got = l2walk.l2_walk_units(
        T(qh.astype(np.int64)), T(s).long(), T(u_frag).long(), T(u_sid),
        T(u_valid), b0, eL, t.mi_hash, t.mi_sid, t.mi_wpos, t.mi_prev,
        t.mi_nxt, l, k, w, ncap)
    for g, name in zip(got, ("shared", "mean_pos", "valid", "overflow")):
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(getattr(want, name)), name)
    assert int(got[2].sum()) > 20


def test_map_step_packed_matches_jax(world):
    """One batch through both mappers: packed[:, :n_valid], the 11 counts
    and the fallback mask equal."""
    jp, jidx, tp, tidx, frags = world
    F = len(frags)
    jm = jjit.JitMapper(jp, jidx, unit_factor=4, unit_chunk=32)
    qno = np.zeros(F, np.int32)
    qsid = np.arange(F, dtype=np.int32) + 100
    h = jm.dispatch(frags, qno, qsid)
    want = {key: np.asarray(h["out"][key]) for key in
            ("packed", "counts", "fallback_mask")}

    mapper = jitmap.Mapper(tp, tidx, unit_factor=4, unit_chunk=32)
    pad = np.zeros((B, frags.shape[1]), np.uint8)
    pad[:F] = frags
    rv = torch.arange(B) < F
    padi = lambda a: torch.from_numpy(np.concatenate(
        [a, np.zeros(B - F, np.int32)]))
    got = jitmap.map_step_packed(mapper.cfg, torch.from_numpy(pad),
                                 mapper.tables, padi(qno), padi(qsid), rv)
    counts = got["counts"].numpy()
    np.testing.assert_array_equal(counts, want["counts"].astype(np.int64))
    assert len(jitmap.COUNT_NAMES) == len(counts) == 11
    n = int(counts[0])
    assert n > 30
    np.testing.assert_array_equal(got["packed"].numpy()[:, :n],
                                  want["packed"][:, :n])
    np.testing.assert_array_equal(got["fallback_mask"].numpy(),
                                  want["fallback_mask"])
