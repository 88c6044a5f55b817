"""The L2 event build split at its sort: E1 (``l2walk.events``), K4, E2
(``l2walk.events_scan``), on the CPU through their plain versions, on
``tests/test_torch_l2.py``'s repeat-rich streams and on edge units:

(a) ``events_plain`` -> K4's plain version -> ``events_scan_plain`` equals
    the unsplit ``build_events`` (kept below as it was before the split),
    bit for bit, in the six event rows and in s_u, overflow and n_ev;
(b) the same rows equal the JAX package's ``build_events`` (its argsort
    path) over each valid unit's first n_ev events, and s_u, overflow and
    n_ev over every unit;
(c) ``events_scan_recurrence`` (E2's one-pass design: running counts, a
    one-event look-ahead, the last leave carried) equals
    ``events_scan_plain``;
(d) edge units: an invalid unit, a window running past its contig's end,
    b0 clamped at 0 and at M - ncap, eL - b0 > ncap (overflow), and a few
    units at the record's limits, sketch width 1023 and ncap 1022;
(e) ``events_scan_segmented`` (E2's two-level scan, W warps a unit)
    equals ``events_scan_plain`` at W in {1, 2, 7, 16, 64} on the real
    chunk, the edge units and made-up units that hold each segment edge
    case;
(f) E1's one rank search: every sketch row is strictly increasing before
    its UMAX pads, and jr = ql + (q[ql] == h) (scap for h = UMAX) equals
    #{q <= h} on every entry of the real chunk.
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
from fastani_tpu_torch.ops.xputils import (PINF, UMAX, last_event_value,
                                           shift_right, u32_as_i32)
from tests import synth

# one intra-op thread: the suite runs several xdist workers per core, and
# torch's thread pool on top of them stalls every small CPU op
torch.set_num_threads(1)

B = 64
NAMES = ("dn", "dq", "jr", "jm", "scored", "pos")


def _build_events_unsplit(qh, s, frag_of_unit, u_sid, u_valid, b0, eL,
                          mi_hash, mi_sid, mi_wpos, prev_g, nxt_g,
                          frag_len, k, w, ncap):
    """``l2walk.build_events`` as it was before the split, K4 by its plain
    version: the reference of (a)."""
    CLAMP = l2walk.CLAMP
    U = u_sid.shape[0]
    M = mi_hash.shape[0]
    dev = qh.device
    C = frag_len - (w - 1) - (k - 1)
    sid = torch.where(u_valid, u_sid.to(torch.int64), 0)
    b0 = b0.clamp(0, M - ncap)
    offs = torch.arange(ncap, device=dev)
    idx = b0[:, None] + offs[None, :]
    in_contig = mi_sid[idx].to(torch.int64) == sid[:, None]
    lh = torch.where(in_contig, mi_hash[idx], UMAX)
    lp = torch.where(in_contig, mi_wpos[idx].to(torch.int64), PINF)
    pv = prev_g[idx] - b0[:, None]
    nx = nxt_g[idx] - b0[:, None]
    sw0 = torch.where(in_contig[:, 0], lp[:, 0], 0)
    overflow = u_valid & ((eL - b0) > ncap)
    eL_loc = (eL - b0).clamp(0, ncap)
    qh_u = qh[frag_of_unit]
    s_u = s[frag_of_unit]
    ql = torch.searchsorted(qh_u, lh)
    jr = torch.searchsorted(qh_u, lh, right=True)
    q_at = torch.gather(qh_u, 1, ql.clamp(max=qh_u.shape[-1] - 1))
    inq = (ql < s_u[:, None]) & (q_at == lh) & in_contig
    nonq = in_contig & ~inq
    rec_base = ql | (jr << 10) | (inq.long() << 20) | (nonq.long() << 21)
    rec_en = rec_base | ((pv.clamp(-1, ncap) + 1) << 22)
    rec_lv = shift_right(rec_base | (nx.clamp(0, ncap) << 22), 1, 0)
    va = torch.where((offs[None, :] >= 1) & in_contig, lp, PINF)
    vb = torch.where(in_contig, lp - C + 1, PINF)

    def pack(v, code):
        return ((v + C).clamp(max=CLAMP) << 2) | code

    keys0 = torch.cat([pack(vb, 0), pack(va, 1), pack(sw0[:, None], 2)],
                      1).to(torch.int32)
    pay0 = u32_as_i32(torch.cat(
        [rec_en, rec_lv, torch.zeros((U, 1), dtype=torch.int64, device=dev)],
        1))
    keys, rec = sort.sort_rows_u32_kv_plain(keys0, pay0)
    vt = keys >> 2
    code = keys & 3
    real = vt < CLAMP
    is_enter = (code == 0) & real
    is_leave = (code == 1) & real
    lb_t = torch.cumsum(is_leave, dim=-1)
    le_t = torch.cumsum(is_enter, dim=-1)
    pvnx = (rec >> 22) & 0x3FF
    eff = torch.where(is_enter, (pvnx - 1) < lb_t, pvnx >= le_t)
    sign = torch.where(is_enter, 1, -1)
    live = is_enter | is_leave
    dn = torch.where(live & eff & (((rec >> 21) & 1) != 0), sign, 0)
    dq = torch.where(live & eff & (((rec >> 20) & 1) != 0), sign, 0)
    run_end = torch.ones_like(real)
    run_end[:, :-1] = vt[:, :-1] != vt[:, 1:]
    scored = (run_end & real & (vt >= (sw0 + C)[:, None])
              & (le_t < eL_loc[:, None]) & u_valid[:, None])
    prop, _ = last_event_value(is_leave, torch.where(is_leave, vt - C, 0), 0)
    poslb = torch.where(lb_t > 0, prop, lp[:, :1])
    n_ev = real.sum(dim=-1)
    i32 = lambda x: x.to(torch.int32)
    ev = dict(dn=i32(dn), dq=i32(dq), jr=i32((rec >> 10) & 0x3FF),
              jm=i32(rec & 0x3FF), scored=i32(scored), pos=i32(poslb))
    return ev, i32(s_u), overflow, i32(n_ev)


def _split(args):
    """E1 -> K4 -> E2 by their plain versions; returns build_events'
    (ev, s_u, overflow, n_ev) and E2's inputs."""
    (qh, s, frag, u_sid, u_valid, b0, eL, mi_hash, mi_sid, mi_wpos, prev_g,
     nxt_g, frag_len, k, w, ncap) = args
    C = frag_len - (w - 1) - (k - 1)
    keys0, pay0, s_u, sw0, eL_loc, overflow, lp0 = l2walk.events_plain(
        qh, s, frag, u_sid, u_valid, b0, eL, mi_hash, mi_sid, mi_wpos,
        prev_g, nxt_g, C, ncap)
    assert keys0.dtype == pay0.dtype == torch.int32
    assert keys0.shape == (u_sid.shape[0], 2 * ncap + 1)
    scan_in = (*sort.sort_rows_u32_kv_plain(keys0, pay0), sw0, eL_loc,
               u_valid, lp0, C)
    ev, n_ev = l2walk.events_scan_plain(*scan_in)
    return (ev, s_u, overflow, n_ev), scan_in


def _same_rows(ev_g, ev_w, what=""):
    for name in NAMES:
        assert ev_g[name].dtype == torch.int32, name
        np.testing.assert_array_equal(ev_g[name].numpy(), ev_w[name].numpy(),
                                      f"{what} {name}")


def _same(got, want, what=""):
    ev_g, s_g, o_g, n_g = got
    ev_w, s_w, o_w, n_w = want
    _same_rows(ev_g, ev_w, what)
    for g, w, name in ((s_g, s_w, "s_u"), (o_g, o_w, "overflow"),
                       (n_g, n_w, "n_ev")):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w.numpy(), f"{what} {name}")


def _jax_build_events(args):
    """The JAX package's ``build_events`` on the same units and tables
    (its contiguous-window path, argsort on the CPU), in the JAX package's
    own dtypes: u32 hashes, int32 positions and links of its own."""
    (qh, s, frag, u_sid, u_valid, b0, eL, mi_hash, mi_sid, mi_wpos, _, _,
     frag_len, k, w, ncap) = args
    J = lambda x, dt: jnp.asarray(x.numpy().astype(dt))
    zeros = jnp.zeros(u_sid.shape[0], jnp.int32)
    ev, (s_u, overflow, n_ev) = jl2.build_events(
        J(qh, np.uint32), J(s, np.int32), J(frag, np.int32),
        J(u_sid, np.int32), zeros, zeros, J(u_valid, bool),
        J(mi_hash, np.uint32), J(mi_sid, np.int32), J(mi_wpos, np.int32),
        frag_len, k, w, ncap, begin_end=(J(b0, np.int32), J(eL, np.int32)))
    return ({n: np.asarray(v).astype(np.int32) for n, v in ev.items()},
            np.asarray(s_u), np.asarray(overflow), np.asarray(n_ev))


def _same_as_jax(args, got):
    ev, s_u, overflow, n_ev = got
    jev, js, jo, jn = _jax_build_events(args)
    np.testing.assert_array_equal(s_u.numpy(), js, "s_u")
    np.testing.assert_array_equal(overflow.numpy(), jo, "overflow")
    np.testing.assert_array_equal(n_ev.numpy(), jn, "n_ev")
    valid = args[4].numpy()
    for u in np.nonzero(valid)[0]:
        n = int(n_ev[u])
        for name in NAMES:
            np.testing.assert_array_equal(ev[name][u, :n].numpy(),
                                          jev[name][u, :n], f"{name} unit {u}")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The index, the mapper's tables and one batch's located units of
    tests/test_torch_l2.py: 40 fragments of a diverged strain and 24 of a
    repeat-rich contig (a 60 kbp block three times around 40
    near-identical tandem copies of a 700 bp unit)."""
    wd = tmp_path_factory.mktemp("torch_events")
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
    return cfg, t, u


@pytest.fixture(scope="module")
def chunk(world):
    """build_events' arguments for every valid unit of the batch, with
    every fifth unit marked invalid (a chunk tail's masked units)."""
    cfg, t, u = world
    args = list(jitmap.l2_chunk_args(cfg, t, u, slice(0, int(u["n_live"]))))
    args[4] = args[4].clone()
    args[4][::5] = False
    return tuple(args)


def _edge_args(world, case: str):
    """build_events' arguments for 12 real units with units 1-4 changed
    into the edge ``case``; "wide" keeps 5 units and widens the sketch to
    1023 words (UMAX pads) and ncap to 1022."""
    cfg, t, u = world
    args = list(jitmap.l2_chunk_args(cfg, t, u, slice(0, 12)))
    qh, u_valid, b0, eL = args[0], args[4].clone(), args[5].clone(), \
        args[6].clone()
    M = t.mi_hash.shape[0]
    ncap = args[15]
    sid = t.mi_sid.long()
    if case == "invalid":
        u_valid[1:5] = False
    elif case == "past_contig":
        # windows starting 10-400 entries before the last of contig 0
        last = int((sid == 0).nonzero().max())
        b0[1:5] = torch.tensor([last - 10, last - 100, last - 250,
                                last - 400])
        args[3] = args[3].clone()
        args[3][1:5] = 0
        eL[1:5] = b0[1:5] + ncap // 2
    elif case == "clamped":
        # b0 past M - ncap and below 0: clamped at both ends
        b0[1:5] = torch.tensor([M - 1, M - ncap + 3, -7, -1])
    elif case == "overflow":
        eL[1:5] = b0[1:5] + ncap + torch.tensor([1, 7, 300, 5000])
    elif case == "wide":
        args = [a[:5] if i in range(2, 7) and isinstance(a, torch.Tensor)
                else a for i, a in enumerate(args)]
        u_valid, b0, eL = args[4], args[5], args[6]
        pad = torch.full((qh.shape[0], 1023 - qh.shape[1]), UMAX,
                         dtype=qh.dtype)
        args[0] = torch.cat([qh, pad], dim=1)
        args[15] = 1022
    args[4], args[5], args[6] = u_valid, b0, eL
    return tuple(args)


def test_split_equals_unsplit(chunk):
    """(a), and build_events on CPU tensors is the split."""
    got, _ = _split(chunk)
    want = _build_events_unsplit(*chunk)
    _same(got, want, "split")
    _same(l2walk.build_events(*chunk), want, "build_events")
    ev, s_u, overflow, n_ev = got
    assert s_u.shape[0] > 100 and ev["dn"].shape[1] == 2 * 768 + 1
    assert int((ev["scored"].sum(dim=1) > 0).sum()) > 50


def test_split_matches_jax_build_events(chunk):
    """(b)."""
    got, _ = _split(chunk)
    _same_as_jax(chunk, got)


def test_scan_recurrence_equals_plain(chunk):
    """(c)."""
    (ev, _, _, n_ev), scan_in = _split(chunk)
    rev, rn = l2walk.events_scan_recurrence(*scan_in)
    _same_rows(rev, ev, "recurrence")
    np.testing.assert_array_equal(rn.numpy(), n_ev.numpy())


@pytest.mark.parametrize("case", ["invalid", "past_contig", "clamped",
                                  "overflow", "wide"])
def test_edge_units(world, case):
    """(d): the split against the unsplit code and the JAX build_events,
    and E2's recurrence against its plain version, on edge units."""
    args = _edge_args(world, case)
    got, scan_in = _split(args)
    _same(got, _build_events_unsplit(*args), case)
    _same_as_jax(args, got)
    rev, rn = l2walk.events_scan_recurrence(*scan_in)
    _same_rows(rev, got[0], case)
    _, s_u, overflow, n_ev = got
    np.testing.assert_array_equal(rn.numpy(), n_ev.numpy())
    b0 = args[5].clamp(0, args[7].shape[0] - args[15])
    if case == "invalid":
        assert not bool(args[4][1:5].any()) and not bool(overflow[1:5].any())
        assert int(got[0]["scored"][1:5].sum()) == 0
    elif case == "past_contig":
        # fewer real events than a window inside its contig (2 ncap: ncap
        # enters, ncap - 1 leaves, the scoring event)
        assert bool((n_ev[1:5] < 2 * args[15]).all())
    elif case == "clamped":
        M = args[7].shape[0]
        assert int(b0[1]) == int(b0[2]) == M - args[15]
        assert int(b0[3]) == int(b0[4]) == 0
    elif case == "overflow":
        assert bool(overflow[1:5].all())
    else:
        assert got[0]["dn"].shape == (5, 2 * 1022 + 1)


# (e): E2's two-level scan

def _segment_len(T, W):
    """The events of one of E2's W segments (csrc/events.cu)."""
    return 32 * -(-(-(-T // 32)) // W)


def _segment_facts(scan_in, W):
    """Which of the segment edge cases E2's inputs hold at W warps a unit:
    a segment with no leave whose carry comes from an earlier segment's
    leave, or from lp0 (no leave before it); a leave at a segment's last
    event; an equal-value run across a segment edge (both events real);
    T < 32 W; an all-pad unit; an invalid unit."""
    keys, u_valid = scan_in[0], scan_in[4]
    U, T = keys.shape
    S = _segment_len(T, W)
    pad = torch.full((U, W * S - T), l2walk.CLAMP << 2, dtype=keys.dtype)
    k = torch.cat([keys, pad], 1).view(U, W, S)
    vt = k >> 2
    real = vt < l2walk.CLAMP
    leave = ((k & 3) == 1) & real
    n_seg = -(-T // S)                       # segments holding events
    has = leave[:, :n_seg].any(-1)
    before = (torch.cumsum(has.int(), 1) - has.int()) > 0
    facts = set()
    if n_seg > 1:
        later = ~has[:, 1:]
        if bool((later & before[:, 1:]).any()):
            facts.add("carry from an earlier segment")
        if bool((later & ~before[:, 1:]).any()):
            facts.add("carry from lp0")
        edge = torch.arange(1, n_seg) * S
        if bool(leave[:, :n_seg - 1, -1].any()):
            facts.add("leave at a segment's end")
        flat_vt, flat_real = keys >> 2, (keys >> 2) < l2walk.CLAMP
        if bool(((flat_vt[:, edge - 1] == flat_vt[:, edge])
                 & flat_real[:, edge - 1] & flat_real[:, edge]).any()):
            facts.add("run across a segment edge")
    if T < 32 * W:
        facts.add("T < 32 W")
    if bool((~real.any(-1).any(-1)).any()):
        facts.add("all-pad unit")
    if bool((~u_valid).any()):
        facts.add("invalid unit")
    return facts


def _made_up_scan(T, W, seed):
    """E2's inputs for 8 made-up units of T events: sorted values with
    runs, codes and records at random, a few pads at each row's end, then
    units 1-5 changed so that at W warps each segment edge case holds:
    leaves only in the first segment (1), none before the third (2), a
    leave at the first segment's last event (3), a real equal-value run
    across the first edge (4), all pads (5); units 6 and 7 invalid."""
    rng = np.random.default_rng(seed)
    U = 8
    S = _segment_len(T, W)
    vals = np.sort(rng.integers(0, T // 3 + 2, (U, T)), axis=1) + 1000
    code = rng.integers(0, 3, (U, T))
    n_pad = rng.integers(0, max(2, T // 8), U)
    for u in range(U):
        if n_pad[u]:
            vals[u, -n_pad[u]:] = l2walk.CLAMP
    at = np.arange(T)
    code[1] = np.where(at < S, code[1], 2 * rng.integers(0, 2, T))
    code[2] = np.where(at < 2 * S, 2 * rng.integers(0, 2, T), code[2])
    vals[3:5, :S + 2] = np.minimum(vals[3:5, :S + 2], l2walk.CLAMP - 1)
    if S < T:
        code[3, S - 1] = 1
        vals[4, S - 2: S + 2] = vals[4, S - 2]
    vals[5] = l2walk.CLAMP
    keys = torch.from_numpy((vals << 2 | code).astype(np.int32))
    rec = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (U, T),
                                        dtype=np.int64).astype(np.int32))
    sw0 = torch.from_numpy(rng.integers(0, 50, U).astype(np.int32))
    eL_loc = torch.from_numpy(rng.integers(0, T // 2 + 1, U)
                              .astype(np.int32))
    u_valid = torch.tensor([True] * 6 + [False] * 2)
    lp0 = torch.from_numpy(rng.integers(0, 10 ** 6, U).astype(np.int32))
    return keys, rec, sw0, eL_loc, u_valid, lp0, 777


@pytest.mark.parametrize("W", [1, 2, 7, 16, 64])
def test_scan_segmented_equals_plain(chunk, world, W):
    """(e): on the real chunk (T 1537), the edge units' (the "wide" case:
    T 2045) and made-up units at T 21 and 2045, the two-level scan equals
    the plain version bit for bit; every segment edge case occurs at W
    among these inputs (those that need two segments, at W > 1)."""
    inputs = [_split(chunk)[1]]
    inputs += [_split(_edge_args(world, case))[1]
               for case in ("invalid", "past_contig", "wide")]
    inputs += [_made_up_scan(T, W, seed=T + W) for T in (21, 2045)]
    facts = set()
    for scan_in in inputs:
        ev, n_ev = l2walk.events_scan_plain(*scan_in)
        sev, sn = l2walk.events_scan_segmented(*scan_in, W)
        _same_rows(sev, ev, f"W {W} T {scan_in[0].shape[1]}")
        np.testing.assert_array_equal(sn.numpy(), n_ev.numpy())
        facts |= _segment_facts(scan_in, W)
    want = {"T < 32 W", "all-pad unit", "invalid unit"}
    if W > 1:
        want |= {"carry from an earlier segment", "carry from lp0",
                 "leave at a segment's end", "run across a segment edge"}
    assert want <= facts, want - facts


# (f): E1's one rank search

def test_sketch_rows_unique_before_pads(world, chunk):
    """The precondition of E1's one search: each sketch row of the
    fixture's batch (and of the "wide" edge, padded to 1023 words) is
    strictly increasing before its UMAX pads, which fill the rest."""
    for qh in (chunk[0], _edge_args(world, "wide")[0]):
        real = qh != UMAX
        n = real.sum(1)
        assert bool((real == (torch.arange(qh.shape[1])[None, :]
                              < n[:, None])).all())
        q = torch.where(real, qh, torch.iinfo(torch.int64).max)
        assert bool(((q[:, 1:] > q[:, :-1]) | ~real[:, 1:]).all())
        assert int(n.min()) > 0 and int(n.max()) < qh.shape[1]


@pytest.mark.parametrize("case", ["chunk", "past_contig"])
def test_one_search_rank(world, chunk, case):
    """(f): jr = ql + (q[ql] == h), and scap for h = UMAX, equals
    ``searchsorted(right=True)`` on every entry of the units (the entries
    outside the unit's contig, h = UMAX, included)."""
    args = chunk if case == "chunk" else _edge_args(world, case)
    qh, frag, u_sid, u_valid, b0 = args[0], args[2], args[3], args[4], \
        args[5]
    mi_hash, mi_sid, ncap = args[7], args[8], args[15]
    M, scap = mi_hash.shape[0], qh.shape[1]
    sid = torch.where(u_valid, u_sid.long(), 0)
    idx = b0.clamp(0, M - ncap)[:, None] + torch.arange(ncap)[None, :]
    lh = torch.where(mi_sid[idx].long() == sid[:, None], mi_hash[idx], UMAX)
    q = qh[frag]
    ql = torch.searchsorted(q, lh)
    q_at = torch.gather(q, 1, ql.clamp(max=scap - 1))
    jr = torch.where(lh == UMAX, scap, ql + ((ql < scap) & (q_at == lh)))
    assert torch.equal(jr, torch.searchsorted(q, lh, right=True))
    assert bool((lh == UMAX).any()) and bool(((lh != UMAX)
                                              & (q_at == lh)).any())
