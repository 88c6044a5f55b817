"""Event-walk L2 (counterpart of ``fastani_tpu/models/l2walk.py``).

Reference semantics: src/map/include/computeMap.hpp:418-497 (window loop),
slidingMap.hpp:137-284 (bottom-s maintenance), MIIteratorL2.hpp:74-96
(event-driven window advance).  With QH = {q_0 < ... < q_{s-1}} the
fragment's sketch and RH(W) the reference hashes in super-window W,

    m_j(W) = j + #{distinct h in RH(W) \\ QH : h < q_j}

is strictly increasing in j, so sharedSketchElements(W) = #{j < j* : q_j in
RH(W)} with j* = #{j : m_j < s}.  Every window event inserts or deletes one
reference entry, which moves m_j by +-1 for all j >= jr (a non-query
entry whose hash becomes or stops being distinct in the window) or flips
one query rank's presence.

``build_events`` serializes each unit's events: E1 (``events``) packs each
entry's event keys and records, K4 sorts each row of keys with the records
as payload (both int32 words), E2 (``events_scan``) makes one ordered pass
over the sorted events; ``walk`` runs them (K5).  The three kernels are
csrc/events.cu, csrc/sort.cu and csrc/walk.cu on CUDA tensors; on CPU
tensors each wrapper runs its plain version (``events_plain``,
``events_scan_plain``, ``walk_plain``; ``events_scan_recurrence`` restates
E2's pass event by event, ``events_scan_segmented`` its two-level
scan).  K5 relies on the invariant above: along every stream
``build_events`` makes, m stays strictly increasing and every presence
stays 0 or 1, so j* moves by at most one rank per event and the kernel
does O(1) work per event (``walk_recurrence`` restates its recurrence).
"""

from __future__ import annotations

import ctypes

import torch

from fastani_tpu_torch.ops import cuda, sort
from fastani_tpu_torch.ops.xputils import (PINF, UMAX, last_event_value,
                                           shift_left, shift_right,
                                           u32_as_i32)

CLAMP = 1 << 28      # event values clamp here; anything >= is a pad
NOSCORE = -5         # below the best-tracker init (-1)
MAX_SCAP = 1023      # the packed event records hold ranks in 10 bits
MAX_NCAP = 1022
# the six (U, T) int32 event rows, in the order K5 takes them
_EVENTS = ("dn", "dq", "jr", "jm", "scored", "pos")
WALK_BLOCK_UNITS = 32   # units a K5 block walks, one a lane of one warp


def prev_next_global(mi_hash, mi_sid, order):
    """Per-entry previous/next same-(hash, seqId) occurrence in build order.

    ``order`` is the stable argsort of mi_hash (the index's occ_order):
    equal hashes are then grouped with same-seqId runs contiguous and
    wpos-ascending, so adjacent pairs are the immediate neighbours.
    Returns (prev, nxt) int64: prev = -1 / nxt = 2^30 when none."""
    M = mi_hash.shape[0]
    oh = mi_hash[order]
    os_ = mi_sid[order]
    same = (oh[1:] == oh[:-1]) & (os_[1:] == os_[:-1])
    neg = torch.full((1,), -1, dtype=torch.int64, device=order.device)
    inf = torch.full((1,), PINF, dtype=torch.int64, device=order.device)
    prev_occ = torch.cat([neg, torch.where(same, order[:-1], -1)])
    nxt_occ = torch.cat([torch.where(same, order[1:], PINF), inf])
    prev_g = torch.empty(M, dtype=torch.int64, device=order.device)
    nxt_g = torch.empty(M, dtype=torch.int64, device=order.device)
    prev_g[order] = prev_occ
    nxt_g[order] = nxt_occ
    return prev_g, nxt_g


def build_events(qh, s, frag_of_unit, u_sid, u_valid, b0, eL, mi_hash,
                 mi_sid, mi_wpos, prev_g, nxt_g, frag_len: int, k: int,
                 w: int, ncap: int):
    """The serialized event stream of a chunk of units: E1 (``events``),
    K4 (``sort.sort_rows_u32_kv``), E2 (``events_scan``).

    b0/eL: each unit's first entry at or after its range start and the end
    of its last window (lower bounds over (seqId, wpos)).  The index arrays
    carry >= ncap sentinel entries past the last real one, so every unit's
    entry window [b0, b0 + ncap) is a contiguous slice.

    Returns (ev, s_u, overflow, n_ev): ev is a dict of (U, T) int32 arrays,
    T = 2*ncap + 1 — the sorted merge of enter events (value lp[i]-C+1),
    leave events (value lp[i], i >= 1) and one scoring event at the initial
    window value sw0 (codes 0/1/2: within an equal-value run enters sort
    first and the synthetic last, the run-final evaluation of
    MIIteratorL2::next)."""
    if qh.shape[-1] > MAX_SCAP or ncap > MAX_NCAP:
        raise ValueError(f"sketch_cap {qh.shape[-1]} / l2_entry_cap {ncap} "
                         f"exceed the packed event record ({MAX_SCAP}/"
                         f"{MAX_NCAP})")
    C = frag_len - (w - 1) - (k - 1)   # countMinimizerWindows, computeMap.hpp:428
    keys0, pay0, s_u, sw0, eL_loc, overflow, lp0 = events(
        qh, s, frag_of_unit, u_sid, u_valid, b0, eL, mi_hash, mi_sid,
        mi_wpos, prev_g, nxt_g, C, ncap)
    keys, rec = sort.sort_rows_u32_kv(keys0, pay0)
    # E1's (U, T) rows die once K4 has read them: inside a captured chunk
    # the graph's pool gives their memory to E2's rows
    del keys0, pay0
    ev, n_ev = events_scan(keys, rec, sw0, eL_loc, u_valid, lp0, C)
    return ev, s_u, overflow, n_ev


# E1's table arguments and the dtypes the kernel reads them in
_E1_DTYPES = (("qh", torch.int64), ("s", torch.int64),
              ("frag_of_unit", torch.int64), ("u_sid", torch.int32),
              ("u_valid", torch.bool), ("b0", torch.int64),
              ("eL", torch.int64), ("mi_hash", torch.int64),
              ("mi_sid", torch.int32), ("mi_wpos", torch.int32),
              ("prev_g", torch.int64), ("nxt_g", torch.int64))


def events(qh, s, frag_of_unit, u_sid, u_valid, b0, eL, mi_hash, mi_sid,
           mi_wpos, prev_g, nxt_g, C: int, ncap: int):
    """E1: each unit's event keys and records, the input of K4.  Returns
    (keys0, pay0, s_u, sw0, eL_loc, overflow, lp0): keys0 and pay0 (U, T)
    int32 words, T = 2*ncap + 1; s_u, sw0, eL_loc and lp0 (the position of
    the unit's first entry, PINF outside its contig) (U,) int32; overflow
    (U,) bool.  csrc/events.cu on CUDA tensors, ``events_plain`` on CPU
    tensors.

    Each row of ``qh`` must be unique and strictly ascending before its
    UMAX pads, as ``mapping.sketch_fragments`` makes it: the kernel finds
    jr = #{q <= h} as ql + (q[ql] == h) from its one search, where
    ``events_plain`` searches again, so a row with a repeated hash would
    give other records on the card than on the CPU, unreported."""
    if qh.device.type == "cpu":
        return events_plain(qh, s, frag_of_unit, u_sid, u_valid, b0, eL,
                            mi_hash, mi_sid, mi_wpos, prev_g, nxt_g, C, ncap)
    args = (qh, s, frag_of_unit, u_sid, u_valid, b0, eL, mi_hash, mi_sid,
            mi_wpos, prev_g, nxt_g)
    for (name, dt), a in zip(_E1_DTYPES, args):
        if a.dtype != dt:
            raise ValueError(f"events: {name} must be {dt}, got {a.dtype}")
    args = [a.contiguous() for a in args]
    cuda.require_cuda("events", *args)
    U, scap, M = u_sid.shape[0], qh.shape[-1], mi_hash.shape[0]
    if not 1 <= scap <= MAX_SCAP or not 1 <= ncap <= min(MAX_NCAP, M):
        raise ValueError(f"events: sketch width {scap}, ncap {ncap} over "
                         f"{M} entries")
    dev = qh.device
    T = 2 * ncap + 1
    keys0 = torch.empty((U, T), dtype=torch.int32, device=dev)
    pay0 = torch.empty((U, T), dtype=torch.int32, device=dev)
    per_unit = torch.empty((4, U), dtype=torch.int32, device=dev)
    overflow = torch.empty(U, dtype=torch.bool, device=dev)
    if U:
        err = cuda.lib("events").fa_events(
            *[a.data_ptr() for a in args], U, M, scap, ncap, C,
            keys0.data_ptr(), pay0.data_ptr(),
            *[row.data_ptr() for row in per_unit[:3]], overflow.data_ptr(),
            per_unit[3].data_ptr(), cuda.stream())
        cuda.check(err, "events")
        cuda.LAUNCHES["events"] += 1
    s_u, sw0, eL_loc, lp0 = per_unit
    return keys0, pay0, s_u, sw0, eL_loc, overflow, lp0


def events_plain(qh, s, frag_of_unit, u_sid, u_valid, b0, eL, mi_hash,
                 mi_sid, mi_wpos, prev_g, nxt_g, C: int, ncap: int):
    """Plain PyTorch version of E1 (what ``build_events`` ran before K4)."""
    U = u_sid.shape[0]
    M = mi_hash.shape[0]
    dev = qh.device
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

    # per-entry query ranks: ql = #{q < h}, jr = #{q <= h} over the sorted,
    # UMAX-padded sketch row; the entry is a query hash if q_ql == h, ql < s
    qh_u = qh[frag_of_unit]
    s_u = s[frag_of_unit]
    ql = torch.searchsorted(qh_u, lh)
    jr = torch.searchsorted(qh_u, lh, right=True)
    q_at = torch.gather(qh_u, 1, ql.clamp(max=qh_u.shape[-1] - 1))
    inq = (ql < s_u[:, None]) & (q_at == lh) & in_contig
    nonq = in_contig & ~inq

    # event records ride the merge sort as payload: ranks, flags and the
    # clipped prev link (enters) / next link (leaves); the j-th enter event
    # is entry j-1's and the j-th leave evicts entry j-1, so the leave
    # records shift right by one.  The link sits in bits 22-31, so a record
    # as an int32 word may be negative: every field read below is masked
    rec_base = ql | (jr << 10) | (inq.long() << 20) | (nonq.long() << 21)
    rec_en = rec_base | ((pv.clamp(-1, ncap) + 1) << 22)
    rec_lv = shift_right(rec_base | (nx.clamp(0, ncap) << 22), 1, 0)

    # serialized event merge: key = min(value + C, CLAMP) << 2 | code
    va = torch.where((offs[None, :] >= 1) & in_contig, lp, PINF)    # leaves
    vb = torch.where(in_contig, lp - C + 1, PINF)                   # enters

    def pack(v, code):
        return ((v + C).clamp(max=CLAMP) << 2) | code

    # keys stay below 2^31 ((CLAMP << 2) | 3); both travel as int32 words
    keys0 = torch.cat([pack(vb, 0), pack(va, 1), pack(sw0[:, None], 2)],
                      1).to(torch.int32)
    pay0 = u32_as_i32(torch.cat(
        [rec_en, rec_lv, torch.zeros((U, 1), dtype=torch.int64, device=dev)],
        1))
    i32 = lambda x: x.to(torch.int32)
    return (keys0, pay0, i32(s_u), i32(sw0), i32(eL_loc), overflow,
            i32(lp[:, 0]))


def events_scan(keys, rec, sw0, eL_loc, u_valid, lp0, C: int):
    """E2: the ordered pass over each unit's sorted events (K4's output).
    Returns (ev, n_ev): ev the dict of the six (U, T) int32 rows K5 walks,
    n_ev (U,) int32.  csrc/events.cu on CUDA tensors,
    ``events_scan_plain`` on CPU tensors."""
    if keys.device.type == "cpu":
        return events_scan_plain(keys, rec, sw0, eL_loc, u_valid, lp0, C)
    args = (keys, rec, sw0, eL_loc, u_valid, lp0)
    want = (torch.int32,) * 4 + (torch.bool, torch.int32)
    if any(a.dtype != dt for a, dt in zip(args, want)):
        raise ValueError("events_scan: keys, rec, sw0, eL_loc and lp0 must "
                         "be int32 and u_valid bool")
    args = [a.contiguous() for a in args]
    cuda.require_cuda("events_scan", *args)
    U, T = keys.shape
    if not 1 <= T <= 2 * MAX_NCAP + 1:
        raise ValueError(f"events_scan: {T} events a unit, at most "
                         f"{2 * MAX_NCAP + 1}")
    # one allocation a row keeps each 16-byte aligned for K5's staging
    ev = {name: torch.empty((U, T), dtype=torch.int32, device=keys.device)
          for name in _EVENTS}
    n_ev = torch.empty(U, dtype=torch.int32, device=keys.device)
    if U:
        err = cuda.lib("events").fa_events_scan(
            *[a.data_ptr() for a in args], U, T, C,
            *[ev[name].data_ptr() for name in _EVENTS], n_ev.data_ptr(),
            cuda.stream())
        cuda.check(err, "events_scan")
        cuda.LAUNCHES["events_scan"] += 1
    return ev, n_ev


def events_scan_plain(keys, rec, sw0, eL_loc, u_valid, lp0, C: int):
    """Plain PyTorch version of E2 (what ``build_events`` ran after K4)."""
    vt = keys >> 2
    code = keys & 3
    real = vt < CLAMP
    is_enter = (code == 0) & real
    is_leave = (code == 1) & real
    lb_t = torch.cumsum(is_leave, dim=-1)
    le_t = torch.cumsum(is_enter, dim=-1)
    # distinct-membership change: at entry e's enter the leaves so far are
    # lb_t, so its hash is new iff prev[e] < lb_t; at the leave evicting e
    # the enters so far are le_t, so its hash departs iff nxt[e] >= le_t
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
    # position at the event: lp of the most recent leave (lp[0] before any)
    prop, _ = last_event_value(is_leave, torch.where(is_leave, vt - C, 0), 0)
    poslb = torch.where(lb_t > 0, prop, lp0[:, None])
    n_ev = real.sum(dim=-1)
    i32 = lambda x: x.to(torch.int32)
    ev = dict(dn=i32(dn), dq=i32(dq), jr=i32((rec >> 10) & 0x3FF),
              jm=i32(rec & 0x3FF), scored=i32(scored), pos=i32(poslb))
    return ev, i32(n_ev)


def events_scan_recurrence(keys, rec, sw0, eL_loc, u_valid, lp0, C: int):
    """E2's ordered pass restated event by event in plain PyTorch over
    units, for the tests: running leave and enter counts, a one-event
    look-ahead for the end of an equal-value run, and the position of the
    last leave carried from event to event (lp[0] before any), in place of
    the cumsums and the forward fill of ``events_scan_plain``.  Returns
    (ev, n_ev) as ``events_scan``."""
    U, T = keys.shape
    ev = {name: torch.zeros((U, T), dtype=torch.int32, device=keys.device)
          for name in _EVENTS}
    lb = torch.zeros(U, dtype=torch.int32, device=keys.device)
    le = torch.zeros_like(lb)
    n_ev = torch.zeros_like(lb)
    last = lp0.to(torch.int32).clone()
    thr = sw0 + C
    for t in range(T):
        key, r = keys[:, t], rec[:, t]
        vt, code = key >> 2, key & 3
        real = vt < CLAMP
        enter = (code == 0) & real
        leave = (code == 1) & real
        lb += leave.int()
        le += enter.int()
        n_ev += real.int()
        pvnx = (r >> 22) & 0x3FF
        eff = torch.where(enter, (pvnx - 1) < lb, pvnx >= le)
        sign = enter.int() * 2 - 1
        change = (enter | leave) & eff
        run_end = (vt != (keys[:, t + 1] >> 2) if t + 1 < T
                   else torch.ones_like(real))
        last = torch.where(leave, vt - C, last)
        ev["dn"][:, t] = sign * (change & (((r >> 21) & 1) != 0)).int()
        ev["dq"][:, t] = sign * (change & (((r >> 20) & 1) != 0)).int()
        ev["jr"][:, t] = (r >> 10) & 0x3FF
        ev["jm"][:, t] = r & 0x3FF
        ev["scored"][:, t] = (run_end & real & (vt >= thr) & (le < eL_loc)
                              & u_valid).int()
        ev["pos"][:, t] = last
    return ev, n_ev


def events_scan_segmented(keys, rec, sw0, eL_loc, u_valid, lp0, C: int,
                          W: int):
    """E2's two-level scan (csrc/events.cu, ``W`` warps a unit) restated
    in plain PyTorch, for the tests.  Each unit's T events are cut into W
    segments of 32 * ceil(ceil(T / 32) / W) (the last ones may be empty);
    each segment is reduced to its leave, enter and real counts and its
    last leave; the tuples are scanned exclusively (the last leave: the
    last earlier segment's that has one, else lp[0]); then each segment
    is passed again from its carry, its look-ahead at its last event
    reading the next segment's first key.  Returns (ev, n_ev) as
    ``events_scan``."""
    U, T = keys.shape
    dev = keys.device
    S = 32 * -(-(-(-T // 32)) // W)
    pad = torch.full((U, W * S - T), CLAMP << 2, dtype=keys.dtype,
                     device=dev)
    k = torch.cat([keys, pad], 1).view(U, W, S)
    r = torch.cat([rec, torch.zeros_like(pad)], 1).view(U, W, S)
    vt = (k >> 2).long()
    real = vt < CLAMP
    enter = ((k & 3) == 0) & real
    leave = ((k & 3) == 1) & real
    lv = vt - C
    at = torch.arange(S, device=dev)
    seg = torch.arange(W, device=dev)

    def last_of(flags, axis_idx, values, dim):
        # the value at the last flagged index along ``dim`` (-1: none)
        i = torch.where(flags, axis_idx, -1).cummax(dim).values
        return i, torch.gather(values, dim, i.clamp(min=0))

    # 1. each segment's tuple; i_in, lv_in: the last leave at or before
    # each event within its segment
    n_l, n_e = leave.sum(-1), enter.sum(-1)
    i_in, lv_in = last_of(leave, at, lv, 2)
    has, seg_last = i_in[..., -1] >= 0, lv_in[..., -1]
    # 2. the carry into each segment, from the earlier ones
    lb0 = torch.cumsum(n_l, 1) - n_l
    le0 = torch.cumsum(n_e, 1) - n_e
    j_last, prior = last_of(has, seg, seg_last, 1)
    j_last = shift_right(j_last, 1, -1)
    carry = torch.where(j_last >= 0, shift_right(prior, 1, 0),
                        lp0.long()[:, None])
    # 3. each segment from its carry
    lb_t = lb0[..., None] + torch.cumsum(leave, -1)
    le_t = le0[..., None] + torch.cumsum(enter, -1)
    pos = torch.where(i_in >= 0, lv_in, carry[..., None])
    first = shift_left(vt[..., 0], 1, CLAMP)      # the next segment's
    nvt = torch.cat([vt[..., 1:], first[..., None]], 2)
    t = (seg[:, None] * S + at[None, :])[None]
    run_end = (t + 1 >= T) | (vt != nvt)
    pvnx = (r >> 22) & 0x3FF
    eff = torch.where(enter, (pvnx - 1) < lb_t, pvnx >= le_t)
    sign = torch.where(enter, 1, -1)
    change = (enter | leave) & eff
    scored = (run_end & real & (vt >= (sw0 + C).long()[:, None, None])
              & (le_t < eL_loc[:, None, None]) & u_valid[:, None, None])
    rows = dict(dn=torch.where(change & (((r >> 21) & 1) != 0), sign, 0),
                dq=torch.where(change & (((r >> 20) & 1) != 0), sign, 0),
                jr=(r >> 10) & 0x3FF, jm=r & 0x3FF, scored=scored, pos=pos)
    ev = {name: rows[name].reshape(U, W * S)[:, :T].to(torch.int32)
          for name in _EVENTS}
    return ev, real.sum((1, 2)).to(torch.int32)


def walk(ev: dict, s_u: torch.Tensor, n_ev: torch.Tensor, scap: int):
    """K5: the per-unit event walk.  Returns (best, posf, posl) (U,) int32."""
    if s_u.device.type == "cpu":
        return walk_plain(ev, s_u, n_ev, scap)
    if any(ev[name].dtype != torch.int32 for name in _EVENTS):
        raise ValueError("walk: the event arrays must be int32")
    # the kernel stages 16-byte chunks: each array 16-byte aligned (a view
    # at an odd offset is copied to a fresh allocation)
    arrs = [ev[name].contiguous() for name in _EVENTS]
    arrs = [a if a.data_ptr() % 16 == 0 else a.clone() for a in arrs]
    s_u = s_u.to(torch.int32).contiguous()
    n_ev = n_ev.to(torch.int32).contiguous()
    cuda.require_cuda("walk", *arrs, s_u, n_ev)
    U, T = arrs[0].shape
    if scap > 1024:
        raise ValueError(f"walk: scap {scap} > 1024")
    if 4 * U * T >= 1 << 32:
        raise ValueError(f"walk: {U} x {T} events exceed 4 GB")
    out = torch.empty((3, U), dtype=torch.int32, device=s_u.device)
    if U:
        err = cuda.lib("walk").fa_walk(
            *[a.data_ptr() for a in arrs], s_u.data_ptr(), n_ev.data_ptr(), U, T,
            scap, out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            cuda.stream())
        cuda.check(err, "walk")
        cuda.LAUNCHES["walk"] += 1
    return out[0], out[1], out[2]


def walk_blocks_per_sm(scap: int) -> int:
    """The K5 blocks one SM of the current card holds at once at sketch
    width ``scap`` (the occupancy calculator at K5's shared memory for
    that width)."""
    blocks = ctypes.c_int(0)
    cuda.check(cuda.lib("walk").fa_walk_blocks_per_sm(
        scap, ctypes.addressof(blocks)), "walk occupancy")
    return blocks.value


def walk_plain(ev: dict, s_u: torch.Tensor, n_ev: torch.Tensor, scap: int):
    """Plain PyTorch version of K5: ``walk_scan`` of the JAX package as a
    loop over events, each unit stopping at its own n_ev as the kernel
    does (build_events makes the events past n_ev no-ops anyway)."""
    U = s_u.shape[0]
    dev = s_u.device
    jrow = torch.arange(scap, dtype=torch.int32, device=dev)[None, :]
    m = jrow.expand(U, scap).clone()
    pres = torch.zeros((U, scap), dtype=torch.int32, device=dev)
    best = torch.full((U,), -1, dtype=torch.int32, device=dev)
    posf = torch.zeros(U, dtype=torch.int32, device=dev)
    posl = torch.zeros(U, dtype=torch.int32, device=dev)
    s_col = s_u[:, None]
    n_steps = int(n_ev.max()) if U else 0
    for t in range(n_steps):
        dn, dq, jr, jm, scf, pos = (ev[name][:, t] for name in _EVENTS)
        live = t < n_ev
        m += (dn * live)[:, None] * (jrow >= jr[:, None])
        pres += (dq * live)[:, None] * (jrow == jm[:, None])
        jstar = (m < s_col).sum(dim=-1)
        cnt = ((pres > 0) & (jrow < jstar[:, None])).sum(dim=-1)
        sc = torch.where((scf != 0) & live, cnt.to(torch.int32), NOSCORE)
        posf = torch.where(sc > best, pos, posf)
        posl = torch.where(sc >= best, pos, posl)
        best = torch.maximum(best, sc)
    return best, posf, posl


def walk_recurrence(ev: dict, s_u: torch.Tensor, n_ev: torch.Tensor,
                    scap: int):
    """K5's O(1)-per-event recurrence (csrc/walk.cu) restated in plain
    PyTorch over units, for the tests: per-unit diff and pres over ranks
    0..scap, and j*, the prefix sum P = sum_{i < j*} diff[i] and cnt in
    place of the O(scap) state of ``walk_plain``.  Equal to ``walk_plain``
    on streams that keep the invariant (m strictly increasing, pres in
    {0, 1}); returns (best, posf, posl) (U,) int32."""
    U = s_u.shape[0]
    dev = s_u.device
    rows = torch.arange(U, device=dev)
    diff = torch.zeros((U, scap + 1), dtype=torch.int32, device=dev)
    pres = torch.zeros((U, scap + 1), dtype=torch.int32, device=dev)
    jstar = s_u.clamp(0, scap).to(torch.int64)
    P = torch.zeros(U, dtype=torch.int32, device=dev)
    cnt = torch.zeros(U, dtype=torch.int32, device=dev)
    best = torch.full((U,), -1, dtype=torch.int32, device=dev)
    posf = torch.zeros(U, dtype=torch.int32, device=dev)
    posl = torch.zeros(U, dtype=torch.int32, device=dev)
    n_steps = int(n_ev.max()) if U else 0
    for t in range(n_steps):
        dn, dq, jr, jm, scf, pos = (ev[name][:, t] for name in _EVENTS)
        live = t < n_ev
        dn = dn * live
        dq = dq * live
        jr = jr.long().clamp(max=scap)
        jm = jm.long().clamp(max=scap)
        # 1. diff[jr] += dn, and P follows below j*
        diff[rows, jr] += dn
        P += torch.where(jr < jstar, dn, 0)
        # 2. pres[jm] += dq, and cnt follows below j* when presence flips
        old = pres[rows, jm] > 0
        pres[rows, jm] += dq
        flip = (pres[rows, jm] > 0).int() - old.int()
        cnt += torch.where(jm < jstar, flip, 0)
        # 3-4. j* moves at most one rank; P and cnt take the rank crossed
        lo = (jstar - 1).clamp(min=0)
        down = (dn > 0) & (jstar > 0) & (jstar - 1 + P >= s_u)
        up = ((dn < 0) & (jstar < scap)
              & (jstar + P + diff[rows, jstar.clamp(max=scap)] < s_u))
        P = torch.where(down, P - diff[rows, lo], P)
        cnt = torch.where(down, cnt - (pres[rows, lo] > 0).int(), cnt)
        hi = jstar.clamp(max=scap)
        P = torch.where(up, P + diff[rows, hi], P)
        cnt = torch.where(up, cnt + (pres[rows, hi] > 0).int(), cnt)
        jstar = jstar - down.long() + up.long()
        # 5. score
        sc = torch.where((scf != 0) & live, cnt, NOSCORE)
        posf = torch.where(sc > best, pos, posf)
        posl = torch.where(sc >= best, pos, posl)
        best = torch.maximum(best, sc)
    return best, posf, posl


def l2_walk_units(qh, s, frag_of_unit, u_sid, u_valid, b0, eL, mi_hash,
                  mi_sid, mi_wpos, prev_g, nxt_g, frag_len: int, k: int,
                  w: int, ncap: int):
    """Batched L2 over work units via the event walk.  Returns (shared,
    mean_pos, valid, overflow), each (U,)."""
    ev, s_u, overflow, n_ev = build_events(
        qh, s, frag_of_unit, u_sid, u_valid, b0, eL, mi_hash, mi_sid,
        mi_wpos, prev_g, nxt_g, frag_len, k, w, ncap)
    best, posf, posl = walk(ev, s_u, n_ev, qh.shape[-1])
    valid = u_valid & (best > 0)
    mean_pos = torch.where(valid, (posf + posl) // 2, 0)
    return best.clamp(min=0), mean_pos, valid, overflow
