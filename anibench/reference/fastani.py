"""A plain FastANI of (query genome, reference genome) pairs.

What FastANI computes for a pair depends on the two genomes alone: the L1
candidates of a fragment lie on one reference contig, the L2 walk reads
that contig's minimizers only, and the fold keeps the best mapping per
(reference genome, query fragment) and then per (reference contig, bin).
So a pair is checked with an index of its reference genome alone:

* ``Genome``: contigs read from FASTA, their canonical k-mer hashes, the
  reference index (minimizers by contig and position) and the query
  fragments' sketches (sorted unique minimizer hashes);
* ``load_genomes``: several genomes read at once, in worker processes;
* ``l1_candidates``: hits of each fragment's sketch in the index, and the
  candidate ranges where min-hits of them fall within a fragment length
  (computeMap.hpp:252-354), in ``torch`` on any device;
* ``l2_units``: the sliding-window walk of each candidate (computeMap.hpp
  :418-497, MIIteratorL2.hpp:74-96) in closed form: the walk visits every
  window start v in {P[i]} u {P[j] - C + 1}, its window holds the entries
  with b(v) = (last entry at or before v) <= i < e(v) = (first entry at
  or past v + C), and the shared count is the number of sketch hashes
  present in the window among the s smallest of (sketch u window hashes).
  It runs on ``torch`` tensors in blocks of units, on any device, over
  the units of many pairs together;
* ``fold``: the 1-way and 2-way filters and the sequential mean
  (computeCoreIdentity.hpp:166-298), in float32 or, for the control,
  in bfloat16;
* ``answers``: all of it for a list of pairs.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import time
from multiprocessing import resource_tracker
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from . import mashstats
from .genome import Genome, load_genome

PERC_IDENTITY = 80.0


def _lexsorted(*keys: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts by ``keys[0]``, then ``keys[1]``, ...
    (``np.lexsort`` with its keys reversed), by stable sorts."""
    perm = torch.arange(len(keys[0]), device=keys[0].device)
    for key in reversed(keys):
        perm = perm[torch.sort(key[perm], stable=True).indices]
    return perm


def _device_arrays(g: Genome, device: torch.device) -> dict:
    """A genome's arrays that L1 reads, on ``device``: the index's hashes
    sorted (``rh``) with their entry numbers (``order``), its contigs and
    positions, and the sketches."""
    t = lambda a: torch.as_tensor(a, device=device)
    rh, order = torch.sort(t(g.hash), stable=True)
    return {"rh": rh, "order": order, "sid": t(g.sid), "wpos": t(g.wpos),
            "sk_hash": t(g.sk_hash), "sk_frag": t(g.sk_frag)}


def l1_candidates(q: Genome, r: Genome, k: int, l: int,
                  device: torch.device = torch.device("cpu"),
                  on_device=None):
    """Candidate units of every query fragment against reference ``r``:
    (fragment, contig, range start, range end) arrays, worked out with
    ``torch`` on ``device``.  ``on_device``: {path: ``_device_arrays``},
    filled as genomes are first met."""
    z = np.zeros(0, np.int64)
    t = lambda a: torch.as_tensor(a, device=device)
    on_device = {} if on_device is None else on_device
    for g in (q, r):
        if g.path not in on_device:
            on_device[g.path] = _device_arrays(g, device)
    dq, dr = on_device[q.path], on_device[r.path]
    rh, order = dr["rh"], dr["order"]
    qh = dq["sk_hash"]
    lo = torch.searchsorted(rh, qh)
    cnt = torch.searchsorted(rh, qh, right=True) - lo
    tot = int(cnt.sum())
    if tot == 0:
        return z, z, z, z
    base = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
    idx = order[torch.arange(tot, device=device) - base
                + torch.repeat_interleave(lo, cnt)]
    frag = torch.repeat_interleave(dq["sk_frag"], cnt)
    sid, wp = dr["sid"][idx], dr["wpos"][idx]
    o = _lexsorted(frag, sid, wp)
    frag, sid, wp = frag[o], sid[o], wp[o]
    mh = t(np.array([mashstats.sketch_tables(int(s), k, PERC_IDENTITY)[2]
                     if s > 0 else 1 for s in q.sk_size], np.int64))
    seg_end = torch.searchsorted(frag, frag, right=True)
    j = torch.arange(tot, device=device) + mh[frag] - 1
    jc = j.clamp(max=tot - 1)
    ok = (j < seg_end) & (sid[jc] == sid) & (wp[jc] - wp < l)
    qi = torch.nonzero(ok)[:, 0]
    if len(qi) == 0:
        return z, z, z, z
    start = (wp[jc[qi]] - l + 1).clamp(min=0)
    end = wp[qi]
    f_q, s_q = frag[qi], sid[qi]
    new = torch.ones(len(qi), dtype=torch.bool, device=device)
    new[1:] = ((f_q[1:] != f_q[:-1]) | (s_q[1:] != s_q[:-1])
               | (end[:-1] < start[1:]))
    first = torch.nonzero(new)[:, 0]
    last = torch.cat([first[1:] - 1, first.new_tensor([len(qi) - 1])])
    n = lambda a: a.cpu().numpy().astype(np.int64)
    return n(f_q[first]), n(s_q[first]), n(start[first]), n(end[last])


def _unit_entries(r: Genome, u_sid, u_start, u_end, C: int, l: int):
    """Each unit's entry range [b0, eL) of its contig and e0."""
    b0 = np.empty(len(u_sid), np.int64)
    e0 = np.empty_like(b0)
    eL = np.empty_like(b0)
    for c in np.unique(u_sid):
        sel = u_sid == c
        lo, hi = r.starts[c], r.starts[c + 1]
        P = r.wpos[lo:hi]
        bb = np.searchsorted(P, u_start[sel], "left")
        b0[sel] = lo + bb
        e0[sel] = lo + np.searchsorted(P, P[np.minimum(bb, len(P) - 1)] + C,
                                       "left")
        eL[sel] = lo + np.searchsorted(P, u_end[sel] + l, "left")
    return b0, e0, eL


@dataclasses.dataclass
class Tables:
    """The index entries (``wpos``, ``hash``) and sketch hashes
    (``sk_hash``) of several genomes, one after another, so that units
    of many pairs run through the L2 walk together."""
    wpos: np.ndarray
    hash: np.ndarray
    sk_hash: np.ndarray


def l2_units(tab: Tables, b0, e0, eL, sk_lo, s_u, C: int,
             device: torch.device, budget: int = 1 << 27):
    """Best shared count and mean position of units given by their entry
    ranges [b0, eL) (first window end e0) and sketch rows [sk_lo, sk_lo +
    s_u) in ``tab``: the walk of each, in blocks of units of about equal
    entry counts, at most ``budget`` elements of the walk's widest
    intermediate a block."""
    nU = len(b0)
    best = np.zeros(nU, np.int64)
    mean = np.zeros(nU, np.int64)
    if nU == 0:
        return best, mean
    E = np.maximum(eL - b0, 0)
    live = np.nonzero(e0 < eL)[0]
    live = live[np.argsort(E[live], kind="stable")]
    S_max = int(s_u.max())
    i = 0
    while i < len(live):
        j = i + 1
        while j < len(live):
            Em = int(E[live[j]])
            if (j - i + 1) * (2 * Em) * (Em + S_max) > budget:
                break
            j += 1
        blk = live[i:j]
        Em = int(E[blk].max())
        bb, mm = _l2_block(tab, blk, b0, eL, sk_lo, s_u, Em, S_max, C,
                           device)
        best[blk], mean[blk] = bb, mm
        i = j
    return best, mean


def _l2_block(tab, blk, b0, eL, sk_lo, s_u, Em, S_max, C, device):
    """``l2_units`` of the units ``blk`` at once, padded to ``Em`` entries
    and ``S_max`` sketch hashes: the shared count of every window start
    from the prefix counts of each distinct hash over the entries."""
    B = len(blk)
    BIG = np.int64(1) << 40
    ar_e = np.arange(Em)
    ent = b0[blk, None] + ar_e[None, :]
    in_e = ent < eL[blk, None]
    entc = np.where(in_e, ent, 0)
    P = np.where(in_e, tab.wpos[entc], BIG)
    H = np.where(in_e, tab.hash[entc], BIG + 1)
    ar_s = np.arange(S_max)
    in_q = ar_s[None, :] < s_u[blk, None]
    qidx = np.where(in_q, sk_lo[blk, None] + ar_s[None, :], 0)
    QH = np.where(in_q, tab.sk_hash[qidx], BIG + 2)
    t = lambda a: torch.as_tensor(a, device=device)
    P, H, QH, in_q = t(P), t(H), t(QH), t(in_q)
    n_e = t(eL[blk] - b0[blk])
    s = t(s_u[blk])
    # window starts: the entries' positions and P[j] - C + 1, those that
    # count (distinct, from the first entry to the last entry less C)
    # moved to the front in order
    cand = torch.cat([P, P - C + 1], dim=1)
    cand, _ = torch.sort(cand, dim=1)
    last_p = P.gather(1, (n_e - 1)[:, None])
    ok = (cand >= P[:, :1]) & (cand <= last_p - C)
    ok[:, 1:] &= cand[:, 1:] != cand[:, :-1]
    n_ok = ok.sum(dim=1)
    T = max(int(n_ok.max()), 1)
    front = torch.argsort((~ok).to(torch.int8), dim=1, stable=True)[:, :T]
    cand = cand.gather(1, front)
    ok = torch.arange(T, device=device)[None, :] < n_ok[:, None]
    bi = torch.searchsorted(P, cand.contiguous(), right=True) - 1
    ei = torch.searchsorted(P, (cand + C).contiguous(), right=False)
    bi = bi.clamp(0, Em - 1)
    ei = ei.clamp(0, Em)
    # distinct hashes of sketch and entries, by value, per unit
    allh = torch.cat([QH, H], dim=1)
    srt, perm = torch.sort(allh, dim=1)
    newv = torch.ones_like(srt, dtype=torch.bool)
    newv[:, 1:] = srt[:, 1:] != srt[:, :-1]
    vid_sorted = torch.cumsum(newv.to(torch.int64), dim=1) - 1
    vid = torch.empty_like(vid_sorted)
    vid.scatter_(1, perm, vid_sorted)
    V = int(vid_sorted[:, -1].max()) + 1
    vq, ve = vid[:, :S_max], vid[:, S_max:]
    isq = torch.zeros((B, V), dtype=torch.bool, device=device)
    isq.scatter_(1, vq, in_q)
    # prefix counts of each value over the entries (16-bit where they
    # fit: the walk's widest intermediates are these)
    cdt = torch.int16 if Em < 1 << 15 else torch.int32
    rdt = torch.int16 if V < 1 << 15 else torch.int32
    onehot = torch.zeros((B, Em + 1, V), dtype=cdt, device=device)
    onehot[:, 1:, :].scatter_(2, ve[:, :, None],
                              torch.ones((B, Em, 1), dtype=cdt,
                                         device=device))
    pc = torch.cumsum(onehot, dim=1, dtype=cdt)
    del onehot
    shared = torch.empty((B, T), dtype=torch.int64, device=device)
    step = max(1, T // 8)
    for t0 in range(0, T, step):
        e_ = pc.gather(1, ei[:, t0:t0 + step, None].expand(-1, -1, V))
        b_ = pc.gather(1, bi[:, t0:t0 + step, None].expand(-1, -1, V))
        pres = (e_ - b_) > 0
        inu = pres | isq[:, None, :]
        rank = torch.cumsum(inu.to(rdt), dim=2, dtype=rdt) - inu.to(rdt)
        hit = pres & isq[:, None, :] & (rank < s[:, None, None])
        shared[:, t0:t0 + step] = hit.sum(dim=2)
    shared = torch.where(ok, shared, torch.full_like(shared, -1))
    best = shared.max(dim=1).values
    at = (shared == best[:, None]) & ok
    idx = torch.arange(T, device=device)[None, :].expand(B, -1)
    t_first = torch.where(at, idx, T).min(dim=1).values
    t_last = torch.where(at, idx, -1).max(dim=1).values
    p_first = P.gather(1, bi.gather(1, t_first[:, None]))[:, 0]
    p_last = P.gather(1, bi.gather(1, t_last[:, None]))[:, 0]
    best = best.clamp(min=0)
    mean = torch.where(best > 0, (p_first + p_last) // 2,
                       torch.zeros_like(best))
    return best.cpu().numpy(), mean.cpu().numpy()


def to_bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (nearest, ties to even), held
    in float32."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def fold(frag, sid, start, ident, l: int, precision: str = "float32"):
    """(count, ANI) of one pair's mappings (computeCoreIdentity.hpp:
    166-298): the best mapping per query fragment, then per (reference
    contig, bin of l - 20), and their mean folded in order."""
    if len(frag) == 0:
        return 0, np.float32(0)
    pos_bin = start // (l - 20)
    o1 = np.lexsort((start, sid, ident, frag))
    last1 = np.ones(len(o1), bool)
    last1[:-1] = frag[o1][:-1] != frag[o1][1:]
    k1 = o1[last1]
    o2 = k1[np.lexsort((frag[k1], ident[k1], pos_bin[k1], sid[k1]))]
    last2 = np.ones(len(o2), bool)
    last2[:-1] = ((sid[o2][:-1] != sid[o2][1:])
                  | (pos_bin[o2][:-1] != pos_bin[o2][1:]))
    vals = ident[o2[last2]].astype(np.float32)
    n = len(vals)
    if precision == "float32":
        acc = np.add.accumulate(vals, dtype=np.float32)[-1]
        return n, np.float32(acc / np.float32(n))
    acc = np.float32(0)
    for v in to_bf16(vals):
        acc = to_bf16(np.float32(acc + v))
    return n, to_bf16(np.float32(acc / to_bf16(np.float32(n))))


@dataclasses.dataclass
class PairResult:
    count: int
    ani: np.float32
    total_fragments: int
    reported: bool


def load_genomes(paths, k: int, w: int, l: int, workers: int = 1) -> dict:
    """{path: Genome} of ``paths``, read and winnowed in ``workers``
    processes when more than one (started afresh, each ended and waited
    for before this returns, multiprocessing's resource tracker too)."""
    paths = sorted(set(paths))
    n = len(paths)
    if workers <= 1 or n <= 1:
        return {p: load_genome(p, k, w, l) for p in paths}
    ctx = multiprocessing.get_context("spawn")
    try:
        with ProcessPoolExecutor(min(workers, n), mp_context=ctx) as ex:
            got = list(ex.map(load_genome, paths, [k] * n, [w] * n,
                              [l] * n))
    finally:
        # the pool's queues started multiprocessing's resource tracker, a
        # process that would outlive this one: end it and wait for it
        resource_tracker._resource_tracker._stop()
    return dict(zip(paths, got))


def answers(genomes: dict, pairs, k: int, w: int, l: int,
            min_fraction: float, device: torch.device,
            precisions=("float32",), budget: int = 1 << 27,
            times=None) -> dict:
    """What FastANI reports for each (query, reference) pair of ``pairs``
    (paths, keys of ``genomes``): {precision: {pair: PairResult}}, the
    fold in each of ``precisions`` (``bfloat16`` for the control) over the
    same mappings.  The L2 walk runs over the units of all pairs at
    once.  ``times``, a dict, gets the seconds of L1, L2 and the fold."""
    times = {} if times is None else times
    t0 = time.perf_counter()
    pairs = list(pairs)
    C = l - (w - 1) - (k - 1)
    paths = sorted(genomes)
    e_off = np.cumsum([0] + [len(genomes[p].wpos) for p in paths])
    s_off = np.cumsum([0] + [len(genomes[p].sk_hash) for p in paths])
    at = {p: i for i, p in enumerate(paths)}
    tab = Tables(*(np.concatenate([getattr(genomes[p], f) for p in paths])
                   for f in ("wpos", "hash", "sk_hash")))
    units, cols, on_device = [], [], {}
    for qp, rp in pairs:
        q, r = genomes[qp], genomes[rp]
        u = l1_candidates(q, r, k, l, device, on_device)
        b0, e0, eL = _unit_entries(r, u[1], u[2], u[3], C, l)
        o = e_off[at[rp]]
        sk_lo = np.searchsorted(q.sk_frag, u[0], "left") + s_off[at[qp]]
        units.append(u)
        cols.append((b0 + o, e0 + o, eL + o, sk_lo, q.sk_size[u[0]]))
    b0, e0, eL, sk_lo, s_u = (np.concatenate([c[i] for c in cols])
                              if cols else np.zeros(0, np.int64)
                              for i in range(5))
    del on_device
    t1 = time.perf_counter()
    best, mean = l2_units(tab, b0, e0, eL, sk_lo, s_u, C, device, budget)
    t2 = time.perf_counter()
    times.update(l1_s=t1 - t0, l2_s=t2 - t1, units=len(b0))
    out = {prec: {} for prec in precisions}
    at_u = 0
    for (qp, rp), u, c in zip(pairs, units, cols):
        n_u = len(u[0])
        bst, mn, su = best[at_u:at_u + n_u], mean[at_u:at_u + n_u], c[4]
        at_u += n_u
        ident = np.zeros(n_u, np.float32)
        upper = np.zeros(n_u, np.float32)
        for s in np.unique(su):
            sel = su == s
            li, lu, _ = mashstats.sketch_tables(int(s), k, PERC_IDENTITY)
            ident[sel] = li[bst[sel]]
            upper[sel] = lu[bst[sel]]
        keep = upper >= PERC_IDENTITY
        q, r = genomes[qp], genomes[rp]
        for prec in precisions:
            n, ani = fold(u[0][keep], u[1][keep], mn[keep], ident[keep], l,
                          prec)
            reported = n > 0 and n * l >= min(q.ani_length, r.ani_length) \
                * min_fraction
            out[prec][(qp, rp)] = PairResult(n, ani, q.n_fragments,
                                             bool(reported))
    times["fold_s"] = time.perf_counter() - t2
    return out
