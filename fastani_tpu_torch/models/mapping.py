"""Batched fragment sketch and L1 candidate regions (counterpart of
``fastani_tpu/models/mapping.py``: ``sketch_fragments``, ``l1_candidates``
and ``_searchsorted_pairs``).

* sketch (computeMap.hpp:260-274): K1 winnow, K2 compaction of the emitted
  hashes to a narrow row, K3 row sort, first-unique marks, K2 again to
  ``sketch_cap``;
* L1 (computeMap.hpp:252-354): hash probes as searchsorted ranges over the
  lookup-order index, ragged expansion into ``hits_cap`` slots, the hit
  gather of (seqId, wpos) keys, the hit sort (K3 for 32-bit keys), the
  min-hits partner test, in-place chain merge, K2 for the group leaders.

u32 values cross K2 and K3 as int32 words holding their bit patterns
(UMAX pads are -1): the sketch's hashes from the K1 winnow until ``qh``,
which goes back to int64 u32 values, and the 32-bit hit keys from the
index's ``occ_keys`` on.  A field read from an int32 word masks after
the arithmetic shift, since bit 31 may be set.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from fastani_tpu_torch.ops import compact, sort, winnow
from fastani_tpu_torch.ops.xputils import (PINF, UMAX, last_event_value,
                                           shift_left, shift_right,
                                           u32_as_i32)


def sketch_fragments(frags: torch.Tensor, k: int, w: int, scap: int):
    """Sorted unique minimizer hashes per fragment.

    frags: (F, L) uint8 uppercased fragment bytes.  Returns (qh (F, scap)
    int64 padded with UMAX, s (F,) int64, overflow (F,) bool)."""
    F, L = frags.shape
    dev = frags.device
    halo = w - 1
    rows = torch.cat([torch.zeros((F, halo), dtype=torch.uint8, device=dev),
                      frags], dim=1)
    emit, h = winnow.winnow_rows(
        rows, torch.arange(F, dtype=torch.int32, device=dev),
        torch.zeros(F, dtype=torch.int32, device=dev),
        torch.full((F,), L, dtype=torch.int32, device=dev), k, w)
    n = h.shape[-1]
    n_emit = emit.sum(dim=-1)
    keys0 = torch.where(emit, h, -1)
    # emitted minimizers are sparse (~2/(w+1) of positions): compact them
    # into a narrow row first and sort only that; the narrow width bounds
    # the emit count, and an overflow joins the sketch overflow
    n_cap = 1024
    while n_cap < 4 * scap:
        n_cap *= 2
    if n_cap < n:
        (hc,) = compact.compact_rows(emit, [(keys0, -1)], width=n_cap)
        hk = sort.sort_rows_u32(hc)
        emit_over = n_emit > n_cap
    else:
        hk = sort.sort_rows_u32(keys0)
        emit_over = torch.zeros(F, dtype=torch.bool, device=dev)
    nw = hk.shape[-1]
    j = torch.arange(nw, device=dev)[None, :]
    within = j < n_emit[:, None]
    first = within & ((j == 0) | (hk != shift_right(hk, 1, -1)))
    s = first.sum(dim=-1)
    (qh,) = compact.compact_rows(first, [(hk, -1)], width=scap)
    return qh.to(torch.int64) & UMAX, s, (s > scap) | emit_over


@dataclasses.dataclass
class L1Result:
    sid: torch.Tensor       # (F, cand_cap) int32 candidate contig ids
    start: torch.Tensor     # (F, cand_cap) int32 rangeStartPos
    end: torch.Tensor       # (F, cand_cap) int32 rangeEndPos
    valid: torch.Tensor     # (F, cand_cap) bool
    overflow: torch.Tensor  # (F,) bool — hits or candidates exceeded caps
    n_hits: torch.Tensor    # (F,) true L1 hit count (pre-cap)
    n_groups: torch.Tensor  # (F,) true candidate count (pre-cap)


def hit_key_layout(wpos_bits: Optional[int]):
    """(shift, pad) of the L1 hit keys seqId << shift | wpos: 32-bit keys
    in int32 words (sorted by K3; pads UMAX, the word -1) when the index
    fits ``wpos_bits``, else int64 keys with shift 32 (int64-max pads)."""
    if wpos_bits is None:
        return 32, (1 << 63) - 1
    return wpos_bits, -1


def hit_keys(sid: torch.Tensor, wpos: torch.Tensor, n: int,
             wpos_bits: Optional[int]) -> torch.Tensor:
    """The L1 hit keys of lookup-order (seqId, wpos) arrays in the layout of
    ``hit_key_layout(wpos_bits)``, pads past the n true entries."""
    shift, pad = hit_key_layout(wpos_bits)
    keys = (sid.to(torch.int64) << shift) | wpos.to(torch.int64)
    live = torch.arange(len(keys), device=keys.device) < n
    if wpos_bits is None:
        return torch.where(live, keys, pad)
    return u32_as_i32(torch.where(live, keys, UMAX))


def l1_ranges(qh, s, occ_hash, n_occ: int, freq_threshold: int):
    """The L1 hash probes (computeMap.hpp:286-318): each sketch hash's
    occurrence range [lo, lo + cnt) in the lookup order, cnt 0 past the
    sketch size and for hashes at or above ``freq_threshold``."""
    qvalid = torch.arange(qh.shape[1], device=qh.device)[None, :] < s[:, None]
    lo = torch.searchsorted(occ_hash, qh).clamp(max=n_occ)
    hi = torch.searchsorted(occ_hash, qh, right=True).clamp(max=n_occ)
    cnt = torch.where(qvalid, hi - lo, 0).clamp(min=0)
    return lo, torch.where(cnt < freq_threshold, cnt, 0)


def l1_candidates(qh, s, occ_hash, occ_keys, n_occ: int, min_hits_lut,
                  freq_threshold: int, frag_len: int, hits_cap: int,
                  cand_cap: int, wpos_bits: Optional[int]) -> L1Result:
    """Batched L1 stage.  qh (F, scap) sorted unique hashes (UMAX padded);
    occ_hash/occ_keys the lookup-order hashes and hit keys in the layout of
    ``hit_key_layout(wpos_bits)`` (pads past the n_occ true entries)."""
    F = qh.shape[0]
    dev = qh.device
    M = occ_hash.shape[0]
    lo, cnt = l1_ranges(qh, s, occ_hash, n_occ, freq_threshold)
    cum = torch.cumsum(cnt, dim=-1)
    total = cum[:, -1]
    overflow = total > hits_cap

    # ragged hit-list expansion into (F, hits_cap): slot j of bucket b reads
    # occurrence lo[b] + (j - cum_prev[b]); the per-bucket offsets come from
    # one scatter-add of offset deltas at bucket starts plus a cumsum
    hidx = torch.arange(hits_cap, device=dev)
    cum_prev = shift_right(cum, 1, 0)
    d = lo - cum_prev
    inc = d - shift_right(d, 1, 0)
    arr = torch.zeros((F, hits_cap), dtype=torch.int64, device=dev)
    arr.scatter_add_(1, cum_prev.clamp(max=hits_cap - 1), inc)
    src = (hidx[None, :] + torch.cumsum(arr, dim=-1)).clamp(0, max(M - 1, 0))
    hvalid = hidx[None, :] < total.clamp(max=hits_cap)[:, None]

    # hit gather + sort by (seqId, wpos) — computeMap.hpp:320.  Keys wider
    # than 32 bits take torch.sort, as the JAX package lexsorts them
    # outside its Pallas sort
    shift, pad = hit_key_layout(wpos_bits)
    key = torch.where(hvalid, occ_keys[src], pad)
    if wpos_bits is None:
        key = torch.sort(key, dim=-1).values
    else:
        key = sort.sort_rows_u32(key)
    sid_mask = (1 << (8 * key.element_size() - shift)) - 1

    def fields(k, ok):
        """int32 (seqId, wpos) of keys k, PINF where not ok"""
        return (torch.where(ok, (k >> shift) & sid_mask, PINF).to(torch.int32),
                torch.where(ok, k & ((1 << shift) - 1), PINF).to(torch.int32))

    hvalid = key != pad
    hit_sid, hit_wp = fields(key, hvalid)

    # consecutive-hit window test (computeMap.hpp:322-336): the partner of
    # hit i is hit i + m - 1, m = minimum hits for the fragment's sketch size
    m = min_hits_lut[s.clamp(0, min_hits_lut.shape[0] - 1)].clamp(min=1)
    partner = hidx[None, :] + m[:, None] - 1
    key2 = torch.where(partner < hits_cap,
                       torch.gather(key, 1, partner.clamp(max=hits_cap - 1)),
                       pad)
    p_ok = key2 != pad
    sid2, wp2 = fields(key2, p_ok)
    cand_valid = hvalid & p_ok & (sid2 == hit_sid) & (wp2 - hit_wp < frag_len)
    cand_start = (wp2 - frag_len + 1).clamp(min=0)
    cand_end = hit_wp

    # merge chains in place (computeMap.hpp:338-350): the previous VALID
    # candidate's (sid, end) by last-event propagation
    last_sid, _ = last_event_value(cand_valid, hit_sid, -1)
    last_end, _ = last_event_value(cand_valid, cand_end, -PINF)
    new_group = cand_valid & ((hit_sid != shift_right(last_sid, 1, -1))
                              | (cand_start > shift_right(last_end, 1, -PINF)))
    n_groups = new_group.sum(dim=-1)
    overflow = overflow | (n_groups > cand_cap)

    # group leaders to the front (K2): (sid, start, hit position), int32
    hpos = torch.arange(hits_cap, dtype=torch.int32, device=dev)
    g_sid, g_start, lpos = compact.compact_rows(
        new_group, [(hit_sid, -1), (cand_start, 0),
                    (hpos[None, :].expand(F, hits_cap).contiguous(), hits_cap)],
        width=cand_cap)
    gcount = torch.arange(cand_cap, device=dev)[None, :]
    g_valid = gcount < n_groups.clamp(max=cand_cap)[:, None]
    # group end = end of its last member = last valid candidate before the
    # next leader (for the last group: before the end of the row)
    last_member = torch.where(gcount + 1 < n_groups[:, None],
                              shift_left(lpos, 1, hits_cap) - 1, hits_cap - 1)
    g_end = torch.gather(last_end, 1,
                         last_member.clamp(0, hits_cap - 1).to(torch.int64))
    g_sid = torch.where(g_valid, g_sid, -1)
    return L1Result(g_sid, g_start, g_end, g_valid, overflow,
                    n_hits=total, n_groups=n_groups)


def _searchsorted_pairs(a_sid, a_wpos, q_sid, q_wpos):
    """lower_bound over global (seqId, wpos) pairs (winSketch.hpp:259-270):
    branchless binary descent, one gather per bit of the table length."""
    n = a_sid.shape[0]
    pos = torch.zeros(q_sid.shape, dtype=torch.int64, device=q_sid.device)
    for b in reversed(range(int(n).bit_length())):
        cand = pos + (1 << b)
        gi = (cand - 1).clamp(0, max(n - 1, 0))
        asid, awp = a_sid[gi], a_wpos[gi]
        lt = (asid < q_sid) | ((asid == q_sid) & (awp < q_wpos))
        pos = torch.where((cand <= n) & lt, cand, pos)
    return pos
