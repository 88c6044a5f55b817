"""The mapping step (counterpart of ``fastani_tpu/models/jitmap.py``).

One fragment batch against the device-resident index: sketch, L1, unit
compaction to ``unit_cap``, L2 over chunks of ``unit_chunk`` units, the
identity gate, and the packed valid-first block the device CGI folds.
PyTorch runs eagerly, so there is no jit: ``Mapper`` holds the index
tables and runs ``map_step_packed`` per batch.  The L2 chunk loop reads
one scalar per batch (the live unit count) to stop after the last chunk
with a valid unit.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from fastani_tpu_torch.models import l2walk, mapping
from fastani_tpu_torch.ops import compact, stats
from fastani_tpu_torch.ops.xputils import PINF, UMAX

# the 11 entries of map_step_packed's counts vector, in order
COUNT_NAMES = ("n_valid", "sk_overflow", "l1_overflow", "l2_overflow",
               "unit_overflow", "max_hits", "max_groups", "max_s",
               "max_span", "n_units", "sum_hits")


def overflowed(counts: dict) -> bool:
    """Whether a batch's counts (named by COUNT_NAMES) say a fragment
    overflowed a cap: the sketch, L1, L2 or unit flag."""
    return any(counts[key] for key in COUNT_NAMES[1:5])


@functools.lru_cache(maxsize=None)
def gate_lut_np(k: int, perc_identity: float, s_max: int) -> np.ndarray:
    """min_c[s] = smallest shared count whose CI upper bound passes the
    identity cutoff (computeMap.hpp:384); s_max+1 for s = 0."""
    _, upper = stats.identity_tables(k, s_max)
    out = np.full(s_max + 1, s_max + 1, dtype=np.int32)
    for s in range(1, s_max + 1):
        ok = np.nonzero(upper[s, : s + 1] >= np.float32(perc_identity))[0]
        out[s] = int(ok[0]) if len(ok) else s + 1
    return out


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    kmer_size: int
    window_size: int
    frag_len: int
    sketch_cap: int
    hits_cap: int
    cand_cap: int
    l2_entry_cap: int
    unit_cap: int        # max L2 work units per fragment batch
    unit_chunk: int      # units per L2 chunk
    freq_threshold: int
    # (seqId << wpos_bits | wpos) packing width of 32-bit L1 hit keys;
    # None when the index does not fit (64-bit keys, mapping.hit_key_layout)
    wpos_bits: Optional[int]

    @classmethod
    def from_params(cls, params, freq_threshold: int, unit_factor: int = 4,
                    unit_chunk: int = 16, index=None) -> "MapperConfig":
        if params.sketch_cap > l2walk.MAX_SCAP:
            raise ValueError(f"sketch_cap={params.sketch_cap} exceeds the L2 "
                             f"event record limit of {l2walk.MAX_SCAP}")
        if params.l2_entry_cap > l2walk.MAX_NCAP:
            raise ValueError(f"l2_entry_cap={params.l2_entry_cap} exceeds "
                             f"the L2 event record limit of {l2walk.MAX_NCAP}")
        wpos_bits = None
        if index is not None and len(index.metadata):
            max_len = max(c.length for c in index.metadata)
            n_seqs = len(index.metadata)
            # headroom for position + span queries so keys never saturate
            bits = max(int(max_len + 2 * params.frag_len).bit_length(), 1)
            if ((n_seqs - 1) << bits) + ((1 << bits) - 1) < 0xFFFFFFFF:
                wpos_bits = bits
        return cls(
            kmer_size=params.kmer_size, window_size=params.window_size,
            frag_len=params.frag_len, sketch_cap=params.sketch_cap,
            hits_cap=params.hits_cap, cand_cap=params.cand_cap,
            l2_entry_cap=params.l2_entry_cap,
            # never wider than the candidate grid (F x cand_cap) itself
            unit_cap=min(params.frag_batch * unit_factor,
                         params.frag_batch * params.cand_cap),
            unit_chunk=unit_chunk, freq_threshold=freq_threshold,
            wpos_bits=wpos_bits)


@dataclasses.dataclass
class IndexTables:
    """The device tables one mapping step reads (padded to a common M)."""
    occ_hash: torch.Tensor      # (M,) int64 lookup-order hashes
    occ_keys: torch.Tensor      # (M,) L1 hit keys (mapping.hit_keys)
    mi_hash: torch.Tensor       # (M,) int64 build-order hashes
    mi_sid: torch.Tensor        # (M,) int32
    mi_wpos: torch.Tensor       # (M,) int32
    mi_prev: torch.Tensor       # (M,) int64 prev same-(hash, seqId) entry
    mi_nxt: torch.Tensor        # (M,) int64 next same-(hash, seqId) entry
    n_occ: int                  # true entry count
    min_hits: torch.Tensor      # (s_max+1,) int64 min-hits LUT
    gate: torch.Tensor          # (s_max+1,) int64 identity-gate LUT


def locate_units(cfg: MapperConfig, frags: torch.Tensor,
                 t: IndexTables) -> dict:
    """Sketch, L1, valid-unit compaction to ``unit_cap`` and each unit's
    entry window: everything of one batch before its L2 chunks."""
    F = frags.shape[0]
    dev = frags.device
    k, w, l = cfg.kmer_size, cfg.window_size, cfg.frag_len
    qh, s, sk_over = mapping.sketch_fragments(frags, k, w, cfg.sketch_cap)
    l1 = mapping.l1_candidates(qh, s, t.occ_hash, t.occ_keys, t.n_occ,
                               t.min_hits, cfg.freq_threshold, l,
                               cfg.hits_cap, cfg.cand_cap, cfg.wpos_bits)

    # flatten the candidate grid and compact valid units to the front
    # (K2, stable: fragment-major order kept)
    u_frag = torch.arange(F, dtype=torch.int32, device=dev).repeat_interleave(
        cfg.cand_cap)
    u_valid_grid = l1.valid.reshape(1, -1)
    n_valid_units = int(l1.valid.sum())
    u_sid, u_start, u_end, u_frag = (a[0] for a in compact.compact_rows(
        u_valid_grid, [(l1.sid.reshape(1, -1), 0), (l1.start.reshape(1, -1), 0),
                       (l1.end.reshape(1, -1), 0), (u_frag.reshape(1, -1), 0)],
        width=cfg.unit_cap))
    U = cfg.unit_cap
    u_valid = torch.arange(U, device=dev) < n_valid_units
    # exact per-fragment attribution of dropped units: fragment f's units
    # occupy [cum_excl[f], cum[f]) and any past unit_cap are dropped
    nvf = l1.valid.sum(dim=-1)

    # window location: first entry at/after the range start, end of the
    # last window (lower bounds over (seqId, wpos), winSketch.hpp:259-270)
    sid_m = torch.where(u_valid, u_sid, 0).to(torch.int64)
    b0 = mapping._searchsorted_pairs(t.mi_sid, t.mi_wpos, sid_m,
                                     u_start.to(torch.int64))
    eL = mapping._searchsorted_pairs(t.mi_sid, t.mi_wpos, sid_m,
                                     u_end.to(torch.int64) + l)
    return dict(qh=qh, s=s, sk_over=sk_over, l1=l1, u_frag=u_frag,
                u_sid=u_sid, u_valid=u_valid, b0=b0, eL=eL, nvf=nvf,
                # L2 runs only over chunks holding a valid unit (valid
                # units come first)
                n_live=min(n_valid_units, U),
                unit_overflow=n_valid_units > U,
                unit_drop_frag=(torch.cumsum(nvf, 0) > U) & (nvf > 0))


def l2_chunk_args(cfg: MapperConfig, t: IndexTables, u: dict,
                  sl: slice) -> tuple:
    """The ``l2walk.build_events`` / ``l2_walk_units`` arguments of the
    units ``sl`` of ``locate_units``'s result ``u``."""
    return (u["qh"], u["s"], u["u_frag"][sl].long(), u["u_sid"][sl],
            u["u_valid"][sl], u["b0"][sl], u["eL"][sl], t.mi_hash, t.mi_sid,
            t.mi_wpos, t.mi_prev, t.mi_nxt, cfg.frag_len, cfg.kmer_size,
            cfg.window_size, cfg.l2_entry_cap)


def map_step(cfg: MapperConfig, frags: torch.Tensor, t: IndexTables) -> dict:
    """One fragment batch against one index.  Returns a dict of (unit_cap,)
    unit arrays (frag, sid, shared, sketch, mean_pos, valid = gated) plus
    per-fragment overflow masks and the observed maxima."""
    dev = frags.device
    u = locate_units(cfg, frags, t)
    U = cfg.unit_cap
    shared = torch.zeros(U, dtype=torch.int32, device=dev)
    mean_pos = torch.zeros(U, dtype=torch.int32, device=dev)
    l2_valid = torch.zeros(U, dtype=torch.bool, device=dev)
    l2_over = torch.zeros(U, dtype=torch.bool, device=dev)
    for c0 in range(0, u["n_live"], cfg.unit_chunk):
        sl = slice(c0, min(c0 + cfg.unit_chunk, U))
        shared[sl], mean_pos[sl], l2_valid[sl], l2_over[sl] = (
            l2walk.l2_walk_units(*l2_chunk_args(cfg, t, u, sl)))

    # identity gate: shared >= gate[s]
    u_frag, s, l1 = u["u_frag"], u["s"], u["l1"]
    s_u = s[u_frag.long()]
    gated = l2_valid & (shared >= t.gate[s_u.clamp(0, t.gate.shape[0] - 1)])
    max_span = torch.where(u["u_valid"], u["eL"] - u["b0"], 0).max()
    return dict(
        frag=u_frag, sid=u["u_sid"], shared=shared, sketch=s_u.to(torch.int32),
        mean_pos=mean_pos, valid=gated & ~l2_over,
        frag_sketch_overflow=u["sk_over"], l1_overflow=l1.overflow,
        l2_overflow=l2_over, unit_frag_overflow=u["unit_overflow"],
        unit_drop_frag=u["unit_drop_frag"],
        max_hits=l1.n_hits.max(), max_groups=l1.n_groups.max(),
        max_s=s.max(), max_span=max_span, n_units=u["nvf"].sum(),
        sum_hits=l1.n_hits.sum())


def map_step_packed(cfg: MapperConfig, frags: torch.Tensor, t: IndexTables,
                    qno_row: Optional[torch.Tensor] = None,
                    qsid_row: Optional[torch.Tensor] = None,
                    row_valid: Optional[torch.Tensor] = None) -> dict:
    """map_step plus the per-fragment fallback mask and one (7, unit_cap)
    int32 block sorted valid-first, rows (frag, qno, qsid, sid, shared,
    sketch, mean_pos); ``counts`` is an (11,) vector named by COUNT_NAMES."""
    out = map_step(cfg, frags, t)
    F = frags.shape[0]
    frag = out["frag"].long()
    fc = frag.clamp(0, F - 1)
    fb_l2 = torch.zeros(F, dtype=torch.int32, device=frags.device)
    fb_l2.index_add_(0, fc, out["l2_overflow"].to(torch.int32))
    fallback_mask = (out["frag_sketch_overflow"] | out["l1_overflow"]
                     | (fb_l2 > 0) | out["unit_drop_frag"])
    if row_valid is not None:
        fallback_mask = fallback_mask & row_valid
    keep = out["valid"] & ~fallback_mask[fc]
    if row_valid is not None:
        keep = keep & row_valid[fc]
    corder = torch.argsort((~keep).to(torch.int32), stable=True)
    qno = torch.zeros_like(out["frag"]) if qno_row is None else qno_row[frag]
    qsid = out["frag"] if qsid_row is None else qsid_row[frag]
    packed = torch.stack([
        out["frag"], qno.to(torch.int32), qsid.to(torch.int32), out["sid"],
        out["shared"], out["sketch"], out["mean_pos"]])[:, corder]
    counts = torch.stack([
        keep.sum(), out["frag_sketch_overflow"].any(),
        out["l1_overflow"].any(), out["l2_overflow"].any(),
        torch.as_tensor(out["unit_frag_overflow"], device=frags.device),
        out["max_hits"], out["max_groups"], out["max_s"], out["max_span"],
        out["n_units"], out["sum_hits"]]).to(torch.int64)
    return dict(packed=packed, counts=counts, fallback_mask=fallback_mask)


class Mapper:
    """The mapping step bound to one index resident on the device (the
    work of ``JitMapper.__init__``, without jit): LUTs, index arrays padded
    with a sentinel margin, packed lookup keys and prev/next links."""

    def __init__(self, params, index, unit_factor: int = 4,
                 unit_chunk: int = 128):
        self.params = params
        self.index = index
        self.cfg = MapperConfig.from_params(params, index.freq_threshold,
                                            unit_factor, unit_chunk,
                                            index=index)
        dev = index.device
        M = index.n_entries
        # device builds arrive padded with >= 2048 sentinels past the true
        # count; unpadded arrays get the JAX package's padding (>= one L2
        # entry window of sentinels, so entry windows are plain slices)
        Mp = len(index.occ_hash)
        if Mp == M:
            Mp = max(128, 1 << max(M + params.l2_entry_cap - 1, 1).bit_length())

        def pad(a, fill):
            if len(a) == Mp:
                return a
            out = torch.full((Mp,), fill, dtype=a.dtype, device=dev)
            out[: len(a)] = a
            return out

        occ_hash = pad(index.occ_hash, UMAX)
        mi_hash = pad(index.mi_hash, UMAX)
        mi_sid = pad(index.mi_seqid, PINF)
        mi_wpos = pad(index.mi_wpos, PINF)
        occ_keys = mapping.hit_keys(pad(index.occ_seqid, PINF),
                                    pad(index.occ_wpos, PINF), M,
                                    self.cfg.wpos_bits)
        order = index.occ_order
        if order is None or len(order) != Mp:
            order = torch.sort(mi_hash, stable=True).indices
        prev, nxt = l2walk.prev_next_global(mi_hash, mi_sid, order)
        self.tables = IndexTables(
            occ_hash=occ_hash, occ_keys=occ_keys, mi_hash=mi_hash,
            mi_sid=mi_sid, mi_wpos=mi_wpos, mi_prev=prev, mi_nxt=nxt,
            n_occ=M, **self._luts(params.sketch_cap))

    def _luts(self, sketch_cap: int) -> dict:
        """The min-hits and identity-gate LUTs over sketch sizes 0..cap."""
        k, pct = self.params.kmer_size, self.params.percentage_identity
        s_max = max(sketch_cap, 1)
        lut = lambda a: torch.as_tensor(a.astype(np.int64),
                                        device=self.index.device)
        return dict(min_hits=lut(stats.min_hits_lut(k, pct, s_max)),
                    gate=lut(gate_lut_np(k, pct, s_max)))

    def with_caps(self, **caps) -> "Mapper":
        """This mapper over the same index tables with other capacity caps
        (``MapperConfig`` fields: sketch_cap, hits_cap, cand_cap,
        l2_entry_cap, unit_cap); the LUTs follow sketch_cap."""
        other = copy.copy(self)
        other.cfg = dataclasses.replace(self.cfg, **caps)
        if other.cfg.sketch_cap != self.cfg.sketch_cap:
            other.tables = dataclasses.replace(
                self.tables, **self._luts(other.cfg.sketch_cap))
        return other

    def map_batch(self, frags: torch.Tensor, qno_row=None, qsid_row=None,
                  row_valid=None) -> dict:
        return map_step_packed(self.cfg, frags, self.tables, qno_row,
                               qsid_row, row_valid)

    def probe_hits(self, frags: torch.Tensor) -> torch.Tensor:
        """The L1 hit totals of one batch without the map step (the JAX
        package's ``JitMapper.probe_fn``): the sketch (K1, K2, K3) and the
        hash probes only.  Returns an int64 (2,) tensor [max per-fragment
        hit total, batch hit sum]; hashes at or above the frequency
        threshold count 0, as in L1."""
        cfg, t = self.cfg, self.tables
        qh, s, _ = mapping.sketch_fragments(frags, cfg.kmer_size,
                                            cfg.window_size, cfg.sketch_cap)
        _, cnt = mapping.l1_ranges(qh, s, t.occ_hash, t.n_occ,
                                   cfg.freq_threshold)
        tot = cnt.sum(dim=-1)
        return torch.stack([tot.max(), tot.sum()])
