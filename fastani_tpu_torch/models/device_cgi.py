"""Device CGI aggregation: mapping rows -> per-genome-pair tallies
(counterpart of ``fastani_tpu/models/device_cgi.py``: ``identity_lut_full``,
``make_bin_tables``, ``update_tab``, ``finalize_rows``, ``StreamingCGI``).

The fast path for cgi::computeCGI (src/cgi/include/computeCoreIdentity.hpp:
166-298): each batch folds into a device table of the best identity per
(query slot, global reference position bin) after an exact per-batch
1-way dedupe (a fragment's rows all live in one batch) — the 2-way law of
:237-255.  A query genome's slot is folded into the (Gq, Gr) accumulators
once its last batch has passed, and the slot is reused; on a mesh the
slot's row is first merged over the q cells (``StreamingCGI.finalize_list``).
Identities come
from a float32 LUT over (sketch size, shared count), so each row's
identity equals the host path's; the per-pair sums are float32 reductions
in another order, so they may differ from the JAX package in the last
bits (counts are exact).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from fastani_tpu_torch.ops import stats


def identity_lut_full(k: int, s_max: int) -> np.ndarray:
    """lut[s, c] = 100 * (1 - mash_distance(c / s, k)) as float32 for
    c <= s (map_stats.hpp:44-54), zero elsewhere."""
    ident, _ = stats.identity_tables(k, s_max)
    return ident


def make_bin_tables(metadata_lengths, genome_of_seq, frag_len: int):
    """Global reference-bin layout: bin id = bin_start[sid] + pos // width
    with width = frag_len - 20 (computeCoreIdentity.hpp:194).
    Returns (bin_start (S+1,) int32, gid_of_bin (B_tot,) int32)."""
    width = frag_len - 20
    lens = np.asarray(metadata_lengths, np.int64)
    n_bins = lens // width + 1
    bin_start = np.zeros(len(lens) + 1, np.int64)
    bin_start[1:] = np.cumsum(n_bins)
    gid_of_bin = np.repeat(np.asarray(genome_of_seq, np.int32), n_bins)
    return bin_start.astype(np.int32), gid_of_bin


def update_tab(tab, packed, n_valid: int, genome_of_seq, bin_start,
               ident_lut, frag_len: int, n_slots: int, n_rg: int,
               frag_cap: int):
    """Fold one batch's packed (7, U) block into ``tab`` (n_slots, B_tot)
    int32 (float32 identity bits, -1 = empty), in place: exact 1-way dedupe
    then the 2-way scatter-max."""
    frag, qno, qsid, sid, shared, sketch, pos = (packed[i].long()
                                                 for i in range(7))
    U = sid.shape[0]
    dev = tab.device
    valid = torch.arange(U, device=dev) < n_valid
    ident = ident_lut[sketch.clamp(0, ident_lut.shape[0] - 1),
                      shared.clamp(0, ident_lut.shape[1] - 1)]
    # non-negative float32 bit patterns order like the floats
    ibits = torch.where(valid, ident, 0.0).view(torch.int32)
    ibits = torch.where(valid, ibits, -1)
    gid = genome_of_seq[sid.clamp(0, genome_of_seq.shape[0] - 1)].long()

    # exact 1-way: best (ident, sid, pos) per (refGenome, fragment) — the
    # overwrite law of computeCoreIdentity.hpp:212-232 with the
    # cmp_query_bucket tie-breakers (cgid_types.hpp:31-39), resolved by
    # three scatter-max passes
    idx1 = torch.where(valid, gid * frag_cap + frag, n_rg * frag_cap)
    T1 = n_rg * frag_cap + 1

    def best_of(vals):
        t = torch.full((T1,), -1, dtype=vals.dtype, device=dev)
        return t.scatter_reduce_(0, idx1, vals, "amax")[idx1]

    w1 = valid & (ibits == best_of(ibits))
    w2 = w1 & (sid == best_of(torch.where(w1, sid, -1)))
    keep1 = w2 & (pos == best_of(torch.where(w2, pos, -1)))

    # 2-way fold: running max identity per (slot, global ref bin)
    B_tot = tab.shape[1]
    bin_id = (bin_start[sid.clamp(0, bin_start.shape[0] - 2)].long()
              + pos // (frag_len - 20))
    idx2 = torch.where(keep1, (qno % n_slots) * B_tot + bin_id,
                       n_slots * B_tot - 1)
    tab.view(-1).scatter_reduce_(0, idx2, torch.where(keep1, ibits, -1),
                                 "amax")
    return tab


def finalize_rows(tab, acc_counts, acc_sums, fin_qnos: torch.Tensor,
                  gid_of_bin, n_slots: int, n_rg: int, rows=None):
    """Fold the table rows of the listed query genomes into the (Gq, Gr)
    accumulators and clear their slots, in place.  ``fin_qnos`` (FIN,)
    lists query genomes whose last fragment has been folded; ``rows``
    (FIN, B_tot), when given, is folded in place of their slots' rows."""
    FIN = fin_qnos.shape[0]
    if not FIN:
        return tab, acc_counts, acc_sums
    dev = tab.device
    slots = fin_qnos % n_slots
    if rows is None:
        rows = tab[slots]                               # (FIN, B_tot)
    occ = rows >= 0
    ident = torch.where(occ, rows.view(torch.float32), 0.0)
    seg = torch.where(occ, gid_of_bin[None, :].long(), n_rg)
    seg_flat = (torch.arange(FIN, device=dev)[:, None] * (n_rg + 1)
                + seg).reshape(-1)
    cnt = torch.zeros(FIN * (n_rg + 1), dtype=torch.int32, device=dev)
    cnt.index_add_(0, seg_flat, occ.to(torch.int32).reshape(-1))
    sm = torch.zeros(FIN * (n_rg + 1), dtype=torch.float32, device=dev)
    sm.index_add_(0, seg_flat, ident.reshape(-1))
    acc_counts.index_add_(0, fin_qnos, cnt.view(FIN, n_rg + 1)[:, :n_rg])
    acc_sums.index_add_(0, fin_qnos, sm.view(FIN, n_rg + 1)[:, :n_rg])
    tab[slots] = -1
    return tab, acc_counts, acc_sums


class StreamingCGI:
    """Bounded-memory device CGI accumulator: ``update`` folds one batch,
    ``finalize_list`` closes finished query genomes (slots recycle modulo
    n_slots), ``result`` returns the (counts, sums) matrices on the host."""

    def __init__(self, index, params, n_query_genomes: int,
                 n_ref_genomes: int, n_slots: int, frag_cap: int):
        dev = index.device
        self.frag_len = params.frag_len
        self.n_qg = n_query_genomes
        self.n_rg = n_ref_genomes
        self.n_slots = max(int(n_slots), 1)
        self.frag_cap = int(frag_cap)
        gos = index.genome_of_seq()
        bin_start, gid_of_bin = make_bin_tables(
            [c.length for c in index.metadata], gos, params.frag_len)
        self.B_tot = int(len(gid_of_bin))
        self._bin_start = torch.as_tensor(bin_start, device=dev)
        self._gid_of_bin = torch.as_tensor(gid_of_bin, device=dev)
        self._gos = torch.as_tensor(gos, device=dev)
        s_max = max(params.sketch_cap, 1)
        self._lut = torch.as_tensor(identity_lut_full(params.kmer_size, s_max),
                                    device=dev)
        self._tab = torch.full((self.n_slots, self.B_tot), -1,
                               dtype=torch.int32, device=dev)
        self._counts = torch.zeros((self.n_qg, self.n_rg), dtype=torch.int32,
                                   device=dev)
        self._sums = torch.zeros((self.n_qg, self.n_rg), dtype=torch.float32,
                                 device=dev)

    def update(self, packed: torch.Tensor, n_valid: int) -> None:
        update_tab(self._tab, packed, n_valid, self._gos, self._bin_start,
                   self._lut, self.frag_len, self.n_slots, self.n_rg,
                   self.frag_cap)

    def finalize_list(self, qnos: Sequence[int], peers=(),
                      reduce_max=None) -> None:
        """Close the listed query genomes: fold their slots' bin rows into
        this accumulator and clear the slots.

        On a mesh, a query genome's fragments are split over the q cells of
        each reference shard, so a bin's best identity may sit in another
        cell's table.  Each row is first merged (the q-merge, the JAX
        package's ``finalize_rows(q_axis="q")``): the elementwise max over
        this table and those of ``peers``, the other cells of the shard
        that this process runs (their slots are cleared, they fold
        nothing), then ``reduce_max``, which replaces a tensor in place by
        its max over the processes that run the shard's other cells.  The
        tables hold non-negative float32 bits or -1, so the max of the
        int32 words is the max of the identities."""
        fin = torch.as_tensor(np.asarray(list(qnos), np.int64),
                              device=self._tab.device)
        rows = None
        if peers or reduce_max is not None:
            slots = fin % self.n_slots
            rows = self._tab[slots]
            for p in peers:
                rows = torch.maximum(rows, p._tab[slots])
                p._tab[slots] = -1
            if reduce_max is not None:
                reduce_max(rows)
        finalize_rows(self._tab, self._counts, self._sums, fin,
                      self._gid_of_bin, self.n_slots, self.n_rg, rows=rows)

    def result(self):
        return self._counts.cpu().numpy(), self._sums.cpu().numpy()
