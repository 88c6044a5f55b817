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
identity equals the host path's.  Each genome's identities are summed as
the reference sums them, a float32 left fold in bin order
(``fold_sequential``; on a card ``finalize_rows`` is one launch of
``csrc/fold.cu``, which also accumulates and clears the slots), so the
sums are the same bits on the card and on
the CPU, in every run, on a shard as in the single run, and equal to the
exact path's host fold; the JAX package's segment sums may differ from
them in the last bits (counts are exact).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from fastani_tpu_torch.ops import cuda, stats
from fastani_tpu_torch.utils import spans


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


def update_tab(tab, packed, n_valid, genome_of_seq, bin_start,
               ident_lut, frag_len: int, n_slots: int, n_rg: int,
               frag_cap: int):
    """Fold one batch's packed (7, U) block, of which the first
    ``n_valid`` (an int or a 0-d tensor on the block's device) rows are
    valid, into ``tab`` (n_slots, B_tot) int32 (float32 identity bits, -1 =
    empty), in place: exact 1-way dedupe then the 2-way scatter-max."""
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


def genome_bins(gid_of_bin, n_rg: int) -> np.ndarray:
    """(2, n_rg) int32: each reference genome's first bin and its bin
    count.  A genome's bins are one contiguous range: ``make_bin_tables``
    repeats ``genome_of_seq`` in seqId order, and seqIds are numbered file
    by file, so ``gid_of_bin`` never decreases."""
    gob = np.asarray(gid_of_bin, np.int64)
    if np.any(np.diff(gob) < 0):
        raise ValueError("gid_of_bin decreases: a genome's bins are not one "
                         "contiguous range")
    n = np.bincount(gob, minlength=n_rg)[:n_rg]
    return np.stack([np.cumsum(n) - n, n]).astype(np.int32)


def fold_sequential(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim as a left fold from 0.0, element 0 first: the
    reference's float32 accumulation (computeCoreIdentity.hpp:267-297).
    Each step is one elementwise add, so the bits do not depend on the
    device, on thread scheduling, or on zeros padded at the end."""
    cols = x.movedim(-1, 0).contiguous()
    acc = torch.zeros(cols.shape[1:], dtype=x.dtype, device=x.device)
    for c in cols.unbind(0):
        acc.add_(c)
    return acc


# bin columns gathered at a time by fold_rows_plain: bounds its scratch to
# FOLD_BLOCK x Gr x FIN floats, whatever the longest genome's bin count
FOLD_BLOCK = 64


def fold_rows(rows: torch.Tensor, ranges: torch.Tensor):
    """Per (row, reference genome): the count of occupied bins and the sum
    of their identities, a float32 left fold over the genome's bins in bin
    order as ``fold_sequential`` sums.  ``rows`` (FIN, B_tot) int32 holds
    float32 identity bits, -1 where a bin is empty; ``ranges`` is
    ``genome_bins``' (2, Gr) int32 first bins and bin counts.  Returns
    (counts (FIN, Gr) int32, sums (FIN, Gr) float32); reads ``rows`` only.
    Launches ``csrc/fold.cu`` (one warp per row and genome) on CUDA
    tensors, runs ``fold_rows_plain`` on CPU tensors."""
    if rows.device.type == "cpu":
        return fold_rows_plain(rows, ranges)
    if rows.dtype != torch.int32 or ranges.dtype != torch.int32:
        raise ValueError(f"fold_rows: int32 rows and ranges expected, got "
                         f"{rows.dtype} and {ranges.dtype}")
    FIN, B_tot = rows.shape
    Gr = ranges.shape[1]
    rows, ranges = rows.contiguous(), ranges.contiguous()
    cuda.require_cuda("fold_rows", rows, ranges)
    counts = torch.empty((FIN, Gr), dtype=torch.int32, device=rows.device)
    sums = torch.empty((FIN, Gr), dtype=torch.float32, device=rows.device)
    if FIN and Gr:
        err = cuda.lib("fold").fa_fold_rows(
            rows.data_ptr(), ranges[0].data_ptr(), ranges[1].data_ptr(), FIN,
            B_tot, Gr, counts.data_ptr(), sums.data_ptr(), cuda.stream())
        cuda.check(err, "fold")
        cuda.LAUNCHES["fold"] += 1
    return counts, sums


def fold_rows_plain(rows: torch.Tensor, ranges: torch.Tensor):
    """Plain PyTorch version of the fold kernel: counts as int32
    prefix-sum differences over each genome's bin range; sums by one
    elementwise add a bin column of the longest genome (FOLD_BLOCK columns
    gathered at a time), zeros past a shorter genome's last bin."""
    FIN, B_tot = rows.shape
    dev = rows.device
    start, n = ranges[0].long(), ranges[1].long()
    occ = rows >= 0
    cs = torch.zeros((FIN, B_tot + 1), dtype=torch.int32, device=dev)
    cs[:, 1:] = occ.cumsum(1, dtype=torch.int32)
    # row j: each genome's j-th bin, the zero column B_tot past its last
    j = torch.arange(max(int(n.max()) if n.numel() else 0, 1),
                     device=dev)[:, None]
    bins = torch.where(j < n, start + j, B_tot)
    vals = torch.zeros((B_tot + 1, FIN), dtype=torch.float32, device=dev)
    vals[:B_tot] = torch.where(occ, rows.view(torch.float32), 0.0).t()
    acc = torch.zeros((ranges.shape[1], FIN), dtype=torch.float32,
                      device=dev)
    for j0 in range(0, bins.shape[0], FOLD_BLOCK):
        for col in vals[bins[j0:j0 + FOLD_BLOCK]].unbind(0):
            acc.add_(col)                               # (Gr, FIN)
    return cs[:, start + n] - cs[:, start], acc.t()


def fold_rows_tiled(rows: torch.Tensor, ranges: torch.Tensor, tile: int):
    """The fold kernel's order restated in torch, for the tests: each
    genome's bins read in tiles of ``tile`` words aligned on multiples of
    ``tile`` of the flattened rows (a genome's first tile may start before
    it and its last run past it, both masked), each tile's occupied bins
    counted at once (the kernel's ballot) and their identities added one
    by one in bin order, empty bins skipped.  Returns what
    ``fold_rows_plain`` returns, the same bits at every ``tile``."""
    FIN, B_tot = rows.shape
    flat = rows.reshape(-1)
    start, n = ranges[0].long(), ranges[1].long()
    first = torch.arange(FIN)[:, None] * B_tot + start     # (FIN, Gr)
    lead = first % tile
    n_tiles = int(((lead + n + tile - 1) // tile).max()) if n.numel() else 0
    counts = torch.zeros(first.shape, dtype=torch.int32)
    sums = torch.zeros(first.shape, dtype=torch.float32)
    for t in range(n_tiles):
        in_tile = torch.zeros_like(counts)
        for lane in range(tile):
            i = t * tile + lane - lead                  # bin of the genome
            v = flat[(first + i).clamp(0, max(flat.numel() - 1, 0))]
            occ = (i >= 0) & (i < n) & (v >= 0)
            in_tile += occ
            sums = torch.where(occ, sums + v.view(torch.float32), sums)
        counts += in_tile
    return counts, sums


def _check_finalize_args(tab, acc_counts, acc_sums, fin_qnos, ranges,
                         n_slots: int, rows) -> None:
    """The kernel form's checks: dtypes, shapes, the card, contiguity
    (every tensor is read or written where it lies)."""
    tensors = [tab, acc_counts, acc_sums, fin_qnos, ranges]
    want = [torch.int32, torch.int32, torch.float32, torch.int64,
            torch.int32]
    if rows is not None:
        tensors.append(rows)
        want.append(torch.int32)
    got = [t.dtype for t in tensors]
    if got != want:
        raise ValueError(f"finalize_rows: dtypes {got}, expected {want}")
    if (acc_counts.shape != acc_sums.shape
            or acc_counts.shape[1] != ranges.shape[1]
            or not 1 <= n_slots <= tab.shape[0]
            or (rows is not None and tuple(rows.shape)
                != (fin_qnos.shape[0], tab.shape[1]))):
        raise ValueError(f"finalize_rows: tab {tuple(tab.shape)}, acc "
                         f"{tuple(acc_counts.shape)} and "
                         f"{tuple(acc_sums.shape)}, ranges "
                         f"{tuple(ranges.shape)}, n_slots {n_slots}, rows "
                         f"{None if rows is None else tuple(rows.shape)}")
    cuda.require_cuda("finalize_rows", *tensors)


def finalize_rows(tab, acc_counts, acc_sums, fin_qnos: torch.Tensor,
                  ranges, n_slots: int, rows=None):
    """Fold the table rows of the listed query genomes into the (Gq, Gr)
    accumulators and clear their slots, in place.  ``fin_qnos`` (FIN,)
    int64 lists query genomes whose last fragment has been folded, no two
    in one slot (``StreamingCGI.finalize_list`` checks); ``ranges`` is
    ``genome_bins``' (2, Gr) table; ``rows`` (FIN, B_tot), when given, is
    folded in place of their slots' rows.  Each genome's count and sum are
    ``fold_rows``', so a sum does not depend on the other genomes.  On a
    CUDA table one launch of ``csrc/fold.cu`` does it all (read the slots,
    fold, accumulate, clear); on CPU tensors ``finalize_rows_plain``
    runs."""
    if tab.device.type == "cpu":
        return finalize_rows_plain(tab, acc_counts, acc_sums, fin_qnos,
                                   ranges, n_slots, rows)
    FIN = fin_qnos.shape[0]
    if not FIN:
        return tab, acc_counts, acc_sums
    _check_finalize_args(tab, acc_counts, acc_sums, fin_qnos, ranges,
                         n_slots, rows)
    Gq, Gr = acc_counts.shape
    # the ranges' two rows by address, so no torch op runs on the card
    err = cuda.lib("fold").fa_finalize_rows(
        tab.data_ptr(), None if rows is None else rows.data_ptr(),
        fin_qnos.data_ptr(), ranges.data_ptr(), ranges.data_ptr() + 4 * Gr,
        FIN, n_slots, tab.shape[1], Gr, Gq, acc_counts.data_ptr(),
        acc_sums.data_ptr(), cuda.stream())
    cuda.check(err, "fold")
    cuda.LAUNCHES["fold"] += 1
    return tab, acc_counts, acc_sums


def finalize_rows_plain(tab, acc_counts, acc_sums, fin_qnos: torch.Tensor,
                        ranges, n_slots: int, rows=None):
    """Plain PyTorch version of ``finalize_rows``: the slots' rows
    gathered (unless ``rows`` is given), ``fold_rows_plain``, two
    ``index_add_`` into the accumulators, ``index_fill_`` of the slots."""
    FIN = fin_qnos.shape[0]
    if not FIN:
        return tab, acc_counts, acc_sums
    slots = fin_qnos % n_slots
    if rows is None:
        rows = tab[slots]                               # (FIN, B_tot)
    counts, sums = fold_rows_plain(rows, ranges)
    acc_counts.index_add_(0, fin_qnos, counts)
    acc_sums.index_add_(0, fin_qnos, sums)
    # index_fill_, not tab[slots] = -1: the latter uploads the -1 with a
    # pageable copy, which waits for the device
    tab.index_fill_(0, slots, -1)
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
        # each genome's bin range, made once for every finalize call; the
        # fold kernel clears a slot's row range by range, so they must
        # cover it
        ranges = genome_bins(gid_of_bin, n_ref_genomes)
        if int(ranges[1].astype(np.int64).sum()) != self.B_tot:
            raise ValueError(f"the genomes' bins cover "
                             f"{int(ranges[1].sum())} of {self.B_tot} bins")
        self._ranges = torch.as_tensor(ranges, device=dev)
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

    def update(self, packed: torch.Tensor, n_valid) -> None:
        """Fold one batch's packed block; ``n_valid`` may be a 0-d device
        tensor (the batch's ``counts[0]``), so nothing is read.  Span
        ``cgi.update``."""
        with spans.span("cgi.update"):
            update_tab(self._tab, packed, n_valid, self._gos,
                       self._bin_start, self._lut, self.frag_len,
                       self.n_slots, self.n_rg, self.frag_cap)

    def finalize_list(self, qnos: Sequence[int], peers=(),
                      reduce_max=None) -> None:
        """Close the listed query genomes: fold their slots' bin rows into
        this accumulator and clear the slots.  No two of ``qnos`` may
        share a slot (``q % n_slots``): on a card one launch reads and
        clears every slot of the call.

        On a mesh, a query genome's fragments are split over the q cells of
        each reference shard, so a bin's best identity may sit in another
        cell's table.  Each row is first merged (the q-merge, the JAX
        package's ``finalize_rows(q_axis="q")``): the elementwise max over
        this table and those of ``peers``, the other cells of the shard
        that this process runs (their slots are cleared, they fold
        nothing), then ``reduce_max``, which replaces a tensor in place by
        its max over the processes that run the shard's other cells.  The
        tables hold non-negative float32 bits or -1, so the max of the
        int32 words is the max of the identities.  Span ``cgi.finalize``."""
        qnos = [int(q) for q in qnos]
        if len({q % self.n_slots for q in qnos}) != len(qnos):
            raise ValueError(f"finalize_list: query genomes {qnos} share a "
                             f"slot of {self.n_slots}")
        if any(not 0 <= q < self.n_qg for q in qnos):
            raise ValueError(f"finalize_list: query genomes {qnos} outside "
                             f"[0, {self.n_qg})")
        with spans.span("cgi.finalize"):
            fin = torch.from_numpy(np.asarray(qnos, np.int64))
            if self._tab.device.type == "cuda":
                # pinned and non_blocking: a pageable copy waits for the device
                fin = fin.pin_memory().to(self._tab.device, non_blocking=True)
            rows = None
            if peers or reduce_max is not None:
                slots = fin % self.n_slots
                rows = self._tab[slots]
                for p in peers:
                    rows = torch.maximum(rows, p._tab[slots])
                    p._tab.index_fill_(0, slots, -1)
                if reduce_max is not None:
                    reduce_max(rows)
            finalize_rows(self._tab, self._counts, self._sums, fin,
                          self._ranges, self.n_slots, rows=rows)

    def result(self):
        return self._counts.cpu().numpy(), self._sums.cpu().numpy()
