"""Reference index build on the device (counterpart of
``fastani_tpu/index/device_build.py::build_device``).

    1. cut every contig into haloed segment rows (host, numpy);
    2. K1 winnow the rows (ops/winnow.py), many contigs per launch — the
       emit selection carries across a contig's rows inside the kernel;
    3. K2 compact each 1024-position piece of the output to ``_CAP_R``
       slots, with its count (ops/compact.py), and keep only each piece's
       filled slots: a flush holds its entries, not its padded pieces;
    4. assemble: the flushes' entries end to end (their order is the
       exclusive cumsum of the piece counts) in arrays padded to
       ``out_size`` (hash UMAX, seqId/wpos 2^30);
    5. stable sort by hash, on 32-bit keys: the lookup (occ) view and
       ``occ_order``.

The result equals the JAX package's device build array for array (same
entries, same padding, same ``out_size``).  Overflow is checked on every
build: a piece with more than ``_CAP_R`` emits triggers a rebuild with the
cap at the piece length, which cannot overflow, and an ``out_size`` too
small for the entries is grown to fit (replaces skch::Sketch::build+index,
winSketch.hpp:124-193).  The build's device memory stays near the bytes of
the arrays it returns (40 a slot): the flushes' entries (12 bytes each),
then the padded arrays, then the sort's key, order and buffers.

Step 1 runs ahead of the flushes: each file's read, parse, uppercase
and ``segment_rows`` on worker threads (``_ParseAhead``), its results
taken in file order on the build's thread, which alone numbers the
seqIds, counts the parse and keeps it in the job's memo.

Spans (``utils/spans.py``): ``index.parse`` a reference file on the
build's thread (the wait for its parse, and the bookkeeping: the memo,
which keeps it for its later readers, so a rebuild parses only the files
whose bytes it did not keep, and the counters; the workers record no
span), ``index.flush`` a winnow launch with ``index.concat`` (the
pending rows joined on the host), ``index.upload`` (their copy to the
device), ``index.overflow_read`` (the wait on K1 and K2 and the overflow
flag) and ``index.place`` (its entries compacted) under it,
``index.assemble`` (steps 4 and 5, waited for on the card) with
``index.sort`` (step 5) under it, and ``index.rebuild`` around a
rebuild.  Counters ``index.bytes``: the bytes of the returned index's
device arrays; ``index.parse_threads``, ``index.parse_ready`` and
``index.parse_work_ns``: the parse's workers, the files ready when
reached and the workers' seconds (``_ParseAhead``).
"""

from __future__ import annotations

import os
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from fastani_tpu_torch.config import Parameters
from fastani_tpu_torch.io import fasta
from fastani_tpu_torch.ops import compact, winnow
from fastani_tpu_torch.ops.xputils import PINF, UMAX
from fastani_tpu_torch.utils import spans

_ROW = 1 << 10            # compaction piece length
_CAP_R = _ROW // 4        # per-piece minimizer cap (density ~2/(w+1))
_SEG = 17 * _ROW          # scored positions per segment row
_FLUSH_ROWS = 2048        # segment rows per winnow launch (~35 Mbp)
_MARGIN = 2048            # sentinel entries past the last (L2 window slices)
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def _pow2(x: int, floor: int = 128) -> int:
    return max(floor, 1 << max(int(x) - 1, 1).bit_length())


def segment_rows(seq: np.ndarray, k: int, w: int, seg: int = _SEG):
    """Haloed segment rows of one contig: row i covers global positions
    [i*seg - (w-1), i*seg - (w-1) + W), W = (w-1) + seg + (k-1), zero
    outside the contig.  Returns (rows (n, W) uint8, base (n,) int32)."""
    halo = w - 1
    L = len(seq)
    n = -(-L // seg)
    W = halo + seg + k - 1
    padded = np.zeros(halo + n * seg + k - 1, np.uint8)
    padded[halo: halo + L] = seq
    rows = np.lib.stride_tricks.sliding_window_view(padded, W)[::seg][:n]
    return np.ascontiguousarray(rows), np.arange(n, dtype=np.int32) * seg


def _cut(seqs, k: int, w: int):
    """Each contig's ``segment_rows``, None for one too short to winnow."""
    return [None if len(s) < w or len(s) < k else segment_rows(s, k, w)
            for s in seqs]


def _parse_file(path: str, k: int, w: int):
    """A worker's whole share of a file: its records uppercased
    (``fasta.read_contigs``, uncounted), each contig's rows, and the
    nanoseconds it took."""
    t0 = time.perf_counter_ns()
    c = fasta.read_contigs(path)
    return c, _cut(c.seqs, k, w), time.perf_counter_ns() - t0


class _ParseAhead:
    """The reference files' parses (``_parse_file``) on a pool of worker
    threads, at most two a worker ahead of the build's loop, which takes
    them in file order (``take``) and keeps the bookkeeping on its own
    thread: the memo and the parse counters (``fasta.keep``) and the spans.
    A file whose bytes the job's memo holds is not sent.  The workers are
    the usable cores less the build's own thread, at least one, at most the
    files.  Gauge ``index.parse_threads``: the pool's size; counters
    ``index.parse_ready``: the files whose parse was done when the loop
    reached them, ``index.parse_work_ns``: the workers' parse time."""

    def __init__(self, files: Sequence[str], k: int, w: int):
        self.files, self.k, self.w = files, k, w
        n = max(1, min(len(os.sched_getaffinity(0)) - 1, len(files)))
        self.pool = ThreadPoolExecutor(n, thread_name_prefix="index.parse")
        spans.gauge("index.parse_threads", n)
        self.depth = 2 * n
        self.futs: Dict[int, Future] = {}
        self.next = 0

    def __enter__(self):
        self._fill()
        return self

    def __exit__(self, *exc):
        self.pool.shutdown(wait=True, cancel_futures=True)
        return False

    def _fill(self) -> None:
        while len(self.futs) < self.depth and self.next < len(self.files):
            p = self.files[self.next]
            if not fasta.held(p):
                self.futs[self.next] = self.pool.submit(
                    _parse_file, p, self.k, self.w)
            self.next += 1

    def take(self, i: int):
        """File ``i``'s records (the memo's, or the worker's parse, counted
        and kept: ``fasta.keep``) and each contig's rows (None for a contig
        too short to winnow).  A worker's error is raised here."""
        path = self.files[i]
        fut = self.futs.pop(i, None)
        self._fill()
        if fasta.held(path):                 # the memo's bytes
            if fut is not None:
                fut.cancel()
            recs = fasta.contigs(path)
            return recs, _cut(recs.seqs, self.k, self.w)
        spans.count("index.parse_ready", int(fut.done()))
        recs, cuts, ns = fut.result()
        spans.count("index.parse_work_ns", ns)
        return fasta.keep(path, recs), cuts


def build_device(cls, params: Parameters,
                 ref_files: Optional[Sequence[str]] = None, device="cuda"):
    """Device-resident ReferenceIndex build (``cls`` is ReferenceIndex)."""
    index = _build(cls, params, ref_files, device, _CAP_R)
    if index.overflow:
        # a piece over the per-piece cap (degenerate repeats): rebuild with
        # the cap at the piece length, which cannot overflow
        with spans.span("index.rebuild"):
            index = _build(cls, params, ref_files, device, _ROW)
    spans.gauge("index.bytes", sum(
        t.numel() * t.element_size() for t in (
            index.mi_hash, index.mi_seqid, index.mi_wpos, index.occ_hash,
            index.occ_seqid, index.occ_wpos, index.occ_order)))
    return index


def _build(cls, params, ref_files, device, cap: int):
    from fastani_tpu_torch.index.sketch import ContigInfo

    files = list(ref_files if ref_files is not None else params.ref_sequences)
    k, w = params.kmer_size, params.window_size
    metadata: List[ContigInfo] = []
    seq_by_file: List[int] = []
    # each flush's entries in build order, compacted to their true count:
    # (hash int32 words, wpos int32, seqId int32), each (n,)
    parts = []
    n_pieces = 0
    pend_rows, pend_sid, pend_base, pend_len = [], [], [], []
    overflow = False

    def flush():
        nonlocal overflow, n_pieces
        if not pend_rows:
            return
        with spans.span("index.flush"):
            with spans.span("index.concat"):
                host = [np.concatenate(a) for a in
                        (pend_rows, pend_sid, pend_base, pend_len)]
            with spans.span("index.upload"):
                rows, sid_t, base, plen = (
                    torch.as_tensor(a, device=device) for a in host)
            sid = host[1]
            emit, h = winnow.winnow_rows(rows, sid_t, base, plen, k, w)
            wp = winnow.positions(base, _SEG, w)
            per = _SEG // _ROW
            e2 = emit.reshape(-1, _ROW)
            cnt = e2.sum(dim=1)
            hc, wc = compact.compact_rows(
                e2, [(h.reshape(-1, _ROW), -1), (wp.reshape(-1, _ROW), PINF)],
                width=cap)
            with spans.span("index.overflow_read"):
                overflow |= bool((cnt > cap).any())
            with spans.span("index.place"):
                # a piece's first min(count, cap) slots hold its entries:
                # row-major, they are the entries in build order
                keep = (torch.arange(cap, device=device)[None, :]
                        < cnt.clamp(max=cap)[:, None])
                psid = torch.as_tensor(np.repeat(sid, per), device=device)
                parts.append((hc[keep], wc[keep],
                              psid[:, None].expand(keep.shape)[keep]))
            n_pieces += len(cnt)
        pend_rows.clear()
        pend_sid.clear()
        pend_base.clear()
        pend_len.clear()

    seq_counter = 0
    n_pend = 0
    with _ParseAhead(files, k, w) as ahead:
        for i in range(len(files)):
            # the file's contigs parsed and cut first (on a worker, ahead
            # of this loop), then queued for the flushes, so a flush never
            # falls inside a file's parse
            with spans.span("index.parse", file=i):
                recs, cuts = ahead.take(i)
                parsed = []
                for name, seq, cut in zip(recs.names, recs.seqs, cuts):
                    metadata.append(ContigInfo(name, len(seq)))
                    if cut is not None:
                        parsed.append((cut, seq_counter, len(seq)))
                    seq_counter += 1
            for (rows, base), sid, L in parsed:
                if n_pend and n_pend + len(rows) > _FLUSH_ROWS:
                    flush()
                    n_pend = 0
                pend_rows.append(rows)
                pend_sid.append(np.full(len(rows), sid, np.int32))
                pend_base.append(base)
                pend_len.append(np.full(len(rows), L, np.int32))
                n_pend += len(rows)
            seq_by_file.append(seq_counter)
    flush()
    with spans.span("index.assemble"):
        return _assemble(cls, device, w, metadata, seq_by_file, parts,
                         max(n_pieces, 1), overflow)


def _assemble(cls, device, w: int, metadata, seq_by_file, parts,
              n_pieces: int, overflow: bool):
    """Steps 4 and 5: the flushes' entries laid end to end in arrays
    padded to ``out_size`` (each flush's part freed as it is copied) and
    sorted by hash; returns the index."""
    total = sum(len(p[0]) for p in parts)

    # output size from the total sequence length: winnow density is close
    # to 2/(w+1), so bases * density * 1.15 + slack bounds the entry count
    # (the JAX package's formula, so both builds pad alike); the margin
    # past the last entry lets L2 read contiguous entry windows
    total_bases = sum(c.length for c in metadata)
    est = int(total_bases * (2.0 / (w + 1)) * 1.15) + 4096
    out_size = min(_pow2(est),
                   _pow2(_pow2(n_pieces, floor=8) * _CAP_R + _MARGIN))
    if total > out_size - _MARGIN:        # undersized estimate: grow it
        out_size = _pow2(total + _MARGIN)

    full = lambda fill, dtype: torch.full((out_size,), fill, dtype=dtype,
                                          device=device)
    mi_hash = full(UMAX, torch.int64)
    mi_wpos = full(PINF, torch.int32)
    mi_sid = full(PINF, torch.int32)
    # the sort key: the u32 hash with its top bit flipped, an int32 whose
    # signed order is the hash's order (pads UMAX -> int32 max, last)
    key = full(_I32_MAX, torch.int32)
    off = 0
    parts.reverse()
    while parts:
        h, wp, sid = parts.pop()
        end = off + len(h)
        mi_hash[off:end] = h.to(torch.int64) & UMAX
        key[off:end] = h ^ _I32_MIN
        mi_wpos[off:end] = wp
        mi_sid[off:end] = sid
        off = end
    _wait(key)
    with spans.span("index.sort"):
        skey, order = torch.sort(key, stable=True)
        del key
        occ_hash = skey.to(torch.int64)
        del skey
        occ_hash -= _I32_MIN
        occ_sid, occ_wpos = mi_sid[order], mi_wpos[order]
        _wait(occ_wpos)
    return cls(metadata=metadata,
               sequences_by_file=np.asarray(seq_by_file, np.int32),
               mi_hash=mi_hash, mi_seqid=mi_sid, mi_wpos=mi_wpos,
               occ_hash=occ_hash, occ_seqid=occ_sid, occ_wpos=occ_wpos,
               occ_order=order, n_entries=total,
               freq_threshold=int(np.iinfo(np.int32).max),
               overflow=overflow)


def _wait(t: torch.Tensor) -> None:
    """Wait for the card's queued work, so that the span around it holds
    its device time (the caller waits for the index anyway)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
