"""Reference minimizer index (counterpart of ``fastani_tpu/index/sketch.py``).

The reference keeps an unordered_map hash -> [(seqId, wpos)...]
(src/map/include/winSketch.hpp:44-341); here, as in the JAX package, the
index is a pair of sorted dense arrays on the device:

* build order  (mi_*):  entries sorted by (seqId, wpos), as winnowing emits
  them — the L2 stage's positional windows;
* lookup order (occ_*): the same entries stably sorted by hash — L1 probes
  become searchsorted ranges.  ``occ_order`` is the permutation from the
  lookup order to the build order.

Arrays may be padded past ``n_entries`` (hash UMAX, seqId/wpos 2^30), as
the device build leaves them.  Hashes are int64 tensors holding u32.
``host_view`` reads the true entries back once, as numpy, for the scalar
oracle (``utils/refmodel.py``); ``sanity_check`` is the repeat check of
``-s`` (winSketch.hpp:298-318); ``save``/``load`` persist the index in the
JAX package's ``.npz`` format (``--saveIndex``/``--loadIndex``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from fastani_tpu_torch.config import Parameters

SAVE_VERSION = 1          # the .npz layout both packages read and write


@dataclasses.dataclass
class ContigInfo:
    name: str
    length: int


@dataclasses.dataclass
class HostIndex:
    """Numpy copy of an index's true entries (what ``utils/refmodel.py``
    reads); hashes are int64 u32 values."""
    mi_hash: np.ndarray                  # (M,) build order
    mi_seqid: np.ndarray
    mi_wpos: np.ndarray
    occ_hash: np.ndarray                 # (M,) lookup order
    occ_seqid: np.ndarray
    occ_wpos: np.ndarray
    freq_threshold: int

    @property
    def num_entries(self) -> int:
        return len(self.mi_hash)


@dataclasses.dataclass
class ReferenceIndex:
    metadata: List[ContigInfo]
    # file boundaries: sequences_by_file[f] = one-past-last seqId of file f
    # (winSketch.hpp:68-75)
    sequences_by_file: np.ndarray        # (num_files,) int32, host
    mi_hash: torch.Tensor                # (M,) int64 (u32 values)
    mi_seqid: torch.Tensor               # (M,) int32
    mi_wpos: torch.Tensor                # (M,) int32
    occ_hash: torch.Tensor               # (M,) int64
    occ_seqid: torch.Tensor              # (M,) int32
    occ_wpos: torch.Tensor               # (M,) int32
    occ_order: Optional[torch.Tensor]    # (M,) int64 occ -> mi permutation
    n_entries: int                       # true entry count (<= M)
    freq_threshold: int
    # True if a piece of the build overflowed the per-piece cap;
    # build_device then rebuilds losslessly, so a finished index says False
    overflow: bool = False
    # sanity-check ratios (winSketch.hpp:298-318), set by sanity_check
    hash_ratio: float = 0.0
    uniq_hash_ratio: float = 0.0
    ratio_difference: float = 0.0
    _host: Optional[HostIndex] = dataclasses.field(default=None, repr=False)

    @property
    def device(self) -> torch.device:
        return self.mi_hash.device

    def check_build_overflow(self) -> bool:
        """Overflow flag of this index's build (checked on every build)."""
        return self.overflow

    def host_view(self) -> HostIndex:
        """The true entries (pads cut) as numpy arrays, read from the
        device once and cached."""
        if self._host is None:
            n = self.n_entries
            rd = lambda t: t[:n].cpu().numpy()
            self._host = HostIndex(
                mi_hash=rd(self.mi_hash), mi_seqid=rd(self.mi_seqid),
                mi_wpos=rd(self.mi_wpos), occ_hash=rd(self.occ_hash),
                occ_seqid=rd(self.occ_seqid), occ_wpos=rd(self.occ_wpos),
                freq_threshold=self.freq_threshold)
        return self._host

    def num_unique_hashes(self) -> int:
        """Distinct hashes among the true entries, counted on the device
        (one scalar read)."""
        occ = self.occ_hash[: self.n_entries]
        if not len(occ):
            return 0
        return int((occ[1:] != occ[:-1]).sum()) + 1

    def sanity_check(self, max_ratio_diff: float) -> bool:
        """Repeat sanity check (winSketch.hpp:298-318): hashRatio = total
        length / entries, uniqHashRatio = total length / unique hashes, in
        float32; the index fails when they differ by more than
        ``max_ratio_diff``.  An empty index fails (the reference would
        divide by zero)."""
        total_size = float(self.n_entries)
        total_length = float(sum(c.length for c in self.metadata))
        uniq = float(self.num_unique_hashes())
        if total_size == 0 or uniq == 0:
            self.hash_ratio = float("inf")
            self.uniq_hash_ratio = float("inf")
            self.ratio_difference = float("nan")
            return False
        self.hash_ratio = np.float32(total_length) / np.float32(total_size)
        self.uniq_hash_ratio = np.float32(total_length) / np.float32(uniq)
        self.ratio_difference = abs(np.float32(self.hash_ratio)
                                    - np.float32(self.uniq_hash_ratio))
        return not (self.ratio_difference > max_ratio_diff)

    def genome_of_seq(self) -> np.ndarray:
        """seqId -> genome (file) id via upper_bound on the file boundaries
        (computeCoreIdentity.hpp:31-42)."""
        num_seqs = len(self.metadata)
        return np.searchsorted(self.sequences_by_file, np.arange(num_seqs),
                               side="right").astype(np.int32)

    @classmethod
    def build_device(cls, params: Parameters,
                     ref_files: Optional[Sequence[str]] = None,
                     device="cuda") -> "ReferenceIndex":
        """Build on ``device``: K1 winnow, K2 compaction, assembly, stable
        sort by hash (index/device_build.py)."""
        from fastani_tpu_torch.index import device_build
        from fastani_tpu_torch.ops.cuda import resolve_device

        return device_build.build_device(cls, params, ref_files,
                                         resolve_device(device))

    def save(self, path: str, params: Parameters) -> None:
        """Write the true entries to ``path`` in the JAX package's ``.npz``
        format (``ReferenceIndex.save``, version 1): the build order with
        uint32 hashes, each contig's first entry (``seq_start``), contig
        names and lengths, file boundaries, and from ``params`` (the run
        that built the index) the reference files, k, w and the fragment
        length; then the frequency threshold.  Either package loads what the
        other saved.  The file is written at ``path`` itself (numpy would
        append ``.npz`` to a bare name)."""
        p, h = params, self.host_view()
        seq_start = np.searchsorted(h.mi_seqid,
                                    np.arange(len(self.metadata) + 1))
        with open(path, "wb") as f:
            np.savez_compressed(
                f, version=np.int64(SAVE_VERSION),
                kmer_size=np.int64(p.kmer_size),
                window_size=np.int64(p.window_size),
                frag_len=np.int64(p.frag_len),
                contig_names=np.array([c.name for c in self.metadata]),
                contig_lengths=np.array([c.length for c in self.metadata],
                                        np.int64),
                sequences_by_file=np.asarray(self.sequences_by_file,
                                             np.int32),
                ref_files=np.array(list(p.ref_sequences)),
                mi_hash=h.mi_hash.astype(np.uint32),
                mi_seqid=h.mi_seqid.astype(np.int32),
                mi_wpos=h.mi_wpos.astype(np.int32),
                seq_start=seq_start.astype(np.int64),
                freq_threshold=np.int64(self.freq_threshold))

    @classmethod
    def load(cls, path: str, params: Parameters,
             device="cuda") -> "ReferenceIndex":
        """An index saved by either package, on ``device`` (``cuda``
        unless the caller asks for ``cpu``; raises without a card).  The
        file's k, w and fragment length must be the run's (a ``ValueError``
        names the field that differs); ``params.ref_sequences`` becomes the
        file's reference list.  The lookup order is rebuilt by a stable sort
        by hash."""
        from fastani_tpu_torch.ops.cuda import resolve_device

        dev = resolve_device(device)
        params.finalize()
        with np.load(path, allow_pickle=False) as z:
            if int(z["version"]) != SAVE_VERSION:
                raise ValueError(f"unsupported index version "
                                 f"{int(z['version'])}")
            for field in ("kmer_size", "window_size", "frag_len"):
                have, want = int(z[field]), int(getattr(params, field))
                if have != want:
                    raise ValueError(f"index was built with {field}={have}, "
                                     f"run requests {want}")
            metadata = [ContigInfo(str(n), int(l)) for n, l in
                        zip(z["contig_names"], z["contig_lengths"])]
            params.ref_sequences = [str(f) for f in z["ref_files"]]
            mi_hash = z["mi_hash"].astype(np.int64)
            mi_seqid, mi_wpos = z["mi_seqid"], z["mi_wpos"]
            order = np.argsort(mi_hash, kind="stable")
            arrays = dict(mi_hash=mi_hash, mi_seqid=mi_seqid, mi_wpos=mi_wpos,
                          occ_hash=mi_hash[order], occ_seqid=mi_seqid[order],
                          occ_wpos=mi_wpos[order], occ_order=order,
                          sequences_by_file=z["sequences_by_file"])
            freq_threshold = int(z["freq_threshold"])
        return cls.from_numpy(arrays, metadata, dev, freq_threshold)

    @classmethod
    def from_numpy(cls, arrays: dict, metadata, device,
                   freq_threshold: int = np.iinfo(np.int32).max
                   ) -> "ReferenceIndex":
        """An index from numpy arrays (for example those of the JAX
        package's index): ``arrays`` holds mi_hash/mi_seqid/mi_wpos,
        occ_hash/occ_seqid/occ_wpos, optionally occ_order, the entry count
        ``n_entries`` (default: the array length) and sequences_by_file;
        ``metadata`` lists (name, length) pairs or ContigInfo."""
        meta = [m if isinstance(m, ContigInfo) else ContigInfo(str(m[0]), int(m[1]))
                for m in metadata]
        to = lambda a, dt: torch.as_tensor(np.asarray(a).astype(dt),
                                           device=device)
        order = arrays.get("occ_order")
        n = int(arrays.get("n_entries", len(arrays["mi_hash"])))
        return cls(
            metadata=meta,
            sequences_by_file=np.asarray(arrays["sequences_by_file"], np.int32),
            mi_hash=to(arrays["mi_hash"], np.int64),
            mi_seqid=to(arrays["mi_seqid"], np.int32),
            mi_wpos=to(arrays["mi_wpos"], np.int32),
            occ_hash=to(arrays["occ_hash"], np.int64),
            occ_seqid=to(arrays["occ_seqid"], np.int32),
            occ_wpos=to(arrays["occ_wpos"], np.int32),
            occ_order=None if order is None else to(order, np.int64),
            n_entries=n,
            freq_threshold=int(freq_threshold))
