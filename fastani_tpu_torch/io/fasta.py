"""FASTA/FASTQ reading, plain or gzip (counterpart of
``fastani_tpu/io/fasta.py``).

Record semantics of the reference's kseq parser (src/common/kseq.h):
records begin at '>' (FASTA) or '@' (FASTQ), the name is the header text
up to the first whitespace, the sequence is the concatenation of sequence
lines, FASTQ quality lines are skipped.

Two parsers with these semantics: the native C++ one (``native``), which
``read_sequences`` runs, and the pure-Python one (``read_sequences_py``),
the oracle of the native one, which ``read_sequences`` runs only under the
JAX package's switch ``FASTANI_TPU_NO_NATIVE``.  ``FASTANI_TRACE_READS``
names a file to which each parsed path is appended (the JAX package's
hook: tests check which genome files a process reads).  Each parse also
counts into the open job (``utils/spans.py``): ``fasta.parses``, also
under the innermost open span (the parse's purpose), and
``fasta.files``, the distinct paths parsed.  ``read_contigs`` is the
parse alone, uncounted, for a worker thread (the index build's); the
job's thread counts its result, and keeps it, with ``keep``.

A job parses each genome file once: it opens ``memo(query paths)``, and
inside it ``contigs`` (names and uppercased contig bytes; ``held`` says
whether it would answer from the memo) and
``contig_lengths`` keep what a path's first parse gave, wherever it
happens, and give it out to every later reader of the path.  Every path
keeps its names and lengths; only a query path keeps its bytes, until
``release`` (the query stream has passed it) or while the held bytes stay
under half of the host's physical memory; past that a load parses again.
Each answer from the memo counts ``fasta.memo_hits``, also by purpose as
``fasta.parses`` does.  Outside a memo both functions parse every call.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import gzip
import os
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from fastani_tpu_torch import native
from fastani_tpu_torch.ops import hashing
from fastani_tpu_torch.utils import spans


def _open_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        head = f.read(2)
        f.seek(0)
        if head[:2] == b"\x1f\x8b":
            with gzip.open(f) as gz:
                return gz.read()
        return f.read()


def _count_parse(path: str) -> None:
    """Record one parse of ``path`` in the open job (and the
    ``FASTANI_TRACE_READS`` line): on the thread that holds the job."""
    trace = os.environ.get("FASTANI_TRACE_READS")
    if trace:
        with open(trace, "a") as f:
            f.write(path + "\n")
    spans.count("fasta.parses", by_span=True)
    spans.distinct("fasta.files", path)


def _records(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """``read_sequences`` uncounted."""
    if os.environ.get("FASTANI_TPU_NO_NATIVE"):
        yield from read_sequences_py(path)
        return
    names, seq, offsets = native.parse(_open_bytes(path))
    for i, name in enumerate(names):
        yield name, seq[offsets[i]:offsets[i + 1]]


def read_sequences(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield (name, sequence bytes as a uint8 array) per record, in order:
    the native parser's records, or with ``FASTANI_TPU_NO_NATIVE`` set the
    Python parser's."""
    _count_parse(path)
    yield from _records(path)


def read_sequences_py(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """The pure-Python parser (the native parser's oracle)."""
    data = _open_bytes(path)
    n = len(data)
    i = 0
    # skip leading junk until the first record marker (kseq does the same)
    while i < n and data[i] not in (0x3E, 0x40):  # '>' '@'
        i = data.find(b"\n", i)
        if i < 0:
            return
        i += 1
    while i < n:
        marker = data[i]
        eol = data.find(b"\n", i)
        if eol < 0:
            eol = n
        header = data[i + 1 : eol]
        for ws in (b" ", b"\t"):
            cut = header.find(ws)
            if cut >= 0:
                header = header[:cut]
        name = header.decode("ascii", "replace").strip("\r")
        i = eol + 1
        chunks: List[bytes] = []
        if marker == 0x3E:  # FASTA: read until the next '>' or '@' line
            while i < n and data[i] not in (0x3E, 0x40):
                eol = data.find(b"\n", i)
                if eol < 0:
                    eol = n
                chunks.append(data[i:eol].rstrip(b"\r"))
                i = eol + 1
        else:  # FASTQ: sequence lines until '+', then skip the qualities
            while i < n and data[i] != 0x2B:  # '+'
                eol = data.find(b"\n", i)
                if eol < 0:
                    eol = n
                chunks.append(data[i:eol].rstrip(b"\r"))
                i = eol + 1
            seq_len = sum(len(c) for c in chunks)
            eol = data.find(b"\n", i)
            i = n if eol < 0 else eol + 1
            qual = 0
            while i < n and qual < seq_len:
                eol = data.find(b"\n", i)
                if eol < 0:
                    eol = n
                qual += eol - i - (1 if data[eol - 1 : eol] == b"\r" else 0)
                i = eol + 1
        yield name, np.frombuffer(b"".join(chunks), dtype=np.uint8)


@dataclasses.dataclass
class Contigs:
    """One file's records: names, lengths and, unless the memo holds the
    lengths alone, each record's uppercased bytes."""
    names: List[str]
    lengths: np.ndarray                  # (n,) int64
    seqs: Optional[List[np.ndarray]] = None

    def without_bytes(self) -> "Contigs":
        return Contigs(self.names, self.lengths)


class _Memo:
    """One job's parsed files by path, the query paths (whose bytes are
    kept), the bytes held and their limit."""

    def __init__(self, queries: Iterable[str]):
        self.queries = set(queries)
        self.files: Dict[str, Contigs] = {}
        self.held = 0
        self.limit = os.sysconf("SC_PAGE_SIZE") * os.sysconf(
            "SC_PHYS_PAGES") // 2

    def keep(self, path: str, c: Contigs) -> None:
        n = int(c.lengths.sum())
        if (c.seqs is None or path not in self.queries
                or self.held + n > self.limit):
            c = c.without_bytes()
        else:
            self.held += n
        self.files[path] = c


_MEMO: contextvars.ContextVar[Optional[_Memo]] = \
    contextvars.ContextVar("fastani_tpu_torch_fasta_memo", default=None)


@contextlib.contextmanager
def memo(queries: Iterable[str]):
    """Keep each parsed file for the block (a job): the lengths of every
    path, the uppercased bytes of ``queries``.  A memo opened inside
    another starts empty and restores the outer one."""
    token = _MEMO.set(_Memo(queries))
    try:
        yield
    finally:
        _MEMO.reset(token)


def read_contigs(path: str, upper: bool = True) -> Contigs:
    """The file's records parsed (with their uppercased bytes if
    ``upper``), counted nowhere and kept nowhere: a function of the path
    alone, which any thread may run (the memo and the job's recording
    belong to the job's thread)."""
    names, lengths, seqs = [], [], []
    for name, seq in _records(path):
        names.append(name)
        lengths.append(len(seq))
        if upper:
            seqs.append(hashing.upper_np(seq))
    return Contigs(names, np.asarray(lengths, np.int64),
                   seqs if upper else None)


def held(path: str) -> bool:
    """Whether the job's memo holds the bytes of ``path`` (``contigs``
    would answer from it)."""
    m = _MEMO.get()
    got = m.files.get(path) if m is not None else None
    return got is not None and got.seqs is not None


def keep(path: str, c: Contigs) -> Contigs:
    """Count ``c``, a parse of ``path`` (``read_contigs``'s, on any
    thread), as a parse in the open job, and keep it in the memo."""
    _count_parse(path)
    m = _MEMO.get()
    if m is not None:
        m.keep(path, c)
    return c


def contigs(path: str) -> Contigs:
    """The file's records with their uppercased bytes: the memo's, or
    parsed (counted, and kept in a memo: ``keep``)."""
    if held(path):
        spans.count("fasta.memo_hits", by_span=True)
        return _MEMO.get().files[path]
    return keep(path, read_contigs(path))


def contig_lengths(path: str) -> np.ndarray:
    """The file's record lengths, (n,) int64: the memo's, or parsed (a
    query path's bytes kept with them, in a memo)."""
    m = _MEMO.get()
    if m is not None and path in m.files:
        spans.count("fasta.memo_hits", by_span=True)
        return m.files[path].lengths
    return keep(path, read_contigs(
        path, upper=m is not None and path in m.queries)).lengths


def release(path: str) -> None:
    """Drop the memo's bytes of ``path``, keeping its names and lengths."""
    m = _MEMO.get()
    c = m.files.get(path) if m is not None else None
    if c is not None and c.seqs is not None:
        m.held -= int(c.lengths.sum())
        m.files[path] = c.without_bytes()


def genome_length_for_ani(path: str, frag_len: int) -> int:
    """Genome length as counted for the minFraction gate
    (cgi::computeGenomeLengths, computeCoreIdentity.hpp:48-92): contigs
    shorter than frag_len are excluded, the others truncated down to a
    multiple of frag_len."""
    n = contig_lengths(path)
    return int((n[n >= frag_len] // frag_len).sum()) * frag_len
