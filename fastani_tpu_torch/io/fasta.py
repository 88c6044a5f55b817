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
``fasta.files``, the distinct paths parsed.
"""

from __future__ import annotations

import gzip
import os
from typing import Iterator, List, Tuple

import numpy as np

from fastani_tpu_torch import native
from fastani_tpu_torch.utils import spans


def _open_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        head = f.read(2)
        f.seek(0)
        if head[:2] == b"\x1f\x8b":
            with gzip.open(f) as gz:
                return gz.read()
        return f.read()


def read_sequences(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield (name, sequence bytes as a uint8 array) per record, in order:
    the native parser's records, or with ``FASTANI_TPU_NO_NATIVE`` set the
    Python parser's."""
    trace = os.environ.get("FASTANI_TRACE_READS")
    if trace:
        with open(trace, "a") as f:
            f.write(path + "\n")
    spans.count("fasta.parses", by_span=True)
    spans.distinct("fasta.files", path)
    if os.environ.get("FASTANI_TPU_NO_NATIVE"):
        yield from read_sequences_py(path)
        return
    names, seq, offsets = native.parse(_open_bytes(path))
    for i, name in enumerate(names):
        yield name, seq[offsets[i]:offsets[i + 1]]


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


def genome_length_for_ani(path: str, frag_len: int) -> int:
    """Genome length as counted for the minFraction gate
    (cgi::computeGenomeLengths, computeCoreIdentity.hpp:48-92): contigs
    shorter than frag_len are excluded, the others truncated down to a
    multiple of frag_len."""
    total = 0
    for _, seq in read_sequences(path):
        n = len(seq)
        if n >= frag_len:
            total += (n // frag_len) * frag_len
    return total
