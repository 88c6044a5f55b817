"""One genome as the plain FastANI reads it: its contigs from FASTA, its
reference index (minimizers by contig and position) and its query
fragments' sketches.  NumPy only, so that worker processes that read
genomes load nothing else.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from . import kmers


def read_fasta(path: str) -> List[np.ndarray]:
    """The contigs of a FASTA file, uppercased."""
    seqs, cur, seen = [], [], False
    with open(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                if seen:
                    seqs.append(b"".join(cur))
                cur, seen = [], True
            elif line:
                cur.append(line)
    if seen:
        seqs.append(b"".join(cur))
    return [kmers.upper(np.frombuffer(c, np.uint8)) for c in seqs]


@dataclasses.dataclass
class Genome:
    """One genome's index and fragment sketches (k, w, fragment length l).

    index: ``sid`` (contig), ``wpos``, ``hash`` of every minimizer, by
    contig and position; ``starts[c]`` the first entry of contig c.
    fragments: ``sk_frag`` (query fragment id) and ``sk_hash`` of every
    sketch hash, by fragment and hash; ``sk_size[f]`` = s of fragment f.
    """
    path: str
    n_fragments: int
    ani_length: int
    sid: np.ndarray
    wpos: np.ndarray
    hash: np.ndarray
    starts: np.ndarray
    sk_frag: np.ndarray
    sk_hash: np.ndarray
    sk_size: np.ndarray


def load_genome(path: str, k: int, w: int, l: int) -> Genome:
    contigs = read_fasta(path)
    sid, wpos, hsh = [], [], []
    sk_frag, sk_hash, sizes = [], [], []
    n_frag = 0
    for c, seq in enumerate(contigs):
        L = len(seq)
        if L < k:
            continue
        valid, h = kmers.canonical(seq, k)
        _, eh, ew = kmers.winnow_canonical(valid, h, w)
        sid.append(np.full(len(eh), c, np.int64))
        wpos.append(ew)
        hsh.append(eh)
        if L < w or L < l:
            continue
        fc = L // l
        n = l - k + 1
        cols = np.arange(fc)[:, None] * l + np.arange(n)[None, :]
        r, fh, _ = kmers.winnow_canonical(valid[0][cols], h[0][cols], w)
        key = np.unique((r.astype(np.int64) << 32) | fh.astype(np.int64))
        fr = (key >> 32).astype(np.int64)
        sk_frag.append(fr + n_frag)
        sk_hash.append(key & 0xFFFFFFFF)
        sizes.append(np.bincount(fr, minlength=fc))
        n_frag += fc
    cat = lambda xs, dt: (np.concatenate(xs).astype(dt) if xs
                          else np.zeros(0, dt))
    sid_a = cat(sid, np.int64)
    starts = np.searchsorted(sid_a, np.arange(len(contigs) + 1))
    ani_len = sum((len(s) // l) * l for s in contigs if len(s) >= l)
    return Genome(path, n_frag, ani_len, sid_a, cat(wpos, np.int64),
                  cat(hsh, np.int64), starts, cat(sk_frag, np.int64),
                  cat(sk_hash, np.int64), cat(sizes, np.int64))
