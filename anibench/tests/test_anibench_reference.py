"""The plain reference: its hash against a scalar MurmurHash3, its
winnowing against a literal model of FastANI's deque, its statistics
against the scalar search, its fold in float32, and its answers against
the port's CPU run on a tiny panel."""

from collections import deque

import numpy as np
import pytest
import torch

from anibench.reference import fastani, kmers, mashstats

M64 = (1 << 64) - 1


def murmur_scalar(key: bytes, seed: int = 42) -> int:
    """MurmurHash3_x64_128's h1, low 32 bits, for keys of at most 16
    bytes (Austin Appleby's public-domain algorithm, one block)."""
    c1, c2 = 0x87C37B91114253D5, 0x4CF5AD432745937F
    rotl = lambda x, r: ((x << r) | (x >> (64 - r))) & M64

    def fmix(k):
        k ^= k >> 33
        k = (k * 0xFF51AFD7ED558CCD) & M64
        k ^= k >> 33
        k = (k * 0xC4CEB9FE1A85EC53) & M64
        return k ^ (k >> 33)

    h1 = h2 = seed
    n = len(key)
    if n == 16:
        k1 = int.from_bytes(key[:8], "little")
        k2 = int.from_bytes(key[8:], "little")
        h1 ^= rotl((k1 * c1) & M64, 31) * c2 & M64
        h1 = (rotl(h1, 27) + h2) & M64
        h1 = (h1 * 5 + 0x52DCE729) & M64
        h2 ^= rotl((k2 * c2) & M64, 33) * c1 & M64
        h2 = (rotl(h2, 31) + h1) & M64
        h2 = (h2 * 5 + 0x38495AB5) & M64
    else:
        if n > 8:
            k2 = int.from_bytes(key[8:], "little")
            h2 ^= rotl((k2 * c2) & M64, 33) * c1 & M64
        k1 = int.from_bytes(key[:8], "little")
        h1 ^= rotl((k1 * c1) & M64, 31) * c2 & M64
    h1 ^= n
    h2 ^= n
    h1 = (h1 + h2) & M64
    h2 = (h2 + h1) & M64
    h1, h2 = fmix(h1), fmix(h2)
    return (h1 + h2) & 0xFFFFFFFF


def winnow_model(seq, k, w):
    """FastANI's deque winnowing (commonFunc.hpp:92-167), one k-mer at a
    time."""
    L = len(seq)
    hf = [murmur_scalar(bytes(seq[i:i + k])) for i in range(L - k + 1)]
    rc = kmers.revcomp(seq)
    hb = [murmur_scalar(bytes(rc[i:i + k])) for i in range(L - k + 1)]
    q, last, out = deque(), None, []
    for i in range(L - k + 1):
        f, b = hf[i], hb[L - i - k]
        if f == b:
            continue
        cur = min(f, b)
        while q and q[0][1] <= i - w:
            q.popleft()
        while q and q[-1][0] >= cur:
            q.pop()
        q.append([cur, i, -1])
        if i - w + 1 >= 0:
            fr = q[0]
            if last is None or (fr[0], fr[2]) != last:
                fr[2] = i - w + 1
                out.append((fr[0], i - w + 1))
                last = (fr[0], i - w + 1)
    return out


@pytest.mark.parametrize("k,w,alphabet", [(16, 24, b"ACGT"), (16, 5, b"AT"),
                                          (12, 24, b"ACGT"), (7, 3, b"AC"),
                                          (9, 1, b"ACGT")])
def test_hash_and_winnow_match_the_scalar_model(k, w, alphabet):
    rng = np.random.default_rng(k * 100 + w)
    seq = np.frombuffer(alphabet, np.uint8)[rng.integers(0, len(alphabet),
                                                         700)]
    got = kmers.kmer_hashes(seq, k)
    assert [murmur_scalar(bytes(seq[i:i + k])) for i in range(len(got))] \
        == got.tolist()
    _, h, wp = kmers.winnow(seq, k, w)
    assert list(zip(h.tolist(), wp.tolist())) == winnow_model(seq, k, w)


def test_tables_match_the_scalar_search():
    for s in (1, 3, 40, 211):
        ident, upper, hits = mashstats.sketch_tables(s, 16, 80.0)
        for c in range(0, s + 1, max(1, s // 17)):
            mash = mashstats.j2md(np.float32(c / s), 16)
            low = mashstats.md_lower_bound(mash, s, 16, 0.9)
            assert upper[c] == np.float32(np.float32(100)
                                          * np.float32(1 - low))
        assert 1 <= hits <= mashstats.estimate_minimum_hits(s, 16, 80.0)


def test_fold_is_sequential_float32_and_bf16_control_differs():
    rng = np.random.default_rng(3)
    n = 900
    ident = (95 + 5 * rng.random(n)).astype(np.float32)
    frag = np.arange(n)
    start = np.arange(n) * 3000
    cnt, ani = fastani.fold(frag, np.zeros(n, np.int64), start, ident, 3000)
    acc = np.float32(0)
    for v in ident:
        acc = np.float32(acc + v)
    assert cnt == n and ani == np.float32(acc / np.float32(n))
    _, ctl = fastani.fold(frag, np.zeros(n, np.int64), start, ident, 3000,
                          "bfloat16")
    assert abs(float(ctl) - float(ani)) > 0.01
    assert fastani.to_bf16(np.float32(1.00390625)) == np.float32(1.0)


def test_reference_agrees_with_the_port_on_a_tiny_panel(tmp_path):
    from anibench import check, panels
    from fastani_tpu_torch import cli

    cfg = {"genomes": 4, "genome_bp": 30000, "clusters": 2,
           "sub_rate": [0.01, 0.05], "indel_rate": 0.0002, "kmer": 16,
           "window": 24, "frag_len": 3000, "min_fraction": 0.2}
    p = panels.make_panel(cfg, {"queries": "panel"}, 11, tmp_path)
    out = str(tmp_path / "o.tsv")
    assert cli.main(p.job_argv(out) + ["--device", "cpu"]) == 0
    pairs = [(q, r) for q in p.refs for r in p.refs]
    ref = check.reference_answers(pairs, cfg, torch.device("cpu"))["float32"]
    got = check.compare(ref, [out], pairs, p.queries)
    assert got["pairs_wrong"] == 0
    assert got["ani_gap"] < 1e-4 and got["matrix_gap"] < 1e-5
    assert sum(r.reported for r in ref.values()) == 8


def test_genomes_read_in_worker_processes_equal_serial_reads(tmp_path):
    from anibench import harness, panels

    cfg = {"genomes": 3, "genome_bp": 20000, "clusters": 1,
           "sub_rate": [0.01, 0.05], "indel_rate": 0.0002}
    p = panels.make_panel(cfg, {"queries": "panel"}, 3, tmp_path)
    one = fastani.load_genomes(p.refs, 16, 24, 3000, 1)
    two = fastani.load_genomes(p.refs, 16, 24, 3000, 2)
    # the worker processes and multiprocessing's resource tracker are gone
    assert harness.children() == []
    assert list(one) == list(two) == sorted(p.refs)
    for path in p.refs:
        for f in ("sid", "wpos", "hash", "sk_frag", "sk_hash", "sk_size"):
            assert np.array_equal(getattr(one[path], f),
                                  getattr(two[path], f))
