"""The port's index build as it flushes: each flush keeps only its pieces'
entries, so a panel cut into many flushes, and a build that overflows and
rebuilds, give the JAX package's arrays; the L1 hit keys' width at the
size of a 1000-genome panel of 4.64 Mbp genomes; and a clustered panel
through the CLI on the 64-bit key route, against the benchmark's plain
FastANI, with the job's index and key counters."""

import dataclasses
import json
import pathlib
import threading
import types

import numpy as np
import pytest
import torch

from fastani_tpu.config import Parameters as JParams
from fastani_tpu.index.sketch import ReferenceIndex as JIndex
from fastani_tpu_torch.config import Parameters
from fastani_tpu_torch.index import device_build
from fastani_tpu_torch.index.sketch import ContigInfo, ReferenceIndex
from fastani_tpu_torch.models import jitmap
from fastani_tpu_torch.utils import spans
from tests import synth

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIELDS = ("mi_hash", "mi_seqid", "mi_wpos", "occ_hash", "occ_seqid",
          "occ_wpos", "occ_order")


@pytest.fixture(scope="module")
def panel_files(tmp_path_factory):
    """Three genomes of 90 kbp (six 17-kbp segment rows each) and a draft
    of 16 contigs of 2-30 kbp and one too short to winnow: 19 contigs
    that a flush can take one by one, a few together, or all at once."""
    wd = tmp_path_factory.mktemp("torch_index_build")
    rng = np.random.default_rng(77)
    base = synth.random_genome(rng, 90_000)
    paths = []
    for i in range(3):
        g = synth.mutate_genome(rng, base, 0.01 + 0.01 * i, 0.0002)
        paths.append(wd / f"g{i}.fa")
        synth.write_fasta(paths[-1], [(f"g{i}", g)])
    draft = synth.random_genome(rng, 300_000)
    cuts = np.sort(rng.choice(np.arange(2_000, 298_000, 2_000), 15,
                              replace=False))
    contigs = [(f"c{j}", c) for j, c in enumerate(np.split(draft, cuts))]
    paths.append(wd / "draft.fa")
    synth.write_fasta(paths[-1], contigs[:8] + [("tiny", base[:12])]
                      + contigs[8:])
    return [str(p) for p in paths]


@pytest.fixture(scope="module")
def jax_index(panel_files):
    return JIndex.build_device(JParams(ref_sequences=panel_files).finalize())


def _build(files, monkeypatch, flush_rows, cap_r=None):
    monkeypatch.setattr(device_build, "_FLUSH_ROWS", flush_rows)
    if cap_r is not None:
        monkeypatch.setattr(device_build, "_CAP_R", cap_r)
    flushes, caps = [], []
    real_flush_span = device_build.spans.span

    def span(name, **attrs):
        if name == "index.flush":
            flushes.append(name)
        return real_flush_span(name, **attrs)

    real_build = device_build._build

    def build(*args):
        idx = real_build(*args)
        caps.append((args[-1], idx.overflow))
        return idx

    monkeypatch.setattr(device_build.spans, "span", span)
    monkeypatch.setattr(device_build, "_build", build)
    got = ReferenceIndex.build_device(
        Parameters(ref_sequences=files).finalize(), device="cpu")
    return got, len(flushes), caps


@pytest.mark.parametrize("flush_rows", [1, 3, 2048])
def test_many_flushes_match_jax(panel_files, jax_index, monkeypatch,
                                flush_rows):
    got, n_flush, caps = _build(panel_files, monkeypatch, flush_rows)
    assert caps == [(device_build._CAP_R, False)]
    # a contig a flush, a few contigs a flush, or the whole panel in one
    assert n_flush == {1: 19, 2048: 1}.get(flush_rows, n_flush)
    assert 1 < n_flush < 19 or flush_rows != 3
    assert got.n_entries == int(jax_index.num_entries)
    for f in FIELDS:
        np.testing.assert_array_equal(
            getattr(got, f).numpy(),
            np.asarray(getattr(jax_index, f)).astype(np.int64), err_msg=f)
        wide = f in ("mi_hash", "occ_hash", "occ_order")
        assert getattr(got, f).dtype == (torch.int64 if wide
                                         else torch.int32), f


def test_overflow_rebuild_over_many_flushes(panel_files, jax_index,
                                            monkeypatch):
    """Every piece over a cap of 20 entries: the first build flags it and
    the rebuild at the piece length gives the JAX build's entries, each
    flush's compacted entries laid end to end, and pads past them."""
    got, _, caps = _build(panel_files, monkeypatch, 2, cap_r=20)
    assert caps == [(20, True), (device_build._ROW, False)]
    n = int(jax_index.num_entries)
    assert got.n_entries == n
    for f in FIELDS:
        np.testing.assert_array_equal(
            getattr(got, f)[:n].numpy(),
            np.asarray(getattr(jax_index, f))[:n].astype(np.int64),
            err_msg=f)
    pads = {"mi_hash": 2**32 - 1, "occ_hash": 2**32 - 1}
    for f in FIELDS[:-1]:
        tail = getattr(got, f)[n:]
        assert len(tail) >= device_build._MARGIN
        assert bool((tail == pads.get(f, 1 << 30)).all()), f
    assert torch.equal(got.occ_order[n:],
                       torch.arange(n, len(got.occ_order)))


@pytest.fixture(scope="module")
def many_files(tmp_path_factory):
    """40 reference files of unequal sizes for the parse's worker pool,
    the first the largest (75 kbp): strains of 2-30 kbp, a draft of 9
    contigs, a file whose contigs are all shorter than k, and an empty
    file."""
    wd = tmp_path_factory.mktemp("torch_index_many")
    rng = np.random.default_rng(2026)
    base = synth.random_genome(rng, 75_000)
    files = [(base,)]
    for n in rng.integers(2_000, 30_000, 36):
        files.append((synth.mutate_genome(rng, base[:n], 0.02, 0.0002),))
    draft = synth.random_genome(rng, 40_000)
    files.insert(7, tuple(np.split(draft, np.sort(
        rng.choice(np.arange(500, 39_500, 500), 8, replace=False)))))
    files.insert(20, tuple(synth.random_genome(rng, n) for n in (3, 15, 9)))
    files.insert(31, ())
    paths = []
    for i, contigs in enumerate(files):
        paths.append(str(wd / f"f{i:02d}.fa"))
        synth.write_fasta(paths[-1], [(f"f{i}_{j}", c)
                                      for j, c in enumerate(contigs)])
    assert len(paths) == 40
    return paths


@pytest.fixture(scope="module")
def many_jax(many_files):
    return JIndex.build_device(JParams(ref_sequences=many_files).finalize())


def _cores(monkeypatch, n):
    monkeypatch.setattr(device_build.os, "sched_getaffinity",
                        lambda pid: set(range(n)))


def _assert_same_index(got, want, n_files):
    assert got.n_entries == int(want.num_entries)
    assert got.metadata == [ContigInfo(c.name, c.length)
                            for c in want.metadata]
    np.testing.assert_array_equal(got.sequences_by_file,
                                  want.sequences_by_file)
    assert len(got.sequences_by_file) == n_files
    for f in FIELDS:
        np.testing.assert_array_equal(
            getattr(got, f).numpy(),
            np.asarray(getattr(want, f)).astype(np.int64), err_msg=f)


@pytest.mark.parametrize("order", ["flush3", "whole", "first_last",
                                   "one_core", "one_file"])
def test_pooled_parse_of_many_files_matches_jax(many_files, many_jax,
                                                monkeypatch, order):
    """The parse on four workers gives the JAX build's arrays, metadata and
    file boundaries over 40 files, a few contigs a flush or all in one;
    with the first (largest) file's parse held until the other files
    sent with it have finished, the file order still numbers the seqIds.
    One usable core, or one file, gives a pool of one worker."""
    _cores(monkeypatch, 1 if order == "one_core" else 5)
    files, want = many_files, many_jax
    if order == "one_file":
        files = many_files[:1]
        want = JIndex.build_device(JParams(ref_sequences=files).finalize())
    done = []
    if order == "first_last":
        real = device_build._parse_file
        others = threading.Event()

        def parse_file(path, k, w):
            if path == many_files[0]:
                assert others.wait(60)
            out = real(path, k, w)
            done.append(path)
            if len(done) == 8:      # the lookahead past file 0: 2 a worker
                others.set()
            return out

        monkeypatch.setattr(device_build, "_parse_file", parse_file)
    stats = {}
    with spans.job(stats):
        got, n_flush, _ = _build(files, monkeypatch,
                                 3 if order == "flush3" else 2048)
    c = stats["counters"]
    n = len(files)
    assert c["index.parse_threads"] == (4 if n > 1 and order != "one_core"
                                        else 1)
    assert c["fasta.parses[index.parse]"] == c["fasta.files"] == n
    assert 0 <= c["index.parse_ready"] <= n
    assert c["index.parse_work_ns"] > 0
    if order == "first_last":
        # finished ninth: the loop waited for it with eight files sent
        # past it, and sent no more
        assert done.index(many_files[0]) == 8
        assert sorted(done) == many_files
    assert n_flush > 1 if order == "flush3" else n_flush == 1
    _assert_same_index(got, want, n)


def test_pooled_overflow_rebuild_matches_jax(many_files, many_jax,
                                             monkeypatch):
    """An overflow with the pool engaged: the first build flags it, the
    rebuild (a second pool) gives the JAX build's entries."""
    _cores(monkeypatch, 5)
    stats = {}
    with spans.job(stats):
        got, _, caps = _build(many_files, monkeypatch, 2, cap_r=20)
    assert caps == [(20, True), (device_build._ROW, False)]
    c = stats["counters"]
    assert c["index.parse_threads"] == 4
    assert c["fasta.parses[index.parse]"] == 80     # no memo: both builds
    n = int(many_jax.num_entries)
    assert got.n_entries == n
    for f in FIELDS:
        np.testing.assert_array_equal(
            getattr(got, f)[:n].numpy(),
            np.asarray(getattr(many_jax, f))[:n].astype(np.int64),
            err_msg=f)


@pytest.mark.parametrize("cores", [5, 1], ids=["pooled", "one_worker"])
def test_missing_reference_file_raises_and_leaves_no_worker(
        many_files, tmp_path, monkeypatch, cores):
    """A missing file raises FileNotFoundError, as the reader's open does,
    on the build's thread; the pool is shut down before it propagates."""
    _cores(monkeypatch, cores)
    files = many_files[:5] + [str(tmp_path / "missing.fa")] + many_files[5:9]
    with pytest.raises(FileNotFoundError):
        ReferenceIndex.build_device(
            Parameters(ref_sequences=files).finalize(), device="cpu")
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith("index.parse")]


def test_empty_panel_is_all_pads(tmp_path):
    p = tmp_path / "short.fa"
    synth.write_fasta(p, [("s", np.frombuffer(b"ACGT", np.uint8))])
    got = ReferenceIndex.build_device(
        Parameters(ref_sequences=[str(p)]).finalize(), device="cpu")
    want = JIndex.build_device(JParams(ref_sequences=[str(p)]).finalize())
    assert got.n_entries == 0 == int(want.num_entries)
    for f in FIELDS:
        np.testing.assert_array_equal(
            getattr(got, f).numpy(),
            np.asarray(getattr(want, f)).astype(np.int64), err_msg=f)


@pytest.mark.parametrize("genomes,bits", [(1000, None), (512, None),
                                          (511, 23), (100, 23)])
def test_key_width_at_real_genome_size(genomes, bits):
    """seqId << 23 | wpos (4641652 + 2 x 3000 takes 23 bits) fits 32 bits
    up to 511 genomes; from 512 on the L1 keys are 64-bit."""
    index = types.SimpleNamespace(
        metadata=[ContigInfo(f"g{i}", 4641652) for i in range(genomes)])
    cfg = jitmap.MapperConfig.from_params(Parameters().finalize(),
                                          2**31 - 1, index=index)
    assert cfg.wpos_bits == bits


def _tiny_cell(tmp_path):
    """The benchmark's clustered configuration at its CPU test size (6
    genomes of 45 kbp in 2 species), its all-vs-all traffic and panel."""
    from anibench import panels

    cfg = json.loads((ROOT / "anibench/configs/clusters100_4m6.json")
                     .read_text())
    cfg.update(name="tiny", genomes=6, genome_bp=45000, clusters=2)
    traffic = json.loads((ROOT / "anibench/traffic/all_vs_all.json")
                         .read_text())
    panel = panels.make_panel(cfg, traffic, 2**31 + 19, tmp_path / "panel")
    return cfg, traffic, panel


def _wide_keys(monkeypatch):
    """No panel small enough for the CPU crosses 32 bits: the width
    decision is patched to 64-bit keys (``wpos_bits`` None)."""
    real = jitmap.MapperConfig.from_params

    def wide(*args, **kw):
        return dataclasses.replace(real(*args, **kw), wpos_bits=None)

    monkeypatch.setattr(jitmap.MapperConfig, "from_params", wide)


def test_cli_on_64_bit_keys_matches_reference(tmp_path, monkeypatch):
    from anibench import check, harness, panels

    cfg, traffic, panel = _tiny_cell(tmp_path)
    with monkeypatch.context() as mp:
        _wide_keys(mp)
        wide_out = str(tmp_path / "wide.tsv")
        st_wide, _, rc = harness.run_job(panel.job_argv(wide_out), "cpu")
    assert rc == 0
    narrow_out = str(tmp_path / "narrow.tsv")
    st_narrow, _, rc = harness.run_job(panel.job_argv(narrow_out), "cpu")
    assert rc == 0

    pairs = panels.check_sample(panel, traffic, 2**31 + 19)
    assert len(pairs) == 36                 # every ordered pair
    ref = check.reference_answers(pairs, cfg, torch.device("cpu"))["float32"]
    got = check.compare(ref, [wide_out], pairs, panel.queries)
    assert got["pairs_wrong"] == 0
    assert got["ani_gap"] <= check.LIMITS["ani_gap"]
    assert got["matrix_gap"] <= check.LIMITS["matrix_gap"]
    # both key routes give the same files
    for ext in ("", ".matrix"):
        assert pathlib.Path(wide_out + ext).read_bytes() == \
            pathlib.Path(narrow_out + ext).read_bytes()

    # the job's counters: the index's bytes, the allocator's peak (0 off a
    # card) and the L1 keys' width
    for st, bits in ((st_wide, 64), (st_narrow, 32)):
        c = st["counters"]
        assert c["l1.key_bits"] == bits
        assert c["index.peak_bytes"] == 0
        assert c["index.bytes"] > 0 and c["index.bytes"] % 40 == 0
    names = [s["name"] for s in st_wide["spans"]]
    assert names.count("index.place") == names.count("index.flush") >= 1
    assert names.count("index.sort") == names.count("index.assemble") == 1
