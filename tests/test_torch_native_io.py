"""The port's native FASTA/FASTQ parser (``fastani_tpu_torch.native``)
against its Python parser and the JAX package's reader: equal names and
bytes on tests/test_native_io.py's cases, plain and gzipped, and on a
150 kbp genome; a failed build raises; ``FASTANI_TPU_NO_NATIVE`` selects
the Python parser; ``FASTANI_TRACE_READS`` logs each parsed path."""

import gzip

import numpy as np
import pytest
import torch

from fastani_tpu.io import fasta as jfasta
from fastani_tpu_torch import native
from fastani_tpu_torch.io import fasta
from tests import synth
from tests.test_native_io import CASES

# one intra-op thread: the suite runs several xdist workers per core, and
# torch's thread pool on top of them stalls every small CPU op
torch.set_num_threads(1)


def _assert_same(got, want):
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(CASES) + ["genome_150kbp"])
@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
def test_native_matches_python_and_jax(tmp_path, monkeypatch, name, gz):
    monkeypatch.delenv("FASTANI_TPU_NO_NATIVE", raising=False)
    if name == "genome_150kbp":
        rng = np.random.default_rng(2024)
        g = synth.random_genome(rng, 150_000)
        plain = tmp_path / "g.fa"
        synth.write_fasta(plain, [("ctg1 the first", g[:90_000]),
                                  ("ctg2", g[90_000:])])
        raw = plain.read_bytes()
    else:
        raw = CASES[name]
    p = tmp_path / (name + (".fa.gz" if gz else ".fa"))
    p.write_bytes(gzip.compress(raw) if gz else raw)
    got = list(fasta.read_sequences(str(p)))
    _assert_same(got, list(fasta.read_sequences_py(str(p))))
    _assert_same(got, list(jfasta.read_sequences(str(p))))
    if name == "genome_150kbp":
        assert [len(s) for _, s in got] == [90_000, 60_000]


def test_build_failure_raises(tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text('extern "C" int fai_parse( { return 0; }\n')
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load(bad)
    assert not native.lib_path(bad).exists()


def test_switch_selects_the_python_parser(tmp_path, monkeypatch):
    p = tmp_path / "a.fa"
    p.write_bytes(CASES["plain"])

    def refuse(*_):
        raise AssertionError("the other parser ran")

    monkeypatch.setenv("FASTANI_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(native, "parse", refuse)
    want = list(fasta.read_sequences_py(str(p)))
    _assert_same(list(fasta.read_sequences(str(p))), want)
    monkeypatch.undo()
    monkeypatch.delenv("FASTANI_TPU_NO_NATIVE", raising=False)
    monkeypatch.setattr(fasta, "read_sequences_py", refuse)
    _assert_same(list(fasta.read_sequences(str(p))), want)


def test_trace_hook_logs_each_parse(tmp_path, monkeypatch):
    p = tmp_path / "a.fa"
    p.write_bytes(CASES["fastq"])
    trace = tmp_path / "reads.log"
    monkeypatch.setenv("FASTANI_TRACE_READS", str(trace))
    for _ in range(2):
        list(fasta.read_sequences(str(p)))
    assert fasta.genome_length_for_ani(str(p), 2) == 12
    assert trace.read_text().splitlines() == [str(p)] * 3
