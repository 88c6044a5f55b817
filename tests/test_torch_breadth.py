"""The port on non-default inputs and parameters against the JAX package
(its CLI on the numpy backend): ``-k 12``, ``--fragLen 2000``, lowercase
bytes and N runs, gzipped FASTA and FASTQ.  The exact path's TSV,
``.matrix`` and ``.visual`` and the fast path's TSV equal the JAX run's,
as sorted lines (tests/test_e2e_breadth.py's fixtures)."""

import os

import numpy as np
import pytest
import torch

from fastani_tpu_torch import cli
from tests import synth

# one intra-op thread: the suite runs several xdist workers per core, and
# torch's thread pool on top of them stalls every small CPU op
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """tests/test_e2e_breadth.py's fixtures (seed 777, 120 kbp)."""
    wd = tmp_path_factory.mktemp("torch_breadth")
    rng = np.random.default_rng(777)
    base = synth.random_genome(rng, 120_000)
    a = synth.mutate_genome(rng, base, 0.02, indel_rate=0.0003)
    b = synth.mutate_genome(rng, base, 0.04, indel_rate=0.0005)
    synth.write_fasta(wd / "base.fa", [("base", base)])
    synth.write_fasta(wd / "a.fa", [("a", a)])
    synth.write_fasta(wd / "b.fa", [("b", b)])
    lo = a.copy()
    third = len(lo) // 3
    seg = lo[third: 2 * third]
    lo[third: 2 * third] = np.where((seg >= 65) & (seg <= 90), seg + 32, seg)
    nn = b.copy()
    for p in rng.integers(0, len(nn) - 40, 60):
        nn[p: p + int(rng.integers(1, 30))] = ord("N")
    synth.write_fasta(wd / "lower.fa", [("lower", lo)])
    synth.write_fasta(wd / "withn.fa", [("withn", nn)])
    synth.write_fasta_gz(wd / "a.fa.gz", [("a", a)])
    synth.write_fastq(wd / "b.fq", [("b_r1", b[:70_000]),
                                    ("b_r2", b[70_000:])])
    synth.write_fastq(wd / "a.fq.gz", [("a_r1", a)], gz=True)
    (wd / "refs_mixed.txt").write_text("a.fa.gz\nb.fq\n")
    return wd


def _sorted(path):
    with open(path) as f:
        return sorted(line.rstrip("\n") for line in f if line.strip())


@pytest.mark.parametrize("args", [
    ["-q", "base.fa", "-r", "a.fa", "-k", "12"],
    ["-q", "base.fa", "-r", "b.fa", "--fragLen", "2000"],
    ["-q", "lower.fa", "-r", "withn.fa"],
    ["-q", "a.fq.gz", "--rl", "refs_mixed.txt"]],
    ids=["k12", "fraglen2000", "lowercase_and_n", "gz_and_fastq"])
def test_port_matches_jax_numpy_cli(workdir, monkeypatch, args):
    from fastani_tpu import cli as jcli

    monkeypatch.chdir(workdir)
    tag = "_".join(a.strip("-").replace(".", "") for a in args[-2:])
    assert jcli.main(args + ["-o", f"{tag}_jax.txt", "--matrix",
                             "--visualize", "--backend", "numpy"]) == 0
    assert cli.main(args + ["-o", f"{tag}_exact.txt", "--exact", "--matrix",
                            "--visualize", "--device", "cpu"]) == 0
    assert cli.main(args + ["-o", f"{tag}_fast.txt", "--device", "cpu"]) == 0
    for suf in ("", ".matrix", ".visual"):
        assert _sorted(f"{tag}_exact.txt{suf}") == \
            _sorted(f"{tag}_jax.txt{suf}"), suf
    assert _sorted(f"{tag}_fast.txt") == _sorted(f"{tag}_jax.txt")
    assert _sorted(f"{tag}_jax.txt") and _sorted(f"{tag}_jax.txt.visual")
    assert os.path.getsize(f"{tag}_jax.txt.matrix") > 0
