"""Index persistence in the port (``ReferenceIndex.save``/``load``,
``--saveIndex``/``--loadIndex``) against the JAX package's: the same
``.npz`` format both ways, the parameter check, and ``--loadIndex``
without ``-r`` answering as the fresh run does on both paths."""

import os

import numpy as np
import pytest
import torch

from fastani_tpu_torch import cli
from fastani_tpu_torch.config import Parameters
from fastani_tpu_torch.index.sketch import ReferenceIndex
from tests import synth

# one intra-op thread: the suite runs several xdist workers per core, and
# torch's thread pool on top of them stalls every small CPU op
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    """tests/test_index_persist.py's fixtures (seed 7, 2 x 60 kbp)."""
    wd = tmp_path_factory.mktemp("torch_persist")
    rng = np.random.default_rng(7)
    base = synth.random_genome(rng, 60_000)
    synth.write_fasta(wd / "a.fa", [("a", base)])
    synth.write_fasta(wd / "b.fa", [("b", synth.mutate_genome(rng, base,
                                                              0.03))])
    return wd


_ARRAYS = ("mi_hash", "mi_seqid", "mi_wpos", "occ_hash", "occ_seqid",
           "occ_wpos")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_index_file_loads_in_the_other_package(genomes, tmp_path, writer):
    """A file either package saves loads in the other: every array, the
    per-contig entry starts, the file boundaries, the contig names, the
    frequency threshold and the reference list are equal to the writer's
    index (and the port's device build equals the JAX host build)."""
    from fastani_tpu.config import Parameters as JParams
    from fastani_tpu.index.sketch import ReferenceIndex as JIndex

    refs = [str(genomes / "a.fa"), str(genomes / "b.fa")]
    path = str(tmp_path / "ref.npz")
    jax_ix = JIndex.build(JParams(ref_sequences=refs).finalize())
    if writer == "port":
        params = Parameters(ref_sequences=refs).finalize()
        port_ix = ReferenceIndex.build_device(params, device="cpu")
        port_ix.save(path, params)
        loaded = JIndex.load(path, JParams().finalize())
    else:
        jax_ix.save(path)
        params = Parameters()
        port_ix = ReferenceIndex.load(path, params, device="cpu")
        loaded = jax_ix
        assert params.ref_sequences == refs
    host = port_ix.host_view()
    for name in _ARRAYS:
        np.testing.assert_array_equal(getattr(host, name),
                                      getattr(loaded, name), err_msg=name)
        np.testing.assert_array_equal(getattr(jax_ix, name),
                                      getattr(loaded, name), err_msg=name)
    assert loaded.mi_hash.dtype == np.uint32
    np.testing.assert_array_equal(loaded.seq_start, jax_ix.seq_start)
    np.testing.assert_array_equal(port_ix.sequences_by_file,
                                  loaded.sequences_by_file)
    assert [c.name for c in port_ix.metadata] == \
        [c.name for c in loaded.metadata]
    assert port_ix.freq_threshold == loaded.freq_threshold == \
        jax_ix.freq_threshold
    assert list(loaded.params.ref_sequences) == list(params.ref_sequences) \
        == refs


def test_kmer_mismatch_raises(genomes, tmp_path):
    path = str(tmp_path / "ref.npz")
    params = Parameters(ref_sequences=[str(genomes / "a.fa")]).finalize()
    ReferenceIndex.build_device(params, device="cpu").save(path, params)
    with pytest.raises(ValueError, match="kmer_size"):
        ReferenceIndex.load(path, Parameters(kmer_size=14), device="cpu")


def _files(out, suffixes):
    return [open(out + suf, "rb").read() for suf in suffixes]


@pytest.mark.parametrize("path_args,suffixes", [
    ([], ("",)),
    (["--exact", "--visualize", "--matrix"], ("", ".matrix", ".visual"))],
    ids=["fast", "exact"])
def test_cli_load_index_matches_fresh_run(genomes, tmp_path, path_args,
                                          suffixes):
    """--saveIndex on a fresh run, then --loadIndex without -r: the same
    bytes on the fast path (the JAX run_fast with --loadIndex counts its
    reference genomes before the load and writes an empty TSV; the port
    loads first) and in all three files of the exact path."""
    q = ["-q", str(genomes / "a.fa")]
    fresh, loaded = str(tmp_path / "fresh.txt"), str(tmp_path / "loaded.txt")
    idx = str(tmp_path / "ref.npz")
    assert cli.main(q + ["-r", str(genomes / "b.fa"), "-o", fresh,
                         "--saveIndex", idx, "--device", "cpu"]
                    + path_args) == 0
    assert os.path.exists(idx)
    assert cli.main(q + ["--loadIndex", idx, "-o", loaded, "--device",
                         "cpu"] + path_args) == 0
    assert _files(fresh, suffixes) == _files(loaded, suffixes)
    assert open(fresh).read().count("\t") == 4


def test_exact_load_matches_jax_cli_load(genomes, tmp_path):
    """The port's exact path with --loadIndex of a file the port saved
    writes the TSV that the JAX CLI (numpy backend) writes from the same
    file."""
    from fastani_tpu import cli as jcli

    idx = str(tmp_path / "ref.npz")
    params = Parameters(ref_sequences=[str(genomes / "b.fa")]).finalize()
    ReferenceIndex.build_device(params, device="cpu").save(idx, params)
    ours, theirs = str(tmp_path / "ours.txt"), str(tmp_path / "jax.txt")
    q = ["-q", str(genomes / "a.fa"), "--loadIndex", idx]
    assert cli.main(q + ["-o", ours, "--exact", "--device", "cpu"]) == 0
    assert jcli.main(q + ["-o", theirs]) == 0
    assert open(ours).read() == open(theirs).read()
    assert open(ours).read().strip()
