"""The port's index build (K1 + K2 + assembly + stable sort) against the
JAX package's ``ReferenceIndex.build_device`` on the CPU: every array,
padding included, and ``occ_order`` bit-equal."""

import numpy as np
import pytest
import torch

from fastani_tpu.config import Parameters as JParams
from fastani_tpu.index.sketch import ReferenceIndex as JIndex
from fastani_tpu_torch.config import Parameters
from fastani_tpu_torch.index import device_build
from fastani_tpu_torch.index.sketch import ReferenceIndex
from tests import synth

# one intra-op thread: the suite runs several xdist workers per core, and
# torch's thread pool on top of them stalls every small CPU op
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ref_files(tmp_path_factory):
    wd = tmp_path_factory.mktemp("torch_index")
    rng = np.random.default_rng(2024)
    base = synth.random_genome(rng, 150_000)
    a = synth.mutate_genome(rng, base, 0.02, 0.0003)
    lower = synth.mutate_genome(rng, base[:40_000], 0.01).copy()
    lower[::7] += 32                           # lowercase bytes
    lower[5000:5400] = ord("N")
    synth.write_fasta(wd / "a.fa", [("a", a)])
    synth.write_fasta(wd / "m.fa", [("c1", lower), ("short", base[:30]),
                                    ("c2", base[80_000:])])
    return [str(wd / "a.fa"), str(wd / "m.fa")]


def test_build_device_matches_jax(ref_files):
    want = JIndex.build_device(JParams(ref_sequences=ref_files).finalize())
    got = ReferenceIndex.build_device(
        Parameters(ref_sequences=ref_files).finalize(), device="cpu")
    assert got.n_entries == int(want.num_entries)
    assert not got.check_build_overflow()
    for f in ("mi_hash", "mi_seqid", "mi_wpos", "occ_hash", "occ_seqid",
              "occ_wpos", "occ_order"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy(),
            np.asarray(getattr(want, f)).astype(np.int64), err_msg=f)
    np.testing.assert_array_equal(got.genome_of_seq(), want.genome_of_seq())
    assert [(c.name, c.length) for c in got.metadata] == \
        [(c.name, c.length) for c in want.metadata]


def test_piece_overflow_rebuilds_losslessly(ref_files, monkeypatch):
    """A piece over the per-piece cap is detected and the build redone
    with a cap that cannot overflow: the same entries come out."""
    params = Parameters(ref_sequences=ref_files).finalize()
    want = ReferenceIndex.build_device(params, device="cpu")
    monkeypatch.setattr(device_build, "_CAP_R", 40)
    calls = []
    real_build = device_build._build

    def spy(*args):
        idx = real_build(*args)
        calls.append((args[-1], idx.overflow))
        return idx

    monkeypatch.setattr(device_build, "_build", spy)
    got = ReferenceIndex.build_device(params, device="cpu")
    assert calls == [(40, True), (1024, False)]
    n = want.n_entries
    assert got.n_entries == n
    for f in ("mi_hash", "mi_seqid", "mi_wpos", "occ_hash"):
        np.testing.assert_array_equal(getattr(got, f)[:n].numpy(),
                                      getattr(want, f)[:n].numpy())


def test_from_numpy_keeps_arrays():
    rng = np.random.default_rng(3)
    h = np.sort(rng.integers(0, 2 ** 32, 50, dtype=np.uint32))
    arrays = dict(mi_hash=h, mi_seqid=np.zeros(50, np.int32),
                  mi_wpos=np.arange(50, dtype=np.int32), occ_hash=h,
                  occ_seqid=np.zeros(50, np.int32),
                  occ_wpos=np.arange(50, dtype=np.int32),
                  sequences_by_file=np.array([1], np.int32))
    ix = ReferenceIndex.from_numpy(arrays, [("c", 1000)], "cpu")
    assert ix.n_entries == 50 and ix.occ_order is None
    assert ix.mi_hash.dtype == torch.int64
    np.testing.assert_array_equal(ix.mi_hash.numpy(), h.astype(np.int64))
