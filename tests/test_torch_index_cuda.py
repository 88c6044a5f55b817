"""Card-only tests of the index build's memory and of its arrays: on a
~500 Mbp clustered panel the allocator's peak over the build stays within
twice the bytes of the arrays the build returns, and on a ~20 Mbp panel
cut into several flushes the card's build equals the port's CPU build of
the same files, array for array.  They skip without an NVIDIA GPU; run
them on the card with

    python -m pytest --noconftest tests/test_torch_index_cuda.py -q -s
"""

import json

import numpy as np
import pytest
import torch

from fastani_tpu_torch.config import Parameters
from fastani_tpu_torch.index import device_build
from fastani_tpu_torch.index.sketch import ReferenceIndex
from fastani_tpu_torch.models import pipeline
from fastani_tpu_torch.utils import spans

pytestmark = pytest.mark.cuda

FIELDS = ("mi_hash", "mi_seqid", "mi_wpos", "occ_hash", "occ_seqid",
          "occ_wpos", "occ_order")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _panel(wd, species: int, strains: int, bp: int, seed: int) -> list:
    """``species`` unrelated random genomes of ``bp`` bases, each with
    ``strains`` strains of 1-5 % point substitutions, one FASTA file a
    strain."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    paths = []
    for c in range(species):
        base = acgt[rng.integers(0, 4, bp)]
        for j in range(strains):
            g = base.copy()
            pos = rng.integers(0, bp, int(bp * (0.01 + 0.04 * j / strains)))
            g[pos] = acgt[rng.integers(0, 4, len(pos))]
            p = wd / f"s{c}_{j}.fa"
            p.write_bytes(b">s%d_%d\n" % (c, j) + g.tobytes() + b"\n")
            paths.append(str(p))
    return paths


def test_build_peak_within_twice_the_index(cuda_device, tmp_path):
    """9 species x 12 strains of 4.64 Mbp (501 Mbp, 16 flushes): the
    allocator's peak over the build, ``index.peak_bytes`` less what was
    allocated before it, at most 2.0 x ``index.bytes``."""
    paths = _panel(tmp_path, 9, 12, 4641652, 11)
    params = Parameters(ref_sequences=paths).finalize()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    stats: dict = {}
    with spans.job(stats):
        index = pipeline.reference_index(params, cuda_device, stats,
                                         lambda m: None)
    c = stats["counters"]
    peak = c["index.peak_bytes"] - before
    print(json.dumps({"bases": sum(m.length for m in index.metadata),
                      "entries": index.n_entries,
                      "out_size": len(index.mi_hash),
                      "index_bytes": c["index.bytes"], "before": before,
                      "peak_bytes": c["index.peak_bytes"],
                      "peak_over_bytes": peak / c["index.bytes"],
                      "build_s": stats["t_index_build"],
                      "device": torch.cuda.get_device_name(0)}))
    assert c["index.bytes"] == 40 * len(index.mi_hash)
    assert peak <= 2.0 * c["index.bytes"]


def test_card_build_equals_cpu_build(cuda_device, tmp_path, monkeypatch):
    """2 species x 2 strains of 5 Mbp in flushes of 256 segment rows
    (~4.5 Mbp): the card's arrays equal the CPU's, padding included."""
    monkeypatch.setattr(device_build, "_FLUSH_ROWS", 256)
    paths = _panel(tmp_path, 2, 2, 5_000_000, 12)
    params = Parameters(ref_sequences=paths).finalize()
    card = ReferenceIndex.build_device(params, device=cuda_device)
    host = ReferenceIndex.build_device(params, device="cpu")
    assert card.n_entries == host.n_entries > 0
    assert not card.overflow and not host.overflow
    for f in FIELDS:
        a, b = getattr(card, f), getattr(host, f)
        assert a.dtype == b.dtype, f
        assert torch.equal(a.cpu(), b), f
