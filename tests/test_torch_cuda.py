"""Card-only parity tests of the port's CUDA kernels (K1-K5) against their
plain PyTorch versions, and of the whole fast path on the card against the
same run on the CPU.  Each test asks for the ``cuda_device`` fixture, which
skips when no NVIDIA GPU is present; run them on the card (where JAX, which
tests/conftest.py imports, need not be installed) with

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from fastani_tpu_torch.config import Parameters
from fastani_tpu_torch.index import device_build
from fastani_tpu_torch.models import l2walk, pipeline
from fastani_tpu_torch.ops import compact, sort, winnow

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _eq(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x.cpu().to(torch.int64), y.cpu().to(torch.int64))


@pytest.mark.parametrize("seg", [200, 17 * 1024])
def test_winnow_kernel_matches_plain(cuda_device, seg):
    k, w = 16, 24
    rng = np.random.default_rng(seg)
    alpha = np.frombuffer(b"ACGTacgtN", np.uint8)
    contigs = [alpha[rng.integers(0, 9, n)] for n in (40_000, 30, 5000)]
    contigs[0][1000:9000] = ord("N")
    parts = [device_build.segment_rows(c, k, w, seg) for c in contigs]
    cat = lambda xs: torch.from_numpy(np.concatenate(xs)).to(cuda_device)
    rows = cat([p[0] for p in parts])
    base = cat([p[1] for p in parts])
    ctg = cat([np.full(len(p[0]), i, np.int32) for i, p in enumerate(parts)])
    tl = cat([np.full(len(p[0]), len(c), np.int32)
              for p, c in zip(parts, contigs)])
    emit, h, _ = winnow.winnow_rows(rows, ctg, base, tl, k, w)
    _eq([emit, h], winnow.winnow_rows_plain(rows, ctg, base, tl, k, w))


def test_compact_kernel_matches_plain(cuda_device):
    g = torch.Generator(device="cpu").manual_seed(3)
    flags = (torch.rand(7, 3000, generator=g) < 0.2).to(cuda_device)
    a = torch.randint(0, 2 ** 32, (7, 3000), generator=g).to(cuda_device)
    b = torch.randint(0, 100, (7, 3000), generator=g,
                      dtype=torch.int32).to(cuda_device)
    for width in (3000, 256, 4000):
        pays = [(a, 0xFFFFFFFF), (b, -1)]
        _eq(compact.compact_rows(flags, pays, width),
            compact.compact_rows_plain(flags, pays, width))


@pytest.mark.parametrize("n", [1000, 2048, 7680, 32768])
def test_sort_kernels_match_plain(cuda_device, n):
    g = torch.Generator(device="cpu").manual_seed(n)
    x = torch.randint(0, 2 ** 32, (3, n), generator=g).to(cuda_device)
    x[:, ::3] = x[:, :1]                          # ties
    _eq([sort.sort_rows_u32(x)], [sort.sort_rows_u32_plain(x)])
    if n <= sort.MAX_KV:
        p = torch.randint(0, 2 ** 32, (3, n), generator=g).to(cuda_device)
        _eq(sort.sort_rows_u32_kv(x, p), sort.sort_rows_u32_kv_plain(x, p))


@pytest.mark.parametrize("scap", [100, 256, 320, 1000])
def test_walk_kernel_matches_plain(cuda_device, scap):
    g = torch.Generator(device="cpu").manual_seed(scap)
    U, T = 40, 301
    r = lambda lo, hi: torch.randint(lo, hi, (U, T), generator=g,
                                     dtype=torch.int32).to(cuda_device)
    ev = dict(dn=r(-1, 2), dq=r(-1, 2), jr=r(0, scap + 1), jm=r(0, scap),
              scored=r(0, 2), pos=r(0, 10 ** 6))
    s_u = torch.randint(1, scap + 1, (U,), generator=g,
                        dtype=torch.int32).to(cuda_device)
    n_ev = torch.randint(0, T + 1, (U,), generator=g,
                         dtype=torch.int32).to(cuda_device)
    _eq(l2walk.walk(ev, s_u, n_ev, scap),
        l2walk.walk_plain(ev, s_u, n_ev, scap))


def test_run_fast_card_matches_cpu(cuda_device, tmp_path):
    rng = np.random.default_rng(9)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = acgt[rng.integers(0, 4, 200_000)]
    paths = []
    for i in range(3):
        g = base.copy()
        sub = rng.choice(len(g), int(len(g) * (0.01 + 0.02 * i)), replace=False)
        g[sub] = acgt[rng.integers(0, 4, len(sub))]
        p = tmp_path / f"g{i}.fa"
        p.write_bytes(b">g%d\n" % i + g.tobytes() + b"\n")
        paths.append(str(p))
    run = lambda dev: pipeline.run_fast(
        Parameters(query_sequences=paths, ref_sequences=paths), device=dev,
        log=lambda m: None)
    key = lambda e: (e.qry_genome, e.ref_genome)
    want = {key(e): e for e in run("cpu")}
    got = {key(e): e for e in run(cuda_device)}
    assert set(got) == set(want) and len(got) == 9
    for k, e in want.items():
        assert got[k].count_seq == e.count_seq, k
        assert abs(float(got[k].identity) - float(e.identity)) <= 1e-3, k
