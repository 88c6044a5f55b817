"""Card-only parity tests of the port's CUDA kernels (K1-K5, the L2 event
build's E1 and E2, and the fold, read-only and fused into the finalize)
against their plain PyTorch versions, of
the map step's CUDA graphs against the eager step, and of the fast and
exact paths (single-device and on a 2x2 mesh) and index persistence on
the card against the same runs on the CPU.  Each test asks for the
``cuda_device`` fixture (or ``event_world``, which skips alike), which
skips when no NVIDIA GPU is present; run them on the card (where JAX,
which tests/conftest.py imports, need not be installed) with

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pathlib
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fastani_tpu_torch.config import Parameters
from fastani_tpu_torch.index import device_build
from fastani_tpu_torch.index.sketch import ReferenceIndex
from fastani_tpu_torch.models import glue, jitmap, l2walk, pipeline
from fastani_tpu_torch.ops import compact, sort, winnow
from fastani_tpu_torch.ops.xputils import u32_as_i32

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _eq(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x.cpu().to(torch.int64), y.cpu().to(torch.int64))


def _palindromic(n, ends):
    """ATAT... bytes: every even-length k-mer is its own reverse complement,
    so none is valid; ``ends`` of the given positions with C.  A contig
    ending in such a C has one valid k-mer start, its last (len - k)."""
    seq = np.frombuffer(b"AT" * (n // 2 + 1), np.uint8)[:n].copy()
    seq[list(ends)] = ord("C")
    return seq


@pytest.mark.parametrize("k,w", [(16, 24), (12, 24), (16, 80)])
@pytest.mark.parametrize("seg,tile_max", [(200, 2048), (17 * 1024, 2048),
                                          (17 * 1024, 64), (3000, 1024)])
def test_winnow_kernel_matches_plain(cuda_device, seg, tile_max, k, w):
    """Bit-equal to winnow_rows_plain: lowercase and N bytes, contigs with
    no valid k-mer (all N, all ATAT), rows and tiles whose only event is
    their first position (a contig's one valid k-mer start scored first
    in its row or tile, after earlier events of the contig or none, so the
    carry runs through the chain pass), long rows split into tiles,
    contigs shorter than a row."""
    rng = np.random.default_rng(seg + k + w + tile_max)
    alpha = np.frombuffer(b"ACGTacgtN", np.uint8)
    contigs = [alpha[rng.integers(0, 9, n)] for n in (40_000, 30, 5000)]
    contigs[0][1000:9000] = ord("N")
    contigs += [np.full(3000, ord("N"), np.uint8), _palindromic(3000, [])]
    tile, n_tiles = winnow.tile_geometry(seg, tile_max)
    lone = [seg, 2 * seg + (tile if n_tiles > 1 else 0)]
    lone_first = len(contigs)
    contigs += [_palindromic(lone[0] + k, [seg // 2, lone[0] + k - 1]),
                _palindromic(lone[1] + k, [lone[1] + k - 1])]
    parts = [device_build.segment_rows(c, k, w, seg) for c in contigs]
    cat = lambda xs: torch.from_numpy(np.concatenate(xs)).to(cuda_device)
    rows = cat([p[0] for p in parts])
    base = cat([p[1] for p in parts])
    ctg = cat([np.full(len(p[0]), i, np.int32) for i, p in enumerate(parts)])
    tl = cat([np.full(len(p[0]), len(c), np.int32)
              for p, c in zip(parts, contigs)])
    emit, h = winnow.winnow_rows(rows, ctg, base, tl, k, w, tile_max)
    assert emit.dtype == torch.bool and h.dtype == torch.int32
    _eq([emit, h], winnow.winnow_rows_plain(rows, ctg, base, tl, k, w))
    for j, g in enumerate(lone):
        e = emit[ctg == lone_first + j].reshape(-1).cpu().numpy()
        assert e[g] and (j == 0 or np.nonzero(e)[0].tolist() == [g])


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


def _pays(g, R, n, dtypes, dev):
    fills = {torch.int32: -1, torch.int64: 0xFFFFFFFF}
    return [(torch.randint(-2 ** 31, 2 ** 31 - 1, (R, n), generator=g,
                           dtype=torch.int32).to(dev) if dt == torch.int32
             else torch.randint(0, 2 ** 32, (R, n), generator=g).to(dev),
             fills[dt]) for dt in dtypes]


@pytest.mark.parametrize("width", [30000, 65536, 126976, 262144])
def test_compact_kernel_one_long_row(cuda_device, width):
    """The valid-unit shape: one row of 262144 (split over many blocks),
    its ~65500 flagged positions above, near and below the width; four
    int32 payloads as on the main path."""
    g = torch.Generator(device="cpu").manual_seed(width)
    flags = (torch.rand(1, 262144, generator=g) < 0.25).to(cuda_device)
    pays = _pays(g, 1, 262144, [torch.int32] * 4, cuda_device)
    _eq(compact.compact_rows(flags, pays, width),
        compact.compact_rows_plain(flags, pays, width))


@pytest.mark.parametrize("R,n,width,dtypes", [
    (3, 262144, 126976, (torch.int32, torch.int64)),
    (5, 8192, 128, (torch.int32,) * 3),
    (6, 4097, 5000, (torch.int64, torch.int32, torch.int64, torch.int32)),
    (9, 2985, 2048, (torch.int32,)),
    (40, 1024, 256, (torch.int64, torch.int32)),
    (4, 33, 7, (torch.int64,))])
def test_compact_kernel_tiles_and_payloads(cuda_device, R, n, width, dtypes):
    """Counts that cross tile edges (tiles of 16 flags a thread), rows of
    every and of no position flagged, rows not 16-byte aligned (2985,
    4097, 33), and 1-4 payloads mixing int32 and int64 words."""
    g = torch.Generator(device="cpu").manual_seed(R * n)
    flags = torch.rand(R, n, generator=g) < 0.3
    flags[0] = True
    flags[1] = False
    if n > 4096:
        flags[2] = False
        flags[2, 4000:4200] = True          # a run across the first tile edge
    flags = flags.to(cuda_device)
    pays = _pays(g, R, n, dtypes, cuda_device)
    _eq(compact.compact_rows(flags, pays, width),
        compact.compact_rows_plain(flags, pays, width))


@pytest.mark.parametrize("n", [200, 1000, 2048, 7680, 16384, 32768])
def test_sort_kernels_match_plain(cuda_device, n):
    g = torch.Generator(device="cpu").manual_seed(n)
    x = torch.randint(0, 2 ** 32, (4, n), generator=g).to(cuda_device)
    x[:, ::3] = x[:, :1]                          # ties
    x[1, n // 9:] = 0xFFFFFFFF                    # mostly UMAX pads
    x[2] = 0xFFFFFFFF                             # only pads
    # K3 on int32 words with bit 31 set; int64 words on the card raise
    k = u32_as_i32(x)
    assert bool((k < -1).any())
    got = sort.sort_rows_u32(k)
    assert got.dtype == torch.int32
    _eq([got], [sort.sort_rows_u32_plain(k)])
    _eq([got.to(torch.int64) & 0xFFFFFFFF], [sort.sort_rows_u32_plain(x)])
    with pytest.raises(ValueError):
        sort.sort_rows_u32(x)
    if n <= sort.MAX_KV:
        # K4 on int32 words: keys and payload over all 32 bits, bit 31 set
        p = torch.randint(-2 ** 31, 2 ** 31 - 1, (4, n), generator=g,
                          dtype=torch.int32).to(cuda_device)
        assert bool((p < 0).any())
        got = sort.sort_rows_u32_kv(k, p)
        assert got[0].dtype == got[1].dtype == torch.int32
        _eq(got, sort.sort_rows_u32_kv_plain(k, p))
        with pytest.raises(ValueError):
            sort.sort_rows_u32_kv(x, p)           # int64 words on the card


def test_sort_kernel_on_real_l1_rows_past_16384(cuda_device, tmp_path,
                                                monkeypatch):
    """K3 at the L1 site past 16384 keys (``sort_rows_radix_kernel<32>``)
    on real hit rows that are mostly real keys, as full's are: bench.py's
    generator at 100 genomes x 30 kbp (every genome related, as on full)
    mapped at full's tuned hits_cap 19456 and cand_cap 256; the rows L1
    hands K3, sorted by the kernel, bit-equal to ``torch.sort`` of the
    same u32 values and to the plain version."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import chip_smoke as cs
    from fastani_tpu_torch.ops.xputils import UMAX

    width = 19456
    paths = cs.build_workload(np, tmp_path, 100, 30_000)
    p = Parameters(ref_sequences=paths, frag_batch=256, hits_cap=width,
                   cand_cap=256, sketch_cap=320, l2_entry_cap=1016).finalize()
    mapper = jitmap.Mapper(p, ReferenceIndex.build_device(p, device=cuda_device),
                           unit_factor=178, unit_chunk=512, graphs=False)
    rows, orig = [], sort.sort_rows_u32
    monkeypatch.setattr(sort, "sort_rows_u32", lambda x: (
        rows.append(x.clone()) if x.shape[1] == width else None) or orig(x))
    frags = np.concatenate([pipeline.load_query_fragments(q, p).frags
                            for q in paths])[:256]
    jitmap.map_step_packed(mapper.cfg, torch.as_tensor(frags,
                                                       device=cuda_device),
                           mapper.tables)
    (x,) = rows
    assert x.shape == (256, width) and x.dtype == torch.int32
    # 64 % real keys on this panel (the CPU's map step, the same rows)
    assert float((x != -1).sum(dim=1).float().mean()) > width / 2
    got = orig(x)
    want = torch.sort(x.to(torch.int64) & UMAX, dim=-1).values
    _eq([got.to(torch.int64) & UMAX], [want])
    _eq([got], [sort.sort_rows_u32_plain(x.cpu())])


def _mutate(rng, seq, rate):
    acgt = np.frombuffer(b"ACGT", np.uint8)
    out = seq.copy()
    pos = rng.choice(len(out), int(len(out) * rate), replace=False)
    out[pos] = acgt[rng.integers(0, 4, len(pos))]
    return out


def _write_fasta(path, contigs):
    with open(path, "wb") as f:
        for name, seq in contigs:
            f.write(b">" + name.encode() + b"\n" + seq.tobytes() + b"\n")


@pytest.mark.parametrize("scap,frag_len,ncap",
                         [(100, 1000, None), (256, 3000, None),
                          (320, 3000, 1016), (1000, 10000, 1016)])
def test_walk_kernel_matches_plain(cuda_device, tmp_path, scap, frag_len,
                                   ncap):
    """K5 on event streams made on the card by the port's own index build,
    sketch, L1 and build_events (the kernel's precondition holds only for
    such streams): two diverged references, one with 40 near-identical
    tandem copies of a 700 bp unit, so equal hashes meet in one window."""
    rng = np.random.default_rng(scap)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = acgt[rng.integers(0, 4, 400_000)]
    unit = acgt[rng.integers(0, 4, 700)]
    tandem = np.concatenate([_mutate(rng, unit, 0.01) for _ in range(40)])
    _write_fasta(tmp_path / "r0.fa", [("r0", _mutate(rng, base, 0.01)),
                                      ("rep", tandem)])
    _write_fasta(tmp_path / "r1.fa", [("r1", _mutate(rng, base, 0.03))])
    params = Parameters(ref_sequences=[str(tmp_path / "r0.fa"),
                                       str(tmp_path / "r1.fa")],
                        frag_len=frag_len, sketch_cap=scap,
                        l2_entry_cap=ncap).finalize()
    index = ReferenceIndex.build_device(params, device=cuda_device)
    mapper = jitmap.Mapper(params, index, unit_factor=8)
    q = np.concatenate([_mutate(rng, tandem, 0.01), _mutate(rng, base, 0.02)])
    F = len(q) // frag_len
    frags = torch.as_tensor(q[: F * frag_len].reshape(F, frag_len),
                            device=cuda_device)
    cfg, t = mapper.cfg, mapper.tables
    u = jitmap.locate_units(cfg, frags, t)
    U = min(u["n_live"], 256)
    assert U > 20
    ev, s_u, _, n_ev = l2walk.build_events(
        *jitmap.l2_chunk_args(cfg, t, u, slice(0, U)))
    got = l2walk.walk(ev, s_u, n_ev, scap)
    _eq(got, l2walk.walk_plain(ev, s_u, n_ev, scap))
    _eq(got, l2walk.walk_recurrence(ev, s_u, n_ev, scap))
    assert int((got[0] > 0).sum()) > 10


@pytest.fixture(scope="module")
def event_world(tmp_path_factory):
    """An index on the card of two diverged 400 kbp references (one with
    40 near-identical tandem copies of a 700 bp unit) at mid's caps
    (sketch 320, l2_entry_cap 1016), and the located units of one batch of
    query fragments."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    wd = tmp_path_factory.mktemp("events")
    rng = np.random.default_rng(12)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = acgt[rng.integers(0, 4, 400_000)]
    unit = acgt[rng.integers(0, 4, 700)]
    tandem = np.concatenate([_mutate(rng, unit, 0.01) for _ in range(40)])
    _write_fasta(wd / "r0.fa", [("r0", _mutate(rng, base, 0.01)),
                                ("rep", tandem)])
    _write_fasta(wd / "r1.fa", [("r1", _mutate(rng, base, 0.03))])
    params = Parameters(ref_sequences=[str(wd / "r0.fa"), str(wd / "r1.fa")],
                        sketch_cap=320, l2_entry_cap=1016).finalize()
    mapper = jitmap.Mapper(params, ReferenceIndex.build_device(params,
                                                               device=dev),
                           unit_factor=8)
    q = np.concatenate([_mutate(rng, tandem, 0.01), _mutate(rng, base, 0.02)])
    F = len(q) // 3000
    frags = torch.as_tensor(q[: F * 3000].reshape(F, 3000), device=dev)
    cfg, t = mapper.cfg, mapper.tables
    return cfg, t, jitmap.locate_units(cfg, frags, t)


def _event_case(world, case):
    """build_events' arguments on the card: every valid unit of the batch
    (at most 512, every fifth masked) for "real", else 12 units with units
    1-4 made into the edge case, or 5 units at sketch width 1023 and ncap
    1022 ("wide")."""
    cfg, t, u = world
    n = min(int(u["n_live"]), 512) if case == "real" else 12
    args = list(jitmap.l2_chunk_args(cfg, t, u, slice(0, n)))
    u_sid, u_valid, b0, eL = (args[i].clone() for i in (3, 4, 5, 6))
    M, ncap = t.mi_hash.shape[0], args[15]
    dev = b0.device
    if case == "real":
        u_valid[::5] = False
    elif case == "invalid":
        u_valid[1:5] = False
    elif case == "past_contig":
        last = int((t.mi_sid == 0).nonzero().max())
        b0[1:5] = torch.tensor([10, 100, 250, 400], device=dev).neg() + last
        u_sid[1:5] = 0
        eL[1:5] = b0[1:5] + ncap // 2
    elif case == "clamped":
        b0[1:5] = torch.tensor([M - 1, M - ncap + 3, -7, -1], device=dev)
    elif case == "overflow":
        eL[1:5] = b0[1:5] + ncap + torch.tensor([1, 7, 300, 5000], device=dev)
    elif case == "wide":
        u_sid, u_valid, b0, eL = u_sid[:5], u_valid[:5], b0[:5], eL[:5]
        args[2] = args[2][:5]
        qh = args[0]
        args[0] = torch.cat([qh, torch.full((qh.shape[0], 1023 - qh.shape[1]),
                                            0xFFFFFFFF, dtype=qh.dtype,
                                            device=dev)], dim=1)
        args[15] = 1022
    args[3:7] = [u_sid, u_valid, b0, eL]
    return tuple(args)


@pytest.mark.parametrize("case", ["real", "invalid", "past_contig", "clamped",
                                  "overflow", "wide"])
def test_event_kernels_match_plain(event_world, case):
    """E1 and E2 (csrc/events.cu) bit-equal to events_plain and
    events_scan_plain on the same inputs, on real units and on the edge
    units of tests/test_torch_events.py; build_events on the card runs
    E1 -> K4 -> E2, one launch each and no torch cumsum, cummax or
    searchsorted, and equals build_events on the CPU."""
    from torch.overrides import TorchFunctionMode

    from fastani_tpu_torch.ops import cuda

    args = _event_case(event_world, case)
    frag_len, k, w, ncap = args[12:]
    C = frag_len - (w - 1) - (k - 1)
    e1_in = args[:12] + (C, ncap)
    got = l2walk.events(*e1_in)
    want = l2walk.events_plain(*e1_in)
    assert [x.dtype for x in got] == [x.dtype for x in want]
    _eq(got, want)
    keys, rec = sort.sort_rows_u32_kv(got[0], got[1])
    scan_in = (keys, rec, got[3], got[4], args[4], got[6], C)
    ev, n_ev = l2walk.events_scan(*scan_in)
    ev_p, n_ev_p = l2walk.events_scan_plain(*scan_in)
    _eq([ev[n] for n in l2walk._EVENTS] + [n_ev],
        [ev_p[n] for n in l2walk._EVENTS] + [n_ev_p])

    class Calls(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            self.names.append(getattr(func, "__name__", str(func)))
            return func(*args, **(kwargs or {}))

    cuda.reset_launches()
    with Calls() as calls:
        card = l2walk.build_events(*args)
    torch.cuda.synchronize()
    assert {n: cuda.LAUNCHES[n] for n in ("events", "sort_kv",
                                           "events_scan")} == \
        {"events": 1, "sort_kv": 1, "events_scan": 1}
    assert not {"cumsum", "cummax", "searchsorted"} & set(calls.names)
    host = l2walk.build_events(*[a.cpu() if isinstance(a, torch.Tensor)
                                 else a for a in args])
    _eq([card[0][n] for n in l2walk._EVENTS] + list(card[1:]),
        [host[0][n] for n in l2walk._EVENTS] + list(host[1:]))
    if case == "real":
        assert int((card[0]["scored"].sum(dim=1) > 0).sum()) > 20


@pytest.mark.parametrize("ncap", [1, 2, 128, 1016, 1022])
@pytest.mark.parametrize("U", [1, 3, 512, 4096])
def test_event_kernels_at_edge_shapes(event_world, U, ncap):
    """E1 and E2 bit-equal to their plain versions at U units (the batch's
    live units repeated) and ncap entries a unit (T = 2 ncap + 1, up to
    2045: one to all of E2's 16 warps hold events), E1 at sketch widths
    1, 320 and 1023 (the row cut to its first word, as it is, and padded
    with UMAX); and build_events on the card equal to the CPU."""
    cfg, t, u = event_world
    n = int(u["n_live"])
    args = list(jitmap.l2_chunk_args(cfg, t, u, slice(0, n)))
    pick = torch.arange(U, device=args[2].device) % n
    args[2:7] = [a[pick] for a in args[2:7]]
    args[4][::5] = False
    args[15] = ncap
    frag_len, k, w = args[12:15]
    C = frag_len - (w - 1) - (k - 1)
    qh = args[0]
    widths = {1: qh[:, :1].contiguous(), 320: qh,
              1023: torch.cat([qh, torch.full((qh.shape[0], 1023 - 320),
                                              0xFFFFFFFF, dtype=qh.dtype,
                                              device=qh.device)], dim=1)}
    assert qh.shape[1] == 320
    for scap, q in widths.items():
        e1_in = (q, *args[1:12], C, ncap)
        got = l2walk.events(*e1_in)
        _eq(got, l2walk.events_plain(*e1_in))
        assert got[0].shape == (U, 2 * ncap + 1), scap
        keys, rec = sort.sort_rows_u32_kv(got[0], got[1])
        scan_in = (keys, rec, got[3], got[4], args[4], got[6], C)
        ev, n_ev = l2walk.events_scan(*scan_in)
        ev_p, n_ev_p = l2walk.events_scan_plain(*scan_in)
        _eq([ev[x] for x in l2walk._EVENTS] + [n_ev],
            [ev_p[x] for x in l2walk._EVENTS] + [n_ev_p])
    card = l2walk.build_events(*args)
    host = l2walk.build_events(*[a.cpu() if isinstance(a, torch.Tensor)
                                 else a for a in args])
    _eq([card[0][x] for x in l2walk._EVENTS] + list(card[1:]),
        [host[0][x] for x in l2walk._EVENTS] + list(host[1:]))


def _run_fast_card_and_cpu(tmp_path, **caps):
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
    stats = {"cpu": {}, "cuda": {}}
    run = lambda dev: pipeline.run_fast(
        Parameters(query_sequences=paths, ref_sequences=paths, **caps),
        device=dev, log=lambda m: None, stats=stats[dev.split(":")[0]])
    key = lambda e: (e.qry_genome, e.ref_genome)
    want = {key(e): e for e in run("cpu")}
    got = {key(e): e for e in run("cuda")}
    assert set(got) == set(want) and len(got) == 9
    for k, e in want.items():
        assert got[k].count_seq == e.count_seq, k
        assert abs(float(got[k].identity) - float(e.identity)) <= 1e-3, k
    return stats


def test_run_fast_redo_card_matches_cpu(cuda_device, tmp_path):
    """l2_entry_cap 128: every mapped fragment overflows L2 and each query
    genome is redone on the card, as on the CPU."""
    stats = _run_fast_card_and_cpu(tmp_path, l2_entry_cap=128)
    for st in stats.values():
        assert st["fallback_frags"] > 0 and st["redone_queries"] == 3
    assert stats["cpu"]["fallback_frags"] == stats["cuda"]["fallback_frags"]


def test_run_fast_card_matches_cpu(cuda_device, tmp_path):
    stats = _run_fast_card_and_cpu(tmp_path)
    assert stats["cuda"]["fallback_frags"] == 0


def _golden_fixtures(wd, monkeypatch):
    """tests/test_golden_frozen.py's fixtures (seed 2024), made by
    chip_smoke.py's copy of the generators (a ``tests`` package elsewhere on
    the card machine's path may shadow this one); the working directory
    becomes theirs, so the outputs name the files as the goldens do."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    rng = np.random.default_rng(2024)
    base = cs.genome_bytes(np, rng, 150_000)
    strains = [cs.mutate_genome(np, rng, base, 0.02, 0.0003),
               cs.mutate_genome(np, rng, base, 0.05, 0.0005)]
    multi = [("m_ctg1", cs.mutate_genome(np, rng, base[:80_000], 0.01)),
             ("m_short", cs.genome_bytes(np, rng, 800)),
             ("m_ctg2", cs.mutate_genome(np, rng, base[80_000:], 0.03))]
    cs.write_fasta(wd / "base.fa", [("base_ctg", base)])
    cs.write_fasta(wd / "strainA.fa", [("sA_ctg", strains[0])])
    cs.write_fasta(wd / "strainB.fa", [("sB_ctg", strains[1])])
    cs.write_fasta(wd / "multi.fa", multi)
    monkeypatch.chdir(wd)
    return ["multi.fa", "base.fa"], ["strainA.fa", "strainB.fa"]


def _exact_files(q, r, device, tag, **kw):
    out = f"{tag}_{device}.txt"
    stats = {}
    pipeline.run(Parameters(query_sequences=q, ref_sequences=r,
                            visualize=True, matrix_output=True,
                            out_file_name=out, **kw),
                 device=device, log=lambda m: None, stats=stats)
    return [open(out + suf).read() for suf in ("", ".matrix", ".visual")], \
        stats


@pytest.mark.parametrize("qi,ri,golden", [(1, [0], "one2one.txt"),
                                          (0, [0, 1], "multi.txt")])
def test_exact_card_matches_cpu(cuda_device, tmp_path, monkeypatch, qi, ri,
                                golden):
    """The exact path on the golden fixtures: TSV, .matrix and .visual
    byte-equal on the card and on the CPU, and to the frozen goldens."""
    q, r = _golden_fixtures(tmp_path, monkeypatch)
    q, r = [q[qi]], [r[i] for i in ri]
    got, st = _exact_files(q, r, "cuda", "x")
    want, _ = _exact_files(q, r, "cpu", "x")
    assert got == want and st["fallback_frags"] == 0
    gdir = pathlib.Path(__file__).resolve().parent / "golden"
    for text, suf in zip(got, ("", ".matrix", ".visual")):
        assert sorted(text.splitlines()) == \
            sorted((gdir / (golden + suf)).read_text().splitlines()), suf


def test_exact_oracle_route_card_matches_cpu(cuda_device, tmp_path,
                                             monkeypatch):
    """l2_entry_cap 128 with the kernels' L2 span limit patched down to 730:
    the fragments past it reach the scalar oracle on both devices, and the
    three files are byte-equal."""
    q, r = _golden_fixtures(tmp_path, monkeypatch)
    counter, step, _, holder = glue._CAPS["l2_entry_cap"]
    monkeypatch.setitem(glue._CAPS, "l2_entry_cap",
                        (counter, step, 730, holder))
    got, st = _exact_files(q, r, "cuda", "o", l2_entry_cap=128)
    want, st_cpu = _exact_files(q, r, "cpu", "o", l2_entry_cap=128)
    assert got == want
    assert st["oracle_frags"] == st_cpu["oracle_frags"] > 0


@pytest.mark.parametrize("exact", [False, True], ids=["fast", "exact"])
def test_mesh_card_matches_cpu(cuda_device, tmp_path, monkeypatch, exact):
    """One process runs a 2x2 mesh on the card (multi.fa's 49 fragments in
    batches of 16 split over the q cells, the references over 2 shards)
    and on the CPU: the same rows and counts, ANI within 1e-3, on the fast
    path; the three files byte-equal, and equal to the frozen goldens, on
    the exact path."""
    q, r = _golden_fixtures(tmp_path, monkeypatch)
    q = q[:1]

    def run(device):
        out = f"mesh_{device}.txt"
        p = Parameters(query_sequences=q, ref_sequences=r, frag_batch=16,
                       out_file_name=out, matrix_output=True,
                       visualize=exact)
        fn = pipeline.run if exact else pipeline.run_fast
        rows = fn(p, device=device, log=lambda m: None, n_r=2, n_q=2)
        return rows, [open(out + suf).read() for suf in
                      (("", ".matrix", ".visual") if exact else ("",))]

    got, files = run("cuda")
    want, want_files = run("cpu")
    if exact:
        assert files == want_files
        gdir = pathlib.Path(__file__).resolve().parent / "golden"
        for text, suf in zip(files, ("", ".matrix", ".visual")):
            assert sorted(text.splitlines()) == sorted(
                (gdir / ("multi.txt" + suf)).read_text().splitlines())
    key = lambda e: (e.qry_genome, e.ref_genome)
    got, want = {key(e): e for e in got}, {key(e): e for e in want}
    assert set(got) == set(want) and len(got) == 2
    for k, e in want.items():
        assert got[k].count_seq == e.count_seq, k
        assert abs(float(got[k].identity) - float(e.identity)) <= 1e-3, k


def test_save_load_card(cuda_device, tmp_path, monkeypatch):
    """An index built on the card, saved and loaded back onto the card,
    holds the same entries; --loadIndex without --rl writes the TSV of the
    run that saved it, byte for byte, on the exact path and on the fast
    path (whose device fold sums in a fixed order)."""
    from fastani_tpu_torch import cli

    q, r = _golden_fixtures(tmp_path, monkeypatch)
    p = Parameters(ref_sequences=r).finalize()
    built = ReferenceIndex.build_device(p, device="cuda")
    built.save("ix.npz", p)
    params = Parameters()
    loaded = ReferenceIndex.load("ix.npz", params, device="cuda")
    assert loaded.device.type == "cuda" and params.ref_sequences == r
    a, b = built.host_view(), loaded.host_view()
    for name in ("mi_hash", "mi_seqid", "mi_wpos", "occ_hash", "occ_seqid",
                 "occ_wpos"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    pathlib.Path("refs.txt").write_text("\n".join(r) + "\n")
    for path in (["--exact"], []):
        assert cli.main(["-q", q[0], "--rl", "refs.txt", "-o", "fresh.txt",
                         "--saveIndex", "cli.npz"] + path) == 0
        assert cli.main(["-q", q[0], "--loadIndex", "cli.npz", "-o",
                         "loaded.txt"] + path) == 0
        assert open("fresh.txt").read() == open("loaded.txt").read() != ""


def test_finalize_rows_reproducible_on_card(cuda_device):
    """finalize_rows on a random (64, 40000) table of 7 genomes, ten calls
    on the card: bit-identical sums, and the CPU's bits."""
    from fastani_tpu_torch.models import device_cgi

    rng = np.random.default_rng(23)
    n_rg, n_qg, B_tot = 7, 64, 40_000
    gid_of_bin = np.sort(rng.integers(0, n_rg, B_tot))
    ident = rng.uniform(76.0, 100.0, (n_qg, B_tot)).astype(np.float32)
    tab = np.where(rng.uniform(size=(n_qg, B_tot)) < 0.6,
                   ident.view(np.int32), -1).astype(np.int32)
    fin = torch.arange(n_qg)
    bins = torch.as_tensor(device_cgi.genome_bins(gid_of_bin, n_rg))

    def fold(dev):
        c = torch.zeros((n_qg, n_rg), dtype=torch.int32, device=dev)
        sm = torch.zeros((n_qg, n_rg), dtype=torch.float32, device=dev)
        device_cgi.finalize_rows(torch.tensor(tab, device=dev), c, sm,
                                 fin.to(dev), bins.to(dev), n_qg)
        return c.cpu(), sm.cpu().view(torch.int32)

    runs = [fold(cuda_device) for _ in range(10)]
    want = fold(torch.device("cpu"))
    for c, bits in runs:
        assert torch.equal(c, want[0]) and torch.equal(bits, want[1])


def test_graphs_match_eager_on_goldens(cuda_device, tmp_path, monkeypatch):
    """The golden queries in batches of 32 rows, the tail padded to 32
    with row_valid, through a mapper with CUDA graphs and one without:
    each batch's packed block, counts and fallback mask bit-equal, and the
    rows ``collect`` reads two deep equal; the graphs' mapper warms up and
    captures at its first batch and replays every batch, the padded tail
    included (3 graphs, no batch eager); the kernel launches equal once
    the warm-up's are taken out."""
    from fastani_tpu_torch.ops import cuda

    q, r = _golden_fixtures(tmp_path, monkeypatch)
    params = Parameters(query_sequences=q, ref_sequences=r,
                        frag_batch=32).finalize()
    index = ReferenceIndex.build_device(params, device=cuda_device)
    stream = pipeline.FragmentStream(q, params)
    mappers = [jitmap.Mapper(params, index, unit_factor=8, unit_chunk=24,
                             graphs=g) for g in (True, False)]
    assert [m.graphs for m in mappers] == [True, False]
    starts = range(0, stream.F, 32)
    launches, outs, rows = [], [], []
    for mapper in mappers:
        cuda.reset_launches()
        outs.append([])
        for b0 in starts:
            out = mapper.collect_device(
                mapper.dispatch(*stream.make_batch(b0, 32)))
            outs[-1].append({k: v.clone() for k, v in out.items()})
        torch.cuda.synchronize()
        launches.append(dict(cuda.LAUNCHES))
        jobs = ((mapper, *stream.make_batch(b0, 32)) for b0 in starts)
        rows.append([mapper.collect(h) for _, h in pipeline.two_deep(jobs)])
    assert stream.F > 96 and stream.F % 32
    for a, b in zip(*outs):
        for name in jitmap.OUTPUTS:
            assert torch.equal(a[name], b[name]), name
    for a, b in zip(*rows):
        assert a["counts"] == b["counts"]
        np.testing.assert_array_equal(a["rows"], b["rows"])
        np.testing.assert_array_equal(a["fallback"], b["fallback"])
    assert int(outs[0][1]["counts"][0]) > 20
    st = mappers[0].graph_stats()
    assert st["graphs"] == 3 and st["t_capture"] > 0      # one key
    assert st["eager_batches"] == 0 and st["replays"] == 2 * len(starts)
    warm = st["warmup_launches"]
    assert warm["walk"] == 1 and launches[1]["walk"] > 0
    assert {k: n - warm.get(k, 0) for k, n in launches[0].items()} == \
        launches[1]
    eager = mappers[1].graph_stats()
    assert eager["graphs"] == 0 and eager["eager_batches"] == 2 * len(starts)


@pytest.mark.parametrize("fin", [1, 2, 4])
@pytest.mark.parametrize("bins", [1008, 2000, 4000])
def test_fold_kernel_matches_plain(cuda_device, bins, fin):
    """fold_rows on the card bit-equal to fold_rows_plain (counts and sum
    bits) for 32 reference genomes of unequal bin counts, the longest of
    ``bins``, 60% of the bins occupied; and one launch a call."""
    from fastani_tpu_torch.models import device_cgi
    from fastani_tpu_torch.ops import cuda

    rng = np.random.default_rng(bins + fin)
    n_bins = list(rng.integers(1, bins, 31)) + [bins]
    n_rg, B_tot = len(n_bins), sum(n_bins)
    ident = rng.uniform(76.0, 100.0, (fin, B_tot)).astype(np.float32)
    rows = np.where(rng.uniform(size=(fin, B_tot)) < 0.6,
                    ident.view(np.int32), -1).astype(np.int32)
    bins_of = torch.as_tensor(device_cgi.genome_bins(
        np.repeat(np.arange(n_rg), n_bins), n_rg))
    want = device_cgi.fold_rows_plain(torch.from_numpy(rows), bins_of)
    before = cuda.LAUNCHES["fold"]
    got = device_cgi.fold_rows(torch.as_tensor(rows, device=cuda_device),
                               bins_of.to(cuda_device))
    assert cuda.LAUNCHES["fold"] == before + 1
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu().view(torch.int32),
                       want[1].view(torch.int32))


# genome bin counts: empty, 1, one under, at and over a warp's 32, others
# (B_tot 277, no multiple of 32, so most genomes start unaligned)
EDGE_BINS = [3, 0, 1, 31, 32, 33, 5, 64, 2, 45, 0, 61]
NAN = np.array([0x7FC00000], np.int32).view(np.float32)[0]


def adversarial_rows(rng, n_bins):
    """(3, sum(n_bins)) int32 rows, 40% of the bins empty (-1).  Row 0:
    identities; row 1: magnitudes whose sum depends on the order of the
    adds (1e-30, 3e-8, 1.0, 1e30, 100), +0.0 and subnormals; row 2: the
    same with +inf in one genome and a NaN with the sign clear in
    another.  (tests/test_torch_fold.py uses them on the CPU.)"""
    B_tot = sum(n_bins)
    pool = np.array([1e-30, 3e-8, 1.0, 1e30, 100.0, 0.0, 1e-40, 1e-45,
                     3e-39], np.float32)
    vals = np.stack([rng.uniform(76.0, 100.0, B_tot).astype(np.float32),
                     rng.choice(pool, B_tot), rng.choice(pool, B_tot)])
    rows = vals.view(np.int32).copy()
    rows[rng.uniform(size=rows.shape) < 0.4] = -1
    lo = np.cumsum(n_bins) - n_bins
    big = [g for g, n in enumerate(n_bins) if n >= 31]
    rows[2, lo[big[0]] + 7] = np.float32(np.inf).view(np.int32)
    rows[2, lo[big[1]] + 3] = NAN.view(np.int32)
    # a genome of 1.0 then ten values under half its ulp: each add leaves
    # 1.0, while the ten summed first would move it
    rows[1, lo[big[2]]:lo[big[2]] + n_bins[big[2]]] = -1
    rows[1, lo[big[2]]:lo[big[2]] + 11] = np.array(
        [1.0] + [3e-8] * 10, np.float32).view(np.int32)
    return rows


def _occupied(rng, n, B_tot, share=0.6):
    ident = rng.uniform(76.0, 100.0, (n, B_tot)).astype(np.float32)
    return np.where(rng.uniform(size=(n, B_tot)) < share,
                    ident.view(np.int32), -1).astype(np.int32)


class _CardOps(TorchDispatchMode):
    """The torch ops dispatched while it is on, by name."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


def _finalize_three_ways(dev, tab, acc_c, acc_s, fin, n_bins, n_slots,
                         rows):
    """The table, counts and sums after finalize_rows on the card (one
    fold launch, no torch op: held here), after finalize_rows_plain on
    the card, and after it on the CPU, each on fresh copies."""
    from fastani_tpu_torch.models import device_cgi
    from fastani_tpu_torch.ops import cuda

    ranges = device_cgi.genome_bins(np.repeat(np.arange(len(n_bins)),
                                              n_bins), len(n_bins))
    out = []
    for d, fn in ((dev, device_cgi.finalize_rows),
                  (dev, device_cgi.finalize_rows_plain),
                  (torch.device("cpu"), device_cgi.finalize_rows_plain)):
        t = [torch.tensor(x, device=d) for x in (tab, acc_c, acc_s)]
        args = (*t, torch.tensor(fin, dtype=torch.int64, device=d),
                torch.tensor(ranges, device=d), n_slots)
        kw = {"rows": None if rows is None else torch.tensor(rows, device=d)}
        if fn is device_cgi.finalize_rows:
            before = cuda.LAUNCHES["fold"]
            with _CardOps() as ops:
                fn(*args, **kw)
            assert cuda.LAUNCHES["fold"] == before + 1 and ops.seen == []
        else:
            fn(*args, **kw)
        out.append([x.cpu() for x in t])
    return out


def _same_bits(a, b, nan_as_nan=False, flushed=False):
    """Equal tensors, float32 compared by their bits.  With ``nan_as_nan``
    any NaN matches any NaN (the card's float add returns the canonical
    NaN, the CPU's keeps its operand's payload); with ``flushed`` a +0.0
    in ``b`` matches a positive subnormal in ``a`` (the card's
    ``index_add_``, a float atomic, flushes a subnormal sum to zero)."""
    for x, y in zip(a, b):
        if x.dtype == torch.float32:
            ok = torch.isnan(x) & torch.isnan(y) if nan_as_nan else False
            if flushed:
                ok = ok | ((x > 0) & (x < torch.finfo(torch.float32).tiny)
                           & (y.view(torch.int32) == 0))
            x, y = x.view(torch.int32), y.view(torch.int32)
            assert bool(((x == y) | ok).all())
        else:
            assert torch.equal(x, y)


@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("fin", [1, 2, 4])
@pytest.mark.parametrize("bins", [1008, 2000, 4000])
def test_fused_finalize_matches_plain(cuda_device, bins, fin, given):
    """finalize_rows on a card table, one fold launch and no other op on
    the card: the table after the call, the counts and the sum bits equal
    finalize_rows_plain's on the CPU (and on the card), for 32 reference
    genomes of unequal bin counts, the longest of ``bins``, 60% occupied;
    ``fin`` query genomes in recycled slots (qno past n_slots), the
    accumulators already holding sums, the rows read from the slots or
    given (the mesh's q-merged rows)."""
    rng = np.random.default_rng(10 * bins + 2 * fin + given)
    n_bins = list(rng.integers(1, bins, 31)) + [bins]
    B_tot, n_slots, n_qg = sum(n_bins), fin + 1, 2 * fin + 3
    fin_q = np.arange(fin) + n_slots + 1
    card, card_plain, cpu = _finalize_three_ways(
        cuda_device, _occupied(rng, n_slots, B_tot),
        rng.integers(0, 100, (n_qg, 32)).astype(np.int32),
        rng.uniform(0, 5000, (n_qg, 32)).astype(np.float32), fin_q, n_bins,
        n_slots, _occupied(rng, fin, B_tot) if given else None)
    _same_bits(card, cpu)
    _same_bits(card, card_plain)
    assert bool((card[0][fin_q % n_slots] == -1).all())
    assert int(card[1].sum()) > 100 * fin


@pytest.mark.parametrize("given", [False, True])
def test_fused_finalize_adversarial(cuda_device, given):
    """The fused finalize and fold_rows on the card on adversarial rows
    (order-sensitive magnitudes, +0.0, subnormals, +inf, a NaN) of edge
    genomes (0, 1, 31, 32, 33 bins at unaligned starts): the finalize
    bit-equal to the CPU's plain version but for a NaN's payload, and to
    the card's but for the subnormal sums its ``index_add_`` flushes to
    zero (the kernel adds without flushing, as the CPU does); fold_rows
    bit-equal to fold_rows_plain on the card."""
    from fastani_tpu_torch.models import device_cgi

    rng = np.random.default_rng(77 + given)
    rows = adversarial_rows(rng, EDGE_BINS)
    B_tot = rows.shape[1]
    tab = _occupied(rng, 3, B_tot) if given else rows
    fin_q = np.array([4, 5, 3])                       # slots 1, 2, 0
    card, card_plain, cpu = _finalize_three_ways(
        cuda_device, tab, np.zeros((6, len(EDGE_BINS)), np.int32),
        np.zeros((6, len(EDGE_BINS)), np.float32), fin_q, EDGE_BINS, 3,
        rows[[1, 2, 0]] if given else None)
    _same_bits(card, cpu, nan_as_nan=True)
    _same_bits(card, card_plain, flushed=True)
    assert bool(torch.isnan(card[2]).any() and torch.isinf(card[2]).any())
    assert bool(((card[2] > 0) & (card[2] < 1e-38)).any())
    ranges = torch.as_tensor(device_cgi.genome_bins(
        np.repeat(np.arange(len(EDGE_BINS)), EDGE_BINS), len(EDGE_BINS)))
    got = device_cgi.fold_rows(torch.as_tensor(rows, device=cuda_device),
                               ranges.to(cuda_device))
    _same_bits([x.cpu() for x in got], [x.cpu() for x in
               device_cgi.fold_rows_plain(torch.as_tensor(
                   rows, device=cuda_device), ranges.to(cuda_device))])


def test_capture_with_host_read_raises(cuda_device, tmp_path, monkeypatch):
    """A stage that reads the device from the host cannot be captured: the
    mapper's first batch warms the stages up eagerly (where the read
    runs), then its capture raises instead of running the batch eagerly,
    and no graph is kept."""
    q, r = _golden_fixtures(tmp_path, monkeypatch)
    params = Parameters(query_sequences=q, ref_sequences=r,
                        frag_batch=32).finalize()
    index = ReferenceIndex.build_device(params, device=cuda_device)
    batch = pipeline.FragmentStream(q, params).make_batch(0, 32)
    build = l2walk.build_events
    warmed = []

    def reading(*args, **kw):
        out = build(*args, **kw)
        warmed.append(int(out[3].max()))        # a host read
        return out

    monkeypatch.setattr(l2walk, "build_events", reading)
    mapper = jitmap.Mapper(params, index, unit_factor=8, unit_chunk=24)
    with pytest.raises(RuntimeError):
        mapper.dispatch(*batch)
    torch.cuda.synchronize()
    assert len(warmed) == 1                     # the warm-up's chunk
    st = mapper.graph_stats()
    assert st["graphs"] == 0 and st["replays"] == st["eager_batches"] == 0
    monkeypatch.setattr(l2walk, "build_events", build)
    eager = jitmap.Mapper(params, index, unit_factor=8, unit_chunk=24,
                          graphs=False)
    assert int(eager.collect_device(eager.dispatch(*batch))["counts"][0]) > 20


@pytest.fixture(scope="module")
def wave_panel(tmp_path_factory):
    """12 related 1 Mbp genomes (bench.py's generator) as queries and
    references at run_fast's caps but the benchmark cells' L2 entry cap,
    indexed on the card: two batches of
    2048 fragments, each with several waves of live L2 units; and the
    card's K5 wave (SMs x K5 blocks an SM x 32 units)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import chip_smoke as cs
    from fastani_tpu_torch.config import scale_caps

    dev = torch.device("cuda")
    paths = cs.build_workload(np, tmp_path_factory.mktemp("wave"), 12,
                              1_000_000)
    p = Parameters(query_sequences=paths, ref_sequences=paths).finalize()
    scale_caps(len(paths), p)
    p.l2_entry_cap = 1016    # the cells' T 2033 (scale_caps: past 24 genomes)
    index = ReferenceIndex.build_device(p, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    wave = sms * l2walk.walk_blocks_per_sm(p.sketch_cap) * 32
    return p, index, pipeline.FragmentStream(paths, p), wave


def test_graphs_at_the_wave_match_512_unit_chunks(wave_panel):
    """``jitmap.job_mapper`` on the card takes one full wave of K5 blocks a
    chunk; its graphed map step, batch by batch, bit-equal to the same
    step at 512-unit chunks in every output; K5 launches
    ceil(n_live / width) times a batch (the first batch once more: its
    warm-up's eager chunk)."""
    from fastani_tpu_torch.ops import cuda

    p, index, stream, wave = wave_panel
    wide = jitmap.job_mapper(p, index, len(p.ref_sequences), p.frag_batch)
    sms = torch.cuda.get_device_properties(index.device).multi_processor_count
    assert wave % (32 * sms) == 0 and wave >= 32 * sms
    assert wide.cfg.unit_chunk == min(wave, wide.cfg.unit_cap) == wave
    narrow = wide.with_caps(unit_chunk=512)
    B = p.frag_batch
    starts = range(0, stream.F, B)
    assert len(starts) == 2
    outs, lives = [], []
    for mapper in (wide, narrow):
        outs.append([])
        for i, b0 in enumerate(starts):
            before = cuda.LAUNCHES["walk"]
            out = mapper.collect_device(
                mapper.dispatch(*stream.make_batch(b0, B)))
            torch.cuda.synchronize()
            n_live = int(mapper._step.bufs["n_live"])
            assert cuda.LAUNCHES["walk"] - before == \
                -(-n_live // mapper.cfg.unit_chunk) + (i == 0)
            outs[-1].append({k: v.clone() for k, v in out.items()})
            lives.append(n_live)
        assert mapper.graph_stats()["replays"] == len(starts)
    assert lives[:2] == lives[2:] and min(lives) > 2 * wave
    for a, b in zip(*outs):
        for name in jitmap.OUTPUTS:
            assert torch.equal(a[name], b[name]), name
    assert int(outs[0][0]["counts"][0]) > 1000


def _graph_ms(fn, reps: int = 20) -> float:
    """Milliseconds a call of ``fn``: CUDA events around one replay of a
    graph of ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        for _ in range(reps):
            fn()
    g.replay()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def test_walk_kernel_at_the_wave_and_at_512(wave_panel):
    """K5 on the first wave of a real batch's event streams in one launch
    and in launches of 512 units, both bit-equal to walk_plain; the
    times of each and K5's bound on these streams (24 bytes and 30
    operations an event, 20 bytes a unit, against 3.35 TB/s and 67 T
    operations/s: printed, not asserted)."""
    p, index, stream, wave = wave_panel
    mapper = jitmap.job_mapper(p, index, len(p.ref_sequences), p.frag_batch)
    cfg, t = mapper.cfg, mapper.tables
    u = jitmap.locate_units(cfg, torch.as_tensor(
        stream.make_batch(0, p.frag_batch)[0], device=index.device), t)
    assert int(u["n_live"]) >= wave
    ev, s_u, _, n_ev = l2walk.build_events(
        *jitmap.l2_chunk_args(cfg, t, u, slice(0, wave)))
    scap = p.sketch_cap
    parts = [(a, min(a + 512, wave)) for a in range(0, wave, 512)]

    def narrow():
        return [l2walk.walk({k: v[a:b] for k, v in ev.items()}, s_u[a:b],
                            n_ev[a:b], scap) for a, b in parts]

    got = l2walk.walk(ev, s_u, n_ev, scap)
    _eq(got, [torch.cat(x) for x in zip(*narrow())])
    _eq(got, l2walk.walk_plain(ev, s_u, n_ev, scap))
    assert int((got[0] > 0).sum()) > wave // 2
    t_wave = _graph_ms(lambda: l2walk.walk(ev, s_u, n_ev, scap))
    t_narrow = _graph_ms(narrow)
    events = int(n_ev.sum())
    bound_ms = 1e3 * max((24 * events + 20 * wave) / 3.35e12,
                         30 * events / 67e12)
    print(f"\nK5 on {torch.cuda.get_device_name(0)}: U {wave} x T "
          f"{ev['dn'].shape[1]}, scap {scap}, max n_ev {int(n_ev.max())}, "
          f"{events} events, bound {bound_ms} ms: {t_wave} ms in one "
          f"launch; {len(parts)} launches of <= 512 units: {t_narrow} ms "
          f"({t_narrow / len(parts)} ms a launch)")
