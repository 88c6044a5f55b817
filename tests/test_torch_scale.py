"""The port at the regimes of large panels, against the JAX package on the
CPU: the caps and L2 unit sizes ``run_fast`` sets from the reference
count; a clustered panel (``chip_smoke.build_clustered``, the generator of
scripts/run_scale1000.py) through both ``run_fast``; the map step at the
caps of a panel above 64 genomes (cand_cap 256, hits_cap 24576 past K3's
16384-key kernel, unit_cap the whole candidate grid); and references
whose L1 hit keys overflow 32 bits (``chip_smoke.build_draft_panel``).
The same regimes run on the card in ``chip_smoke.py``'s ``scale`` phase
and ``tests/test_torch_cuda.py``."""

import pathlib
import sys
import types

import numpy as np
import pytest
import torch

from fastani_tpu.config import Parameters as JParams
from fastani_tpu.index.sketch import ReferenceIndex as JIndex
from fastani_tpu.models import jitmap as jjit
from fastani_tpu.models import pipeline as jpipe
from fastani_tpu_torch.config import Parameters
from fastani_tpu_torch.index.sketch import ReferenceIndex
from fastani_tpu_torch.models import jitmap, pipeline
from fastani_tpu_torch.ops import compact, sort

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402  (the generators the card runs use)

# one intra-op thread: the suite runs several xdist workers per core, and
# torch's thread pool on top of them stalls every small CPU op
torch.set_num_threads(1)

# 3 clusters x 3 genomes x 150 kbp
CLUSTERS, PER, GENOME_BP = 3, 3, 150_000


class _Stop(Exception):
    """Raised by a stand-in mapper: the run stops where its caps are set."""


def _mapper_args(run, params, monkeypatch, mod, attr):
    """The (params, unit_factor, unit_chunk) a ``run_fast`` hands its mapper
    class ``mod.attr``, which a recorder replaces: the run stops there."""
    got = {}

    def record(p, index, unit_factor, unit_chunk, **kw):
        got.update(params=p, unit_factor=unit_factor, unit_chunk=unit_chunk)
        raise _Stop

    monkeypatch.setattr(mod, attr, record)
    with pytest.raises(_Stop):
        run(params)
    return got


# the caps at the two panels of chip_smoke.py's scale phase
SCALE_CAPS = {100: dict(hits_cap=24576, cand_cap=256, unit_factor=178,
                        unit_cap=364544),
              1000: dict(hits_cap=32768, cand_cap=256, unit_factor=1708,
                         unit_cap=524288)}


@pytest.mark.parametrize("G", [1, 24, 25, 34, 35, 64, 65, 100, 132, 133,
                               1000])
def test_caps_and_units_match_jax(G, monkeypatch):
    """``scale_caps`` (both packages' ``config.py``) and the mapper's
    unit_factor, unit_chunk and unit_cap as each ``run_fast`` sets them
    for G reference genomes, equal; at G 100 and 1000 the values the
    scale phase runs at."""
    refs = [f"g{i}.fa" for i in range(G)]
    monkeypatch.setattr(jpipe.ReferenceIndex, "build_device",
                        staticmethod(lambda params: object()))
    want = _mapper_args(lambda p: jpipe.run_fast(p, log=lambda m: None),
                        JParams(ref_sequences=refs), monkeypatch, jjit,
                        "JitMapper")
    monkeypatch.setattr(pipeline, "reference_index",
                        lambda params, dev, *a, **kw: types.SimpleNamespace(
                            device=dev))
    got = _mapper_args(
        lambda p: pipeline.run_fast(p, device="cpu", log=lambda m: None),
        Parameters(ref_sequences=refs), monkeypatch, jitmap, "Mapper")
    caps = ("hits_cap", "cand_cap", "l2_entry_cap", "sketch_cap",
            "frag_batch")
    gp, wp = got["params"], want["params"]
    assert {c: getattr(gp, c) for c in caps} == \
        {c: getattr(wp, c) for c in caps}
    assert (got["unit_factor"], got["unit_chunk"]) == \
        (want["unit_factor"], want["unit_chunk"])
    cfg = jitmap.MapperConfig.from_params(gp, 1 << 30, got["unit_factor"],
                                          got["unit_chunk"])
    jcfg = jjit.MapperConfig.from_params(wp, 1 << 30, want["unit_factor"],
                                         want["unit_chunk"])
    assert cfg.unit_cap == jcfg.unit_cap
    if G in SCALE_CAPS:
        assert dict(hits_cap=gp.hits_cap, cand_cap=gp.cand_cap,
                    unit_factor=got["unit_factor"],
                    unit_cap=cfg.unit_cap) == SCALE_CAPS[G]


@pytest.fixture(scope="module")
def clustered(tmp_path_factory):
    wd = tmp_path_factory.mktemp("torch_scale")
    return cs.build_clustered(np, wd, CLUSTERS * PER, GENOME_BP, CLUSTERS)


def _by_pair(rows):
    return {(e.qry_genome, e.ref_genome): e for e in rows}


def _same_results(got, want, n_rows):
    got, want = _by_pair(got), _by_pair(want)
    assert set(got) == set(want) and len(got) == n_rows
    for k, e in want.items():
        g = got[k]
        assert (g.count_seq, g.total_query_fragments) == \
            (e.count_seq, e.total_query_fragments), k
        assert abs(float(g.identity) - float(e.identity)) <= 1e-3, k


def test_clustered_panel_matches_jax_run_fast(clustered):
    """3 clusters x 3 genomes all against all through both ``run_fast``:
    same rows (every same-cluster pair), equal counts, ANI within 1e-3."""
    want = jpipe.run_fast(JParams(query_sequences=clustered,
                                  ref_sequences=clustered, frag_batch=128),
                          log=lambda m: None)
    stats = {}
    got = pipeline.run_fast(Parameters(query_sequences=clustered,
                                       ref_sequences=clustered,
                                       frag_batch=128),
                            device="cpu", log=lambda m: None, stats=stats)
    _same_results(got, want, len(_by_pair(want)))
    pairs = {(e.qry_genome, e.ref_genome) for e in got}
    same_cluster = {(q, r) for q in range(CLUSTERS * PER)
                    for r in range(CLUSTERS * PER) if q // PER == r // PER}
    assert same_cluster <= pairs
    assert stats["fallback_frags"] == 0


def test_wide_caps_map_step_matches_jax(clustered, monkeypatch):
    """The map step at a panel's caps above 64 genomes: cand_cap 256,
    hits_cap 24576 (K3's plain sort on L1 rows past 16384 keys), unit_cap
    the whole candidate grid (F x cand_cap, as unit_factor 1708 gives at
    G 1000): counts, the valid packed rows and the fallback mask
    bit-equal to the JAX ``map_step_packed`` on one index."""
    F = 16
    caps = dict(frag_batch=F, hits_cap=24576, cand_cap=256, sketch_cap=320,
                l2_entry_cap=1016)
    jp = JParams(ref_sequences=clustered, **caps).finalize()
    jidx = JIndex.build_device(jp)
    arrays = {f: np.asarray(getattr(jidx, f)) for f in (
        "mi_hash", "mi_seqid", "mi_wpos", "occ_hash", "occ_seqid",
        "occ_wpos", "occ_order")}
    arrays["n_entries"] = int(jidx.num_entries)
    arrays["sequences_by_file"] = jidx.sequences_by_file
    tp = Parameters(ref_sequences=clustered, **caps).finalize()
    tidx = ReferenceIndex.from_numpy(
        arrays, [(c.name, c.length) for c in jidx.metadata], "cpu")
    frags = np.concatenate([
        pipeline.load_query_fragments(p, tp).frags[:F // 2]
        for p in (clustered[0], clustered[PER + 1])])
    qno = np.repeat(np.arange(2, dtype=np.int32), F // 2)
    qsid = np.arange(F, dtype=np.int32)
    h = jjit.JitMapper(jp, jidx, unit_factor=1708, unit_chunk=512).dispatch(
        frags, qno, qsid)
    want = {key: np.asarray(h["out"][key]) for key in
            ("packed", "counts", "fallback_mask")}

    widths = {"sort": set(), "compact": set()}
    sort_rows, compact_rows = sort.sort_rows_u32, compact.compact_rows

    def sort_rec(x):
        widths["sort"].add(x.shape[1])
        return sort_rows(x)

    def compact_rec(flags, payloads, width=None):
        widths["compact"].add((flags.shape[1], width))
        return compact_rows(flags, payloads, width)

    monkeypatch.setattr(sort, "sort_rows_u32", sort_rec)
    monkeypatch.setattr(compact, "compact_rows", compact_rec)
    mapper = jitmap.Mapper(tp, tidx, unit_factor=1708, unit_chunk=512)
    assert mapper.cfg.unit_cap == F * 256
    got = jitmap.map_step_packed(
        mapper.cfg, torch.from_numpy(frags), mapper.tables,
        torch.from_numpy(qno), torch.from_numpy(qsid),
        torch.ones(F, dtype=bool))
    assert 24576 in widths["sort"]
    assert {(24576, 256), (F * 256, F * 256)} <= widths["compact"]
    counts = got["counts"].numpy()
    np.testing.assert_array_equal(counts, want["counts"].astype(np.int64))
    n = int(counts[0])
    assert n >= F * 2 and not counts[1:5].any()
    np.testing.assert_array_equal(got["packed"].numpy()[:, :n],
                                  want["packed"][:, :n])
    np.testing.assert_array_equal(got["fallback_mask"].numpy(),
                                  want["fallback_mask"])


def test_int64_hit_keys_match_jax_run_fast(tmp_path, monkeypatch):
    """A draft assembly of 2101 contigs beside a strain: seqIds up to 2101
    and 21 position bits overflow the 32-bit hit keys, so L1 sorts int64
    keys with ``torch.sort``; both ``run_fast`` give the same rows, equal
    counts, ANI within 1e-3."""
    refs, query = cs.build_draft_panel(np, tmp_path)
    want = jpipe.run_fast(JParams(query_sequences=[query],
                                  ref_sequences=refs, frag_batch=64),
                          log=lambda m: None)
    mappers = []
    make = jitmap.job_mapper
    monkeypatch.setattr(jitmap, "job_mapper", lambda *a: mappers.append(
        make(*a)) or mappers[-1])
    stats = {}
    got = pipeline.run_fast(Parameters(query_sequences=[query],
                                       ref_sequences=refs, frag_batch=64),
                            device="cpu", log=lambda m: None, stats=stats)
    cfg, t = mappers[0].cfg, mappers[0].tables
    assert cfg.wpos_bits is None and t.occ_keys.dtype == torch.int64
    # the hits' keys: seqIds 2100 and 2101 above bit 32
    assert int(t.occ_keys[: t.n_occ].min()) >= 2100 << 32
    _same_results(got, want, 2)
    assert stats["fallback_frags"] == 0 and stats["max_hits"] > 0
