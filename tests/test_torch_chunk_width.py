"""The L2 chunk's width (``jitmap.chunk_width``): the JAX package's chunk
on the CPU, one full wave of K5 blocks on a card (faked here: an SM count
and K5's blocks an SM), at most the mapper's ``unit_cap``; the map step at
chunks wider than its live units and at widths that do not divide
``unit_cap``, bit-equal to 512-unit chunks and to the JAX package's
``map_step_packed``; and the chunk counters of a job.  The wave on the
card itself is held in ``tests/test_torch_cuda.py``."""

import types

import numpy as np
import pytest
import torch

from fastani_tpu.models import jitmap as jjit
from fastani_tpu_torch.config import Parameters
from fastani_tpu_torch.models import jitmap, l2walk, pipeline
from tests import synth
from tests.test_torch_map import world  # noqa: F401  (the fixture)

# one intra-op thread: the suite runs several xdist workers per core, and
# torch's thread pool on top of them stalls every small CPU op
torch.set_num_threads(1)


@pytest.mark.parametrize("unit_cap", [524288, 364544, 4096, 100])
def test_chunk_width_is_the_jax_chunk_on_the_cpu(unit_cap):
    assert jitmap.chunk_width(torch.device("cpu"), unit_cap, 320, 512) == 512
    assert jitmap.chunk_width(torch.device("cpu"), unit_cap, 320, 64) == 64


@pytest.mark.parametrize("sms,blocks,unit_cap,want", [
    (132, 1, 364544, 4224),      # the H100 at one K5 block an SM
    (132, 2, 364544, 8448),      # two blocks an SM: twice the wave
    (114, 1, 524288, 3648),      # another SM count
    (132, 1, 4096, 4096),        # capped at unit_cap
    (132, 2, 5000, 5000)])
def test_chunk_width_is_one_wave_on_a_card(monkeypatch, sms, blocks,
                                           unit_cap, want):
    """SMs x K5 blocks an SM x 32 units, at most unit_cap; the blocks an
    SM are asked for at the mapper's sketch width."""
    asked = []
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=sms))
    monkeypatch.setattr(l2walk, "walk_blocks_per_sm",
                        lambda scap: asked.append(scap) or blocks)
    got = jitmap.chunk_width(torch.device("cuda"), unit_cap, 320, 512)
    assert got == want and asked == [320]


def test_make_mapper_takes_the_width_of_its_device(world, monkeypatch):
    """``jitmap.job_mapper`` hands the mapper ``chunk_width`` of its
    index's device, at the mapper's own unit_cap and sketch width, its
    units int(1.7 G) + 8 a fragment of its height; a shard's slice height
    sets its unit_cap and CPU chunk."""
    _, _, tp, tidx, _ = world
    calls = []
    width = jitmap.chunk_width

    def spy(dev, unit_cap, sketch_cap, narrow):
        calls.append((dev.type, unit_cap, sketch_cap, narrow))
        return width(dev, unit_cap, sketch_cap, narrow)

    monkeypatch.setattr(jitmap, "chunk_width", spy)
    G = len(tp.ref_sequences)
    mapper = jitmap.job_mapper(tp, tidx, G, tp.frag_batch)
    assert calls == [("cpu", mapper.cfg.unit_cap, tp.sketch_cap,
                      min(512, tp.frag_batch))]
    assert mapper.cfg.unit_cap == jitmap.unit_cap_for(
        tp, int(1.7 * G) + 8) == tp.frag_batch * min(int(1.7 * G) + 8,
                                                      tp.cand_cap)
    assert mapper.cfg.unit_chunk == min(512, tp.frag_batch)
    assert mapper.height == tp.frag_batch
    slice_ = jitmap.job_mapper(tp, tidx, 1, 3)
    assert slice_.height == 3 and slice_.cfg.unit_chunk == 3
    assert slice_.cfg.unit_cap == 3 * min(9, tp.cand_cap) == \
        jitmap.unit_cap_for(tp, 9, 3)


@pytest.fixture(scope="module")
def jax_step(world):
    """The JAX package's ``map_step_packed`` of the world's batch at
    unit_factor 8 (unit_cap 512), and that batch."""
    jp, jidx, _, _, frags = world
    F = len(frags)
    qno = np.full(F, 1, np.int32)
    qsid = np.arange(F, dtype=np.int32) + 7
    h = jjit.JitMapper(jp, jidx, unit_factor=8, unit_chunk=32).dispatch(
        frags, qno, qsid)
    want = {key: np.asarray(h["out"][key]) for key in jitmap.OUTPUTS}
    return want, frags, qno, qsid


@pytest.mark.parametrize("width", [96, 300, 512])
def test_map_step_at_wide_chunks_matches_512_and_jax(world, jax_step,
                                                     width):
    """The map step at chunks of 96 and 300 units (neither divides
    unit_cap 512; 300 is wider than the batch's live units, so one chunk
    holds them all, padded) and at 512: packed, counts and fallback mask
    bit-equal to 512-unit chunks and to the JAX map_step_packed; the
    chunks run are ceil(n_live / width)."""
    _, _, tp, tidx, _ = world
    want, frags, qno, qsid = jax_step
    args = (torch.from_numpy(frags), torch.from_numpy(qno),
            torch.from_numpy(qsid))
    base = jitmap.Mapper(tp, tidx, unit_factor=8, unit_chunk=512)
    mapper = base.with_caps(unit_chunk=width)
    assert mapper.cfg.unit_cap == 512 == jjit.MapperConfig.from_params(
        tp, 1 << 30, 8, 32).unit_cap
    ref = jitmap.map_step_packed(base.cfg, args[0], base.tables, *args[1:])
    chunks = []
    real = jitmap.stage_chunk

    def counted(cfg, t, bufs):
        chunks.append(cfg.unit_chunk)
        return real(cfg, t, bufs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jitmap, "stage_chunk", counted)
        got = jitmap.map_step_packed(mapper.cfg, args[0], mapper.tables,
                                     *args[1:])
    for name in jitmap.OUTPUTS:
        assert torch.equal(got[name], ref[name]), name
    n = int(got["counts"][0])
    assert n > 30
    np.testing.assert_array_equal(got["counts"].numpy(),
                                  want["counts"].astype(np.int64))
    np.testing.assert_array_equal(got["packed"].numpy()[:, :n],
                                  want["packed"][:, :n])
    np.testing.assert_array_equal(got["fallback_mask"].numpy(),
                                  want["fallback_mask"][:len(frags)])
    n_live = int(jitmap.locate_units(mapper.cfg, args[0],
                                     mapper.tables)["n_live"])
    assert 96 < n_live < 300
    assert chunks == [width] * -(-n_live // width)


def test_job_counts_its_chunks_and_their_width(tmp_path):
    """A job's ``l2.chunks`` (the chunks run) times ``l2.chunk_units``
    (their width: the JAX package's chunk on the CPU) times the event row
    width is its ``l2.event_slots``."""
    rng = np.random.default_rng(7)
    base = synth.random_genome(rng, 120_000)
    paths = []
    for i in range(2):
        g = synth.mutate_genome(rng, base, 0.01 + 0.02 * i, 0.0003)
        synth.write_fasta(tmp_path / f"g{i}.fa", [(f"g{i}", g)])
        paths.append(str(tmp_path / f"g{i}.fa"))
    params = Parameters(query_sequences=paths, ref_sequences=paths,
                        out_file_name=str(tmp_path / "o.txt"), frag_batch=32)
    stats = {}
    pipeline.run_fast(params, device="cpu", log=lambda m: None, stats=stats)
    c = stats["counters"]
    assert c["l2.chunk_units"] == min(512, params.frag_batch) == 32
    assert c["l2.chunks"] >= stats["batches"] > 1
    assert c["l2.chunks"] * c["l2.chunk_units"] * (
        2 * params.l2_entry_cap + 1) == c["l2.event_slots"]
