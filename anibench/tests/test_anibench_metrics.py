"""The metric arithmetic on a synthetic trace: the union idle, the
breakdown, the L2 stage's and K5's bounds."""

import pytest

from anibench import bounds, trace
from anibench.manifest import Manifest


def test_union_idle_and_gaps_named_by_host_range():
    ms = 1_000_000
    ops = [("walk_kernel", 10 * ms, 30 * ms),
           ("events_kernel", 20 * ms, 40 * ms),      # overlaps the walk
           ("sort_rows_kv_kernel", 60 * ms, 70 * ms),
           ("walk_kernel", 95 * ms, 120 * ms)]       # past the window
    ranges = [("reference_index", 0, 45 * ms),
              ("map_queries_cgi_device", 45 * ms, 100 * ms)]
    s = trace.summarize(ops, ranges, (0, 100 * ms))
    assert s["window_s"] == pytest.approx(0.1)
    assert s["busy_s"] == pytest.approx(0.045)     # 10-40, 60-70, 95-100
    assert s["by_name"]["walk_kernel"] == [pytest.approx(0.025), 2]
    assert s["idle_by_range"] == {"reference_index": pytest.approx(0.01),
                                  "map_queries_cgi_device":
                                  pytest.approx(0.045)}
    assert s["idle_gaps"][0][1] == pytest.approx(0.025)
    assert s["idle_gaps"][0][0].startswith("map_queries_cgi_device")
    man = Manifest()
    work = {"launches": 2, "units": 700, "entries": 500_000,
            "sketch": 160_000}
    ctx = {"trace": s, "jobs": [{"t_index_build": 1.0},
                                {"t_index_build": 2.0}],
           "config": {"frag_len": 3000, "window": 24}, "l2_work": work}
    idle = man.metric_reader("device_idle_pct").read(ctx)
    assert idle == pytest.approx(55.0)
    assert man.metric_reader("index_build_s").read(ctx) == 1.5
    walk = man.metric_reader("walk_roofline_pct").read(ctx)
    assert walk == pytest.approx(100 * bounds.walk_need_s(work) / 0.025)
    l2 = man.metric_reader("l2_roofline_pct").read(ctx)
    assert l2 == pytest.approx(100 * bounds.l2_need_s(work) / 0.055)
    # a traced launch that no chunk loop counted takes the mean work
    work1 = dict(work, launches=1)
    ctx1 = dict(ctx, l2_work=work1)
    assert man.metric_reader("walk_roofline_pct").read(ctx1) == \
        pytest.approx(200 * bounds.walk_need_s(work) / 0.025)
    # nothing counted (the eager path), or no K5 in the trace: no reading
    for c in (dict(ctx, l2_work=None),
              dict(ctx, trace=dict(s, by_name={}))):
        assert man.metric_reader("walk_roofline_pct").read(c) is None
        assert man.metric_reader("l2_roofline_pct").read(c) is None


def test_bounds_of_the_main_path_shapes():
    # one full chunk of the main path at G > 24 (512 units, the entry cap
    # 1016): K5's bound is the kernel table's at full's first chunk
    # (0.007456554 ms for 2033 events a unit; 2032 counted here)
    full = {"units": 512, "entries": 512 * 1016, "sketch": 512 * 240}
    assert bounds.walk_need_s(full) == pytest.approx(7.456554e-6, rel=1e-3)
    # 720 entries and 240 sketch hashes a unit: bytes bound the stage
    w = {"units": 512, "entries": 512 * 720, "sketch": 512 * 240}
    per = 720 * 16 + 240 * 4 + 12
    assert bounds.l2_need_s(w) == pytest.approx(512 * per / 3.35e12)


class _Step:
    """A stand-in for the map step's graphs: its configuration, its
    buffers after a batch's units are located, and its replays."""

    def __init__(self, cfg, bufs):
        self.cfg, self.bufs, self.replayed = cfg, bufs, 0

    def _replay(self, name):
        self.replayed += 1


def test_l2_work_is_counted_from_the_steps_buffers():
    import torch
    from types import SimpleNamespace

    from fastani_tpu_torch.models import jitmap

    cfg = SimpleNamespace(unit_cap=4, unit_chunk=2, l2_entry_cap=10)
    bufs = {"u_valid": torch.tensor([True, True, True, False, False]),
            "b0": torch.tensor([0, 5, 100, 7, 0]),
            "eL": torch.tensor([3, 25, 104, 9, 0]),
            "u_frag": torch.tensor([0, 1, 1, 0, 0], dtype=torch.int32),
            "s": torch.tensor([7, 11])}
    step = _Step(cfg, bufs)
    work = trace.L2Work()
    orig = jitmap.StepGraphs.replay_chunks
    with trace.counting_l2(work):
        jitmap.StepGraphs.replay_chunks(step, 2)
        jitmap.StepGraphs.replay_chunks(step, 2)
    assert jitmap.StepGraphs.replay_chunks is orig
    assert step.replayed == 4
    # live units 0-2: entries 3, 10 (capped from 20), 4; sketch 7, 11, 11
    assert work.result() == {"launches": 4, "units": 6, "entries": 34,
                             "sketch": 58}
    assert trace.L2Work().result() is None
