"""``l2_fill_pct``: the share of the L2 walk's (K5's) launched event slots
that the live units' windows need: 100 x 2 x ``l2.window_entries`` (each
live unit's entry window, ``eL - b0`` at most the entry cap, two events
an entry) over ``l2.event_slots`` (each chunk launch's units times its
event row width, 2 x the entry cap + 1).  Program counters
(fastani_tpu_torch/models/jitmap.py live_chunks), summed over the traced
jobs; the window entries are counted only while a profiler runs."""

from anibench.metrics._spans import counter_sums

LAYER = "kernels"
MOVES = "pairs_per_s"


def read(ctx):
    sums = counter_sums(ctx, "l2.window_entries", "l2.event_slots")
    if sums is None or not sums[1]:
        return None
    return 100.0 * 2 * sums[0] / sums[1]
