"""``l2_roofline_pct``: the L2 stage's share of its roofline in the traced
job: the least time its live units need (``bounds.l2_need_s`` of
``trace.L2Work``: entries and sketch rows read once, results written
once) over the summed device time of the stage's kernels, E1
(``events_kernel``), K4 (``sort_rows_kv_kernel``), E2
(``events_scan_kernel``) and K5 (``walk_kernel``).  K5's launches outside
the counted chunk loops are given the counted launches' mean work.
Nothing is read when the trace holds no K5 launch or no chunk loop was
counted."""

from anibench import bounds
from anibench.metrics._common import kernel_time, work_per_launch

LAYER = "kernels"
MOVES = "pairs_per_s"
STAGE = ("events_kernel", "events_scan_kernel", "sort_rows_kv_kernel",
         "walk_kernel")


def read(ctx):
    chunks, _ = kernel_time(ctx, "walk_kernel")
    _, t = kernel_time(ctx, *STAGE)
    work = work_per_launch(ctx, chunks)
    if work is None or t <= 0:
        return None
    return 100.0 * bounds.l2_need_s(work) / t
