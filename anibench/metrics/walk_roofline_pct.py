"""``walk_roofline_pct``: K5's (``csrc/walk.cu``, ``walk_kernel``) share of
its roofline in the traced job: the least time its live units' events
need (``bounds.walk_need_s`` of ``trace.L2Work``) over its traced device
time.  Launches outside the counted chunk loops (a mapper's one eager
chunk before its capture, an exact redo) are given the counted launches'
mean work.  Nothing is read when the trace holds no K5 launch or no
chunk loop was counted."""

from anibench import bounds
from anibench.metrics._common import kernel_time, work_per_launch

LAYER = "kernels"
MOVES = "pairs_per_s"


def read(ctx):
    n, t = kernel_time(ctx, "walk_kernel")
    work = work_per_launch(ctx, n)
    if work is None or t <= 0:
        return None
    return 100.0 * bounds.walk_need_s(work) / t
