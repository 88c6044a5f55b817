"""``index_build_s``: seconds a job spends in the device index build of the
reference genomes (index/device_build.py, index/sketch.py); the mean over
the jobs read (``stats["t_index_build"]``, synchronised by the program)."""

from anibench.metrics._common import mean_stat

LAYER = "index build"
MOVES = "pairs_per_s"


def read(ctx):
    return mean_stat(ctx, "t_index_build")
