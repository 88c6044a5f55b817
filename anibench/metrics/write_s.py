"""``write_s``: seconds a job spends in the rows from the matrices, the TSV
and the .matrix (models/ani.py, models/output.py); the mean over the jobs
read (``stats["t_write"]``, synchronised by the program)."""

from anibench.metrics._common import mean_stat

LAYER = "results and writers"
MOVES = "pairs_per_s"


def read(ctx):
    return mean_stat(ctx, "t_write")
