"""``map_loop_s``: seconds a job spends in the map/fold loop over every batch
and its one readout (models/jitmap.py, mapping.py, l2walk.py,
device_cgi.py); the mean over the jobs read (``stats["t_map_fold"]``,
synchronised by the program)."""

from anibench.metrics._common import mean_stat

LAYER = "map step and device CGI"
MOVES = "pairs_per_s"


def read(ctx):
    return mean_stat(ctx, "t_map_fold")
