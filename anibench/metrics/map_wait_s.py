"""``map_wait_s``: seconds a job's map loop holds the host blocked on the
card: each batch's read of its live L2 units (``batch.n_live_read``),
the waits for a pinned input buffer's last copy (``batch.upload_wait``)
and the loop's final read of its counters and matrices
(``map_finish.read``); fastani_tpu_torch/models/jitmap.py, pipeline.py.
The mean over the traced jobs."""

from anibench.metrics._spans import mean_span_seconds

LAYER = "map step and device CGI"
MOVES = "pairs_per_s"
WAITS = ("batch.n_live_read", "batch.upload_wait", "map_finish.read")


def read(ctx):
    return mean_span_seconds(ctx, *WAITS)
