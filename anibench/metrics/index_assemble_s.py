"""``index_assemble_s``: seconds a job spends placing the index's entries
and assembling it: the program's ``index.place`` spans (each flush's
entries compacted to their count, under ``index.flush``) and its
``index.assemble`` span (the entries laid into the padded arrays and the
lookup-order sort, ``index.sort``, under it), under ``index_build``
(fastani_tpu_torch/index/device_build.py); the mean over the traced
jobs.  A program without ``index.place`` reads its ``index.assemble``
alone."""

from anibench.metrics._spans import mean_span_seconds

LAYER = "index build"
MOVES = "pairs_per_s"


def read(ctx):
    return mean_span_seconds(ctx, "index.place", "index.assemble")
