"""``index_parse_s``: seconds a job spends reading the reference FASTA
files for the index build, uppercasing them and cutting them into
segment rows (the program's ``index.parse`` spans, one a file, under
``index_build``; fastani_tpu_torch/index/device_build.py); the mean over
the traced jobs."""

from anibench.metrics._spans import mean_span_seconds

LAYER = "index build"
MOVES = "pairs_per_s"


def read(ctx):
    return mean_span_seconds(ctx, "index.parse")
