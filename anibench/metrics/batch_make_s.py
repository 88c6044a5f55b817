"""``batch_make_s``: seconds a job's map loop spends making its batches
on the host, the query genomes' loads under them included (the
program's ``batch.make`` spans, with their ``query.load`` children;
fastani_tpu_torch/models/pipeline.py FragmentStream.make_batch); the
mean over the traced jobs."""

from anibench.metrics._spans import mean_span_seconds

LAYER = "map step and device CGI"
MOVES = "pairs_per_s"


def read(ctx):
    return mean_span_seconds(ctx, "batch.make")
