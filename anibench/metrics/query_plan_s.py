"""``query_plan_s``: seconds a job spends parsing every query genome for
the batch plan (the program's ``query_plan`` span, under
``mapper_init``; fastani_tpu_torch/models/pipeline.py FragmentStream);
the mean over the traced jobs."""

from anibench.metrics._spans import mean_span_seconds

LAYER = "query reading and mapper init"
MOVES = "pairs_per_s"


def read(ctx):
    return mean_span_seconds(ctx, "query_plan")
