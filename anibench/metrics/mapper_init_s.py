"""``mapper_init_s``: seconds a job spends in the query genomes' parse for
the batch plan and the hits_cap auto-tune (models/pipeline.py
FragmentStream, tuned_mapper; io/fasta.py); the mean over the jobs read
(``stats["t_mapper_init"]``, synchronised by the program)."""

from anibench.metrics._common import mean_stat

LAYER = "query reading and mapper init"
MOVES = "pairs_per_s"


def read(ctx):
    return mean_stat(ctx, "t_mapper_init")
