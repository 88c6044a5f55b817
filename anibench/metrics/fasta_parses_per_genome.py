"""``fasta_parses_per_genome``: how many times a job parses each genome
file: the program's ``fasta.parses`` counter over ``fasta.files``, the
distinct files it parsed (fastani_tpu_torch/io/fasta.py
read_sequences).  The counter is also kept by purpose
(``fasta.parses[<span>]``: the index build, the batch plan, the batches'
loads, the write's genome lengths).  Summed over the traced jobs."""

from anibench.metrics._spans import counter_sums

LAYER = "FASTA reader"
MOVES = "pairs_per_s"


def read(ctx):
    sums = counter_sums(ctx, "fasta.parses", "fasta.files")
    if sums is None or not sums[1]:
        return None
    return sums[0] / sums[1]
