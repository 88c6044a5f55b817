"""``index_peak_gb``: the device allocator's peak at the end of the index
build, in GB: the program's ``index.peak_bytes`` counter
(``torch.cuda.max_memory_allocated()`` read at the end of
``index_build``, fastani_tpu_torch/models/pipeline.py reference_index),
which the harness resets before the traced job; the mean over the traced
jobs.  No reading where the program records no such counter, or 0 (off
a card)."""

from anibench.metrics._spans import recorded

LAYER = "index build"
MOVES = "peak_mem_gb"


def read(ctx):
    peaks = [j.get("counters", {}).get("index.peak_bytes")
             for j in recorded(ctx)]
    if not peaks or not all(peaks):
        return None
    return sum(peaks) / len(peaks) / 1e9
