"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 anibench/run.py --workload species100_3m.all_vs_all \
        --seed 12345 --seconds 10 --trace 0

Prints each job's seconds and phases, then, as its last line, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``compared``: each
number of the correctness check with its limit (also the last lines of
standard error).  Exits non-zero, with no result, without enough CUDA
devices or when a JAX module was loaded.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the program's and PyTorch's build and kernel caches stay in the checkout,
# at fixed paths, so that only a checkout's first run builds
CACHE = ROOT / ".anibench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["USE_FLAX"] = "0"
# the repository root, not this directory, heads the path: a module here
# must not shadow one of the standard library's
sys.path[0] = str(ROOT)

if __name__ == "__main__":
    # imported here: the reference's worker processes, which import this
    # file as their main module, load nothing of the harness
    from anibench import harness

    raise SystemExit(harness.main(sys.argv[1:], T_START))
