"""Fixtures of the harness's tests: a copy of the benchmark's folder
beside a manifest with a tiny configuration, for runs on the CPU."""

import json
import pathlib
import shutil
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

torch.set_num_threads(1)


def tiny_root(tmp: pathlib.Path, genomes=6, genome_bp=45000, clusters=2):
    """A root with BENCHMARK.json's manifest, a copy of anibench/ and a
    configuration ``tiny`` of ``genomes`` x ``genome_bp`` in ``clusters``
    species, with cells ``tiny.all_vs_all`` and ``tiny.one_to_many``."""
    shutil.copytree(ROOT / "anibench", tmp / "anibench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "anibench/configs/clusters100_4m6.json")
                     .read_text())
    cfg.update(name="tiny", genomes=genomes, genome_bp=genome_bp,
               clusters=clusters)
    (tmp / "anibench/configs/tiny.json").write_text(json.dumps(cfg))
    man["configs"] = [dict(man["configs"][0], name="tiny",
                           file="anibench/configs/tiny.json")]
    man["workloads"] = [
        {"name": f"tiny.{t}", "config": "tiny", "traffic": t, "chips": 1,
         "why": "a CPU-sized cell"} for t in ("all_vs_all", "one_to_many")]
    for m in man["end_to_end"] + man["per_layer"]:
        m.pop("workloads", None)
    (tmp / "BENCHMARK.json").write_text(json.dumps(man))
    return tmp


@pytest.fixture
def tiny(tmp_path):
    from anibench.manifest import Manifest

    root = tiny_root(tmp_path)
    return Manifest(root, root / "anibench")
