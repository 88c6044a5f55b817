"""The benchmark's manifest, ``BENCHMARK.json`` at the repository root,
and the files its entries name.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by the name in the
manifest: ``anibench/configs/<name>.json`` (the file the configuration's
entry names), ``anibench/traffic/<name>.json`` and
``anibench/metrics/<name>.py``.  A cell, configuration, mix or metric is
added by adding files and entries, never by editing a file.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
from types import ModuleType

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


class Manifest:
    def __init__(self, root: pathlib.Path = ROOT,
                 bench_dir: pathlib.Path = HERE):
        self.root = pathlib.Path(root)
        self.bench_dir = pathlib.Path(bench_dir)
        with open(self.root / "BENCHMARK.json") as f:
            self.data = json.load(f)

    def _entry(self, key: str, name: str) -> dict:
        for e in self.data[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"no {key} entry named {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        """The configuration's file, as run."""
        with open(self.root / self._entry("configs", name)["file"]) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        with open(self.bench_dir / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def end_to_end(self, workload: str) -> list:
        return [m for m in self.data["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list:
        return [m for m in self.data["per_layer"]
                if workload in m.get("workloads", [workload])]

    def metric_reader(self, name: str) -> ModuleType:
        """``anibench/metrics/<name>.py``: LAYER, MOVES and read(ctx)."""
        path = self.bench_dir / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"anibench_metric_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
