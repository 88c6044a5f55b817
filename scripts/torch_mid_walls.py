#!/usr/bin/env python3
"""Mid's walls on one card through a tree's own smoke phases, to set two
trees side by side.

    python3 scripts/torch_mid_walls.py [--tree DIR]

Runs, from the ``chip_smoke.py`` and the package of ``--tree`` (default:
this checkout; give an unpacked older commit to measure it), the phases
that drive bench.py's mid (32 genomes x 3 Mbp, seed 123): the goldens
(phase 2, which the mesh phase reads), the fast path with graphs (phase
3), the exact path (phase 3c) and ``--mesh 2x2`` (phase 3e), each with
its own checks.  Prints one JSON line: the tree, the card's name and
power limit, and for each of those phases' lines every number in
seconds (its keys ending in ``_s``).  Run trees in turns in one call
(parent, change, change, parent), each in a process of its own.  Needs
a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PHASES = ("main_path", "exact", "mesh_fast", "mesh_fast_graphs")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    a = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_mid_walls: no CUDA device", file=sys.stderr)
        return 2
    tree = pathlib.Path(a.tree).resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  tree / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    from fastani_tpu_torch.ops import cuda as kc

    rows = []
    emit = cs.emit
    cs.emit = lambda obj: (rows.append(obj), emit(obj))
    kc.build_all()
    golden = cs.run_golden(np)
    cs.run_main_path(torch, np, cs.N_GENOMES, cs.GENOME_BP)
    cs.run_exact_mid(torch, cs.N_GENOMES)
    cs.run_mesh(torch, np, cs.N_GENOMES, golden)
    walls = {r["phase"]: {k: v for k, v in r.items() if k.endswith("_s")}
             for r in rows if r.get("phase") in PHASES}
    print(json.dumps({"tree": str(tree), "nvidia_smi": cs.nvidia_smi(),
                      **walls}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
