#!/usr/bin/env python3
"""K5 against other versions of its source, on the same real event
streams, in one process on one card.

    python3 scripts/torch_walk_versions.py OTHER_WALK_CU [OTHER_WALK_CU ...]

Builds each OTHER_WALK_CU (a walk.cu with the same C entry point
``fa_walk``) with the flags of ``ops/cuda.py`` into ``.smokework/``, makes
``chip_smoke.real_streams`` (U 512 and 4096, scap 320), compares every
kernel with ``walk_plain`` and times each other version against this one
in turns (other, this, this, other; CUDA events, 20 calls each after a
warm-up).  Prints one JSON line with the card's name and power limit,
each version's max abs error and times; exits 1 if another version
differs from ``walk_plain`` (raises at once if this one does).  Needs a
CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv) -> int:
    import numpy as np
    import torch

    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_walk_versions: no CUDA device", file=sys.stderr)
        return 2
    others = [pathlib.Path(a).resolve() for a in argv[1:]]
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from fastani_tpu_torch.models import l2walk
    from fastani_tpu_torch.ops import cuda as kc

    out_dir = ROOT / ".smokework" / "walk_versions"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for i, src in enumerate(others):
        so = out_dir / f"libwalk_other{i}.so"
        subprocess.run(kc._nvcc_cmd(str(src), so), check=True,
                       capture_output=True, text=True)
        libs[str(src)] = ctypes.CDLL(str(so))
        libs[str(src)].fa_walk.argtypes = kc._SIGNATURES["walk"]["fa_walk"]
        libs[str(src)].fa_walk.restype = ctypes.c_int
    this = kc.lib("walk")

    def use(lib):
        # l2walk.walk launches whatever library cuda.lib("walk") returns
        kc._LIBS["walk"] = lib

    streams, scap = chip_smoke.real_streams(torch, np, torch.device("cuda"))
    rows = []
    for U, (ev, s_u, n_ev) in streams.items():
        run = lambda: l2walk.walk(ev, s_u, n_ev, scap)
        want = l2walk.walk_plain(ev, s_u, n_ev, scap)
        for src, other in libs.items():
            times, errs = {"other": [], "this": []}, {}
            for name, lib in (("other", other), ("this", this),
                              ("this", this), ("other", other)):
                use(lib)
                errs[name] = max(errs.get(name, 0.0), chip_smoke.max_abs_err(
                    torch, list(run()), list(want)))
                times[name].append(chip_smoke.time_ms(torch, run, 20))
            rows.append({"U": U, "T": ev["dn"].shape[1], "scap": scap,
                         "n_ev_mean": float(n_ev.float().mean()),
                         "other": src, "other_ms": times["other"],
                         "this_ms": times["this"],
                         "other_max_abs_err": errs.pop("other")})
            if errs["this"] != 0:
                raise AssertionError(f"walk differs from walk_plain at U {U}")
    use(this)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": chip_smoke.nvidia_smi(),
                      "walk": rows}))
    # a version that differs from walk_plain is reported, then fails the run
    return 1 if any(r["other_max_abs_err"] for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
