#!/usr/bin/env python3
"""One kernel against other versions of its source, on the same inputs, in
one process on one card.

    python3 scripts/torch_kernel_versions.py KERNEL OTHER_CU [OTHER_CU ...]

KERNEL is ``walk`` (K5), ``sort_kv`` (K4), ``sort`` (K3) or ``compact``
(K2); each OTHER_CU is a source with the same C entry points as
``fastani_tpu_torch/csrc/`` has for it, built with the flags of
``ops/cuda.py`` into ``.smokework/``.  The inputs: for ``walk``,
``chip_smoke.real_streams`` (U 512 and 4096, scap 320); for ``sort_kv``,
``chip_smoke.kv_inputs``; for ``sort`` and ``compact``, what each of the
kernel's call sites gets on the main path (``chip_smoke.capture_sites``
on bench.py's mid genomes).  Every version is compared with the plain version and timed
against this one in turns (other, this, this, other; CUDA events around a
CUDA graph of 20 calls, after a warm-up).  Prints one JSON line with the
card's name and power limit, each version's max abs error and times;
exits 1 if another version differs from the plain version (raises at once
if this one does).  Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def cases(torch, np, kernel, chip_smoke):
    """[(label, run, plain outputs)] for ``kernel``."""
    from fastani_tpu_torch.models import l2walk
    from fastani_tpu_torch.ops import compact, sort

    if kernel == "walk":
        streams, scap = chip_smoke.real_streams(torch, np,
                                                torch.device("cuda"))
        return [(f"U {U} (T {ev['dn'].shape[1]}, scap {scap})",
                 lambda ev=ev, s_u=s_u, n_ev=n_ev:
                 l2walk.walk(ev, s_u, n_ev, scap),
                 l2walk.walk_plain(ev, s_u, n_ev, scap))
                for U, (ev, s_u, n_ev) in streams.items()]
    if kernel == "sort_kv":
        k, p = chip_smoke.kv_inputs(torch, torch.device("cuda"))
        return [(f"L2 events {list(k.shape)}",
                 lambda: sort.sort_rows_u32_kv(k, p),
                 sort.sort_rows_u32_kv_plain(k, p))]
    wd = chip_smoke.WORK / "versions"
    wd.mkdir(parents=True, exist_ok=True)
    paths = chip_smoke.build_workload(np, wd, chip_smoke.N_GENOMES,
                                      chip_smoke.GENOME_BP)
    sites, _ = chip_smoke.capture_sites(torch, paths)
    shutil.rmtree(wd, ignore_errors=True)
    out = []
    for (k, site), v in sorted(sites.items()):
        if k != kernel:
            continue
        a, kw = v["args"], v["kw"]
        if kernel == "sort":
            x = a[0]
            out.append((f"{site} {list(x.shape)}",
                        lambda x=x: [sort.sort_rows_u32(x)],
                        [sort.sort_rows_u32_plain(x)]))
        else:
            flags, pays = a[0], a[1]
            width = kw.get("width", a[2] if len(a) > 2 else flags.shape[1])
            out.append((f"{site} {list(flags.shape)} x{len(pays)} -> {width}",
                        lambda f=flags, p=pays, w=width:
                        compact.compact_rows(f, p, w),
                        compact.compact_rows_plain(flags, pays, width)))
    return out


def main(argv) -> int:
    import numpy as np
    import torch

    if len(argv) < 3 or argv[1] not in ("walk", "sort_kv", "sort",
                                          "compact"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_kernel_versions: no CUDA device", file=sys.stderr)
        return 2
    kernel = argv[1]
    source = "sort" if kernel == "sort_kv" else kernel     # K3, K4: sort.cu
    others = [pathlib.Path(a).resolve() for a in argv[2:]]
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from fastani_tpu_torch.ops import cuda as kc

    out_dir = chip_smoke.WORK / "kernel_versions"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs, ptxas = {}, {}
    for i, src in enumerate(others):
        so = out_dir / f"lib{source}_other{i}.so"
        built = subprocess.run(kc._nvcc_cmd(str(src), so), check=True,
                               capture_output=True, text=True)
        ptxas[str(src)] = [ln for ln in (built.stdout + built.stderr).split(
            "\n") if "registers" in ln]
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in kc._SIGNATURES[source].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[str(src)] = lib
    this = kc.lib(source)

    def use(lib):
        # the wrappers launch whatever library cuda.lib(source) returns
        kc._LIBS[source] = lib

    rows = []
    for label, run, want in cases(torch, np, kernel, chip_smoke):
        for src, other in libs.items():
            times, errs = {"other": [], "this": []}, {}
            for name, lib in (("other", other), ("this", this),
                              ("this", this), ("other", other)):
                use(lib)
                errs[name] = max(errs.get(name, 0.0), chip_smoke.max_abs_err(
                    torch, list(run()), list(want)))
                times[name].append(chip_smoke.time_ms(torch, run, 20,
                                                      graph=True))
            rows.append({"case": label, "other": src,
                         "other_ms": times["other"], "this_ms": times["this"],
                         "other_max_abs_err": errs.pop("other")})
            if errs["this"] != 0:
                raise AssertionError(f"{kernel} differs from its plain "
                                     f"version at {label}")
    use(this)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": chip_smoke.nvidia_smi(),
                      "kernel": kernel, "ptxas": ptxas, "versions": rows}))
    # a version that differs from the plain version is reported, then
    # fails the run
    return 1 if any(r["other_max_abs_err"] for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
