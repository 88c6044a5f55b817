#!/usr/bin/env python3
"""One kernel against other versions of its source, on the same inputs, in
one process on one card.

    python3 scripts/torch_kernel_versions.py KERNEL OTHER_CU [OTHER_CU ...]

KERNEL is ``walk`` (K5), ``sort_kv`` (K4), ``sort`` (K3), ``compact``
(K2), ``winnow`` (K1), ``events`` (E1), ``events_scan`` (E2) or ``fold``;
each OTHER_CU is a source with the same C entry points as
``fastani_tpu_torch/csrc/`` has for it (for ``winnow`` also the
``fa_winnow_rows`` entry point of the row-per-block K1, whose int64 hashes
are compared as int32 words; for ``fold`` a source without
``fa_finalize_rows``, such as PR 13's, whose finalize is then the
composition of five ops around its ``fa_fold_rows``), built with the
flags of ``ops/cuda.py`` into ``.smokework/``.  The inputs: for
``walk``, ``chip_smoke.real_streams`` (U 512 and 4096, scap 320); for
``sort_kv``, ``chip_smoke.kv_inputs``; for
``sort``, ``compact``, ``winnow``, ``events`` and ``events_scan``, what
each of the kernel's call sites gets on the main path
(``chip_smoke.capture_sites`` on bench.py's mid genomes), and for the
last two also what ``build_events`` gives them at U 4096 inside
``chip_smoke.real_streams``; for ``fold``, ``fold_rows`` on the rows of
the main path's finalize site and at ``chip_smoke.fold_inputs``' three
sites, and the finalize at its site (``chip_smoke.finalize_case``: the
slots and accumulators put back before each call, which is also timed
alone as the case "restore only").  Every version is compared with the
plain version and timed against this one in turns (other, this, this, other;
CUDA events around a CUDA graph of 20 calls, after a warm-up); ``winnow``
also times this source at the tile widths of ``WINNOW_TILES``.  Prints
one JSON line with the card's name and power limit, each version's max
abs error and times; exits 1 if another version differs from the plain
version (raises at once if this one does).  Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

# the row-per-block K1's entry point: (rows, ctg, base, tlen, R, W, k, w,
# emit, int64 hash, 3 x (R,) int32 scratch, stream)
_WINNOW_ROWS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
    [ctypes.c_void_p] * 6
# tile widths at which ``winnow`` also times this source
WINNOW_TILES = (512, 1024, 2048, 4096)


def winnow_run(torch, args):
    """(run, as_words) of K1 on ``args`` through whichever library
    ``cuda.lib("winnow")`` holds: the wrapper for this source's entry
    point, a direct call for the row-per-block one; ``as_words`` turns the
    outputs into the plain version's (emit bool, int32 hash words)."""
    from fastani_tpu_torch.ops import cuda as kc
    from fastani_tpu_torch.ops import winnow
    from fastani_tpu_torch.ops.xputils import u32_as_i32

    rows, ctg, base, tl, k, w = args

    def run():
        lib = kc.lib("winnow")
        if hasattr(lib, "fa_winnow_tiles"):
            return winnow.winnow_rows(*args)
        R, W = rows.shape
        seg = W - (w - 1) - (k - 1)
        emit = torch.empty((R, seg), dtype=torch.uint8, device=rows.device)
        h = torch.empty((R, seg), dtype=torch.int64, device=rows.device)
        scratch = torch.empty((3, R), dtype=torch.int32, device=rows.device)
        kc.check(lib.fa_winnow_rows(
            rows.data_ptr(), ctg.data_ptr(), base.data_ptr(), tl.data_ptr(),
            R, W, k, w, emit.data_ptr(), h.data_ptr(), scratch[0].data_ptr(),
            scratch[1].data_ptr(), scratch[2].data_ptr(), kc.stream()),
            "winnow")
        return emit, h

    def as_words(out):
        emit, h = out
        return [emit.bool(), h if h.dtype == torch.int32 else u32_as_i32(h)]

    return run, as_words


def cases(torch, np, kernel, chip_smoke):
    """[(label, run, plain outputs, as_words[, winnow's arguments])] for
    ``kernel``: ``as_words`` turns run's outputs into the plain version's
    words for the comparison (outside the timed calls)."""
    from fastani_tpu_torch.models import l2walk
    from fastani_tpu_torch.ops import compact, sort, winnow

    if kernel == "walk":
        streams, scap = chip_smoke.real_streams(torch, np,
                                                torch.device("cuda"))
        return [(f"U {U} (T {ev['dn'].shape[1]}, scap {scap})",
                 lambda ev=ev, s_u=s_u, n_ev=n_ev:
                 l2walk.walk(ev, s_u, n_ev, scap),
                 l2walk.walk_plain(ev, s_u, n_ev, scap), list)
                for U, (ev, s_u, n_ev) in streams.items()]
    if kernel == "sort_kv":
        k, p = chip_smoke.kv_inputs(torch, torch.device("cuda"))
        return [(f"L2 events {list(k.shape)}",
                 lambda: sort.sort_rows_u32_kv(k, p),
                 sort.sort_rows_u32_kv_plain(k, p), list)]
    wd = chip_smoke.WORK / "versions"
    wd.mkdir(parents=True, exist_ok=True)
    paths = chip_smoke.build_workload(np, wd, chip_smoke.N_GENOMES,
                                      chip_smoke.GENOME_BP)
    sites = chip_smoke.capture_sites(torch, paths)[0]
    shutil.rmtree(wd, ignore_errors=True)
    out = []
    for (k, site), v in sorted(sites.items()):
        if k != kernel:
            continue
        a, kw = v["args"], v["kw"]
        if kernel in chip_smoke.EVENTS:
            out.append(event_case(torch, chip_smoke, kernel, site, (a, kw)))
        elif kernel == "fold":
            out += fold_cases(torch, np, chip_smoke, site, a, kw)
        elif kernel == "winnow":
            run, as_words = winnow_run(torch, a)
            out.append((f"{site} {list(a[0].shape)}", run,
                        winnow.winnow_rows_plain(*a), as_words, a))
        elif kernel == "sort":
            x = a[0]
            out.append((f"{site} {list(x.shape)}",
                        lambda x=x: [sort.sort_rows_u32(x)],
                        [sort.sort_rows_u32_plain(x)], list))
        else:
            flags, pays = a[0], a[1]
            width = kw.get("width", a[2] if len(a) > 2 else flags.shape[1])
            out.append((f"{site} {list(flags.shape)} x{len(pays)} -> {width}",
                        lambda f=flags, p=pays, w=width:
                        compact.compact_rows(f, p, w),
                        compact.compact_rows_plain(flags, pays, width),
                        list))
    if kernel in chip_smoke.EVENTS:
        # E1's and E2's inputs at U 4096: build_events on real_streams'
        # first 4096 units
        with chip_smoke.kernel_sites(torch, chip_smoke.EVENTS) as seen:
            chip_smoke.real_streams(torch, np, torch.device("cuda"),
                                    sizes=(4096,))
        out += [event_case(torch, chip_smoke, kernel, f"U 4096 {label}",
                           v["inputs"][0])
                for (k, label), v in chip_smoke.site_labels(seen).items()
                if k == kernel]
    return out


def fold_cases(torch, np, chip_smoke, site, a, kw):
    """``cases`` entries of the fold: ``fold_rows`` on the rows the main
    path's finalize folds and at the synthetic sites, the finalize (fused
    where the library has ``fa_finalize_rows``, else the composition
    around its ``fa_fold_rows``) and its restore alone."""
    from fastani_tpu_torch.models import device_cgi
    from fastani_tpu_torch.ops import cuda as kc

    tab, _, _, fin, ranges, n_slots = a
    rows = kw.get("rows")
    inputs = {site: (tab[fin % n_slots] if rows is None else rows, ranges)}
    inputs.update({f"{n} bins": v for n, v in chip_smoke.fold_inputs(
        torch, np, torch.device("cuda")).items()})
    out = [(f"{label} {list(r.shape)}", lambda r=r, g=g:
            device_cgi.fold_rows(r, g), device_cgi.fold_rows_plain(r, g),
            list) for label, (r, g) in inputs.items()]
    run_fin, want = chip_smoke.finalize_case(torch, a, kw)
    fused = lambda: run_fin("fused" if hasattr(kc.lib("fold"),
                                               "fa_finalize_rows")
                            else "composition")
    return out + [(f"{site} finalize {list(tab.shape)}", fused, want, list),
                  (f"{site} finalize, restore only", lambda: run_fin(
                      "restore"), [x.clone() for x in a[:3]], list)]


def event_case(torch, chip_smoke, kernel, label, inputs):
    """A ``cases`` entry of E1 or E2 on one call's (args, kw)."""
    from fastani_tpu_torch.models import l2walk

    (a, kw), = chip_smoke.map_tensors(torch, lambda x: x.to("cuda"),
                                      [inputs])
    fn, plain = getattr(l2walk, kernel), getattr(l2walk, kernel + "_plain")
    words = lambda out: chip_smoke.tensors_of(torch, out)
    want = words(plain(*a, **kw))
    shape = list(want[0].shape) + ([a[0].shape[1]] if kernel == "events"
                                   else [])           # (U, T[, scap])
    return f"{label} {shape}", lambda: fn(*a, **kw), want, words


def main(argv) -> int:
    import numpy as np
    import torch

    if len(argv) < 3 or argv[1] not in ("walk", "sort_kv", "sort",
                                          "compact", "winnow", "events",
                                          "events_scan", "fold"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_kernel_versions: no CUDA device", file=sys.stderr)
        return 2
    kernel = argv[1]
    # K3 and K4 share sort.cu, E1 and E2 events.cu
    source = {"sort_kv": "sort", "events_scan": "events"}.get(kernel, kernel)
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
        signatures = kc._SIGNATURES[source]
        if source == "winnow" and not hasattr(lib, "fa_winnow_tiles"):
            signatures = {"fa_winnow_rows": _WINNOW_ROWS}
        # an older source may lack an entry point (fold: fa_finalize_rows)
        for fn, argtypes in signatures.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[str(src)] = lib
    this = kc.lib(source)

    def use(lib):
        # the wrappers launch whatever library cuda.lib(source) returns
        kc._LIBS[source] = lib

    rows, tiles = [], []
    for label, run, want, as_words, *args in cases(torch, np, kernel,
                                                   chip_smoke):
        for src, other in libs.items():
            times, errs = {"other": [], "this": []}, {}
            for name, lib in (("other", other), ("this", this),
                              ("this", this), ("other", other)):
                use(lib)
                errs[name] = max(errs.get(name, 0.0), chip_smoke.max_abs_err(
                    torch, as_words(run()), list(want)))
                times[name].append(chip_smoke.time_ms(torch, run, 20,
                                                      graph=True))
            rows.append({"case": label, "other": src,
                         "other_ms": times["other"], "this_ms": times["this"],
                         "other_max_abs_err": errs.pop("other")})
            if errs["this"] != 0:
                raise AssertionError(f"{kernel} differs from its plain "
                                     f"version at {label}")
        if kernel == "winnow":
            # this source at other tile widths (ops/winnow.tile_geometry)
            use(this)
            from fastani_tpu_torch.ops import winnow
            a = args[0]
            for tile_max in WINNOW_TILES:
                fn = lambda t=tile_max: winnow.winnow_rows(*a, tile_max=t)
                if chip_smoke.max_abs_err(torch, list(fn()), list(want)):
                    raise AssertionError(f"winnow at tile_max {tile_max} "
                                         f"differs at {label}")
                tiles.append({"case": label, "tile_max": tile_max,
                              "tile": winnow.tile_geometry(
                                  want[1].shape[1], tile_max)[0],
                              "ms": [chip_smoke.time_ms(torch, fn, 20,
                                                        graph=True)
                                     for _ in range(2)]})
    use(this)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": chip_smoke.nvidia_smi(),
                      "kernel": kernel, "ptxas": ptxas, "versions": rows,
                      "tiles": tiles}))
    # a version that differs from the plain version is reported, then
    # fails the run
    return 1 if any(r["other_max_abs_err"] for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
