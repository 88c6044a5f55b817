"""Build, load and count the hand-written CUDA kernels.

Each source under ``fastani_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries are
built at first use into ``fastani_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of their source so an edited source is
rebuilt.  ``build_all()`` starts one ``nvcc`` per source at once.

Every C entry point launches on the stream it is given (PyTorch's current
stream) and returns ``cudaGetLastError()``; ``check`` raises on non-zero.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched it — the
only module state of the package.  ``chip_smoke.py`` zeroes it before
driving the main path and reads it after, to show the path ran through
every kernel.  A CUDA graph replay calls no wrapper: its capture records
the wrappers' calls (``captured_launches``, which leaves LAUNCHES as it
was, since a capture launches nothing) and each replay adds them
(``add_launches``).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD = pathlib.Path(__file__).resolve().parent.parent / "_build"

# library name -> source file (K3 and K4 share sort.cu, E1 and E2
# events.cu)
SOURCES = {
    "winnow": "winnow.cu",
    "compact": "compact.cu",
    "sort": "sort.cu",
    "events": "events.cu",
    "walk": "walk.cu",
    "fold": "fold.cu",
}
KERNELS = ("winnow", "compact", "sort", "sort_kv", "events", "events_scan",
           "walk", "fold")

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_LIBS: Dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int

# C signatures: every function returns int (a cudaError_t)
_SIGNATURES = {
    "winnow": {"fa_winnow_tiles": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _P, _P, _P, _P, _P, _P],
               "fa_winnow_smem": [_I, _I, _I]},
    "compact": {"fa_compact_rows": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                                    _P, _P, _P]},
    "sort": {"fa_sort_rows_u32": [_P, _P, _I, _I, _P],
             "fa_sort_rows_u32_kv": [_P, _P, _P, _P, _I, _I, _P]},
    "events": {"fa_events": [_P] * 12 + [_I, ctypes.c_longlong, _I, _I, _I]
               + [_P] * 8,
               "fa_events_scan": [_P] * 6 + [_I, _I, _I] + [_P] * 8},
    "walk": {"fa_walk": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _P, _P, _P, _P],
             "fa_walk_blocks_per_sm": [_I, _P]},
    "fold": {"fa_fold_rows": [_P, _P, _P, _I, _I, _I, _P, _P, _P],
             "fa_finalize_rows": [_P] * 5 + [_I] * 5 + [_P] * 3},
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def captured_launches():
    """Around a CUDA graph capture: yields a dict that receives, on exit,
    the launches the wrappers counted inside, which are then taken back
    out of LAUNCHES."""
    before = dict(LAUNCHES)
    counted: Dict[str, int] = {}
    try:
        yield counted
    finally:
        counted.update({name: LAUNCHES[name] - n
                        for name, n in before.items() if LAUNCHES[name] != n})
        LAUNCHES.update(before)


def add_launches(counted: Dict[str, int]) -> None:
    """Count one replay of a graph whose capture counted ``counted``."""
    for name, n in counted.items():
        LAUNCHES[name] += n


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _lib_path(src: str) -> pathlib.Path:
    digest = hashlib.sha1((CSRC / src).read_bytes()).hexdigest()[:12]
    return BUILD / f"lib{pathlib.Path(src).stem}_{digest}.so"


def _nvcc_cmd(src: str, out: pathlib.Path) -> list:
    return [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", str(out), str(CSRC / src)]


def build_all() -> Dict[str, dict]:
    """Compile every source not yet built, one nvcc per source, all at
    once.  Returns {source: {"seconds", "ptxas"}} for the sources built;
    raises with nvcc's output if one fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sorted(set(SOURCES.values())):
        out = _lib_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[src] = (subprocess.Popen(_nvcc_cmd(src, tmp),
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out, time.time())
    report = {}
    for src, (proc, tmp, out, t0) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{text}")
        os.replace(tmp, out)
        report[src] = {"seconds": round(time.time() - t0, 3),
                       "ptxas": [ln for ln in text.splitlines()
                                 if "registers" in ln or "smem" in ln]}
    return report


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name`` (built if needed)."""
    if name not in _LIBS:
        path = _lib_path(SOURCES[name])
        if not path.exists():
            build_all()
        handle = ctypes.CDLL(str(path))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = ctypes.c_int
        _LIBS[name] = handle
    return _LIBS[name]


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError {err}")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; ``cuda`` without a card raises
    (no quiet fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run the plain PyTorch "
                           "versions of the kernels on the CPU")
    return dev


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """Validate the tensors a kernel is launched on."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: tensor on {t.device}, expected cuda")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensor is not contiguous")
