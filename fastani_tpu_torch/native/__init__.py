"""The port's native FASTA/FASTQ parser (counterpart of
``fastani_tpu/native``).

``io_reader.cpp`` is the port's copy of the JAX package's C++ reader,
changed to parse a buffer: the caller reads the file (and inflates a
``.gz`` with Python's ``gzip``), so the library needs no zlib headers.  It
is compiled with ``g++`` at first use into ``fastani_tpu_torch/_build/``
(listed in ``.gitignore``), named by a hash of its source, and loaded with
``ctypes``.  The build writes a temp file and renames it, so several
processes may build at once.  A failed build or load raises: the Python
parser (``io.fasta.read_sequences_py``) runs only when the caller asks for
it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading
from typing import Dict, List, Tuple

import numpy as np

SRC = pathlib.Path(__file__).resolve().parent / "io_reader.cpp"
BUILD = pathlib.Path(__file__).resolve().parent.parent / "_build"

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    "fai_parse": ([ctypes.c_char_p, _I64], _P),
    "fai_num_records": ([_P], _I64),
    "fai_total_len": ([_P], _I64),
    "fai_copy_seq": ([_P, _P], None),
    "fai_copy_offsets": ([_P, _P], None),
    "fai_name": ([_P, _I64], ctypes.c_char_p),
    "fai_free": ([_P], None),
}


def lib_path(src: pathlib.Path = SRC) -> pathlib.Path:
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    return BUILD / f"lib{src.stem}_{digest}.so"


def load(src: pathlib.Path = SRC) -> ctypes.CDLL:
    """The parser library built from ``src`` (built if needed).  Raises
    ``RuntimeError`` with g++'s output if the build fails, and ``OSError``
    if the library does not load."""
    src = pathlib.Path(src)
    with _LOCK:
        if str(src) in _LIBS:
            return _LIBS[str(src)]
        out = lib_path(src)
        if not out.exists():
            BUILD.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
            os.close(fd)
            try:
                res = subprocess.run(
                    ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                     str(src), "-o", tmp], capture_output=True, text=True,
                    timeout=240)
                if res.returncode != 0:
                    raise RuntimeError(f"g++ failed to build {src}:\n"
                                       f"{res.stderr}")
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(out))
        for fn, (argtypes, restype) in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LIBS[str(src)] = lib
        return lib


def parse(data: bytes) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """The records of a FASTA/FASTQ file's bytes: (names, all sequence
    bytes as one uint8 array, (n + 1,) int64 record offsets into it)."""
    lib = load()
    h = lib.fai_parse(data, len(data))
    try:
        n = lib.fai_num_records(h)
        seq = np.empty(lib.fai_total_len(h), np.uint8)
        offsets = np.empty(n + 1, np.int64)
        if len(seq):
            lib.fai_copy_seq(h, seq.ctypes.data_as(_P))
        lib.fai_copy_offsets(h, offsets.ctypes.data_as(_P))
        names = [lib.fai_name(h, i).decode("ascii", "replace")
                 for i in range(n)]
    finally:
        lib.fai_free(h)
    return names, seq, offsets
