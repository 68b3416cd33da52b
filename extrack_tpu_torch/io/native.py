"""ctypes bindings for the native track reader (``native/track_reader.cpp``).

The port builds its own copy of the shared library from that source with
``g++`` (no pybind11, no PyTorch headers: a plain C interface) into the
package's git-ignored ``_build/`` directory, named after a hash of the
source and the flags, and loads it with ctypes.  ``available()`` says
whether it could be built and loaded; ``parse_csv_columns`` returns None
when it cannot take a file, and the readers decide what that means
(``io.readers.read_table``'s ``engine``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "track_reader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# the flags of native/Makefile, so both packages parse a cell to the same
# double
CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
            "-shared"]
_lib = None
_build_error: Optional[str] = None


def library_path() -> Path:
    """Where the built library lives: one file per source and flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    return BUILD_DIR / f"libtrack_reader_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the reader unless this source's library exists; raises
    RuntimeError when the source or ``g++`` is missing or the compile
    fails.  The compile writes a temporary file and renames it, so
    processes building at once never load a half-written library."""
    if not SOURCE.exists():
        raise RuntimeError(f"native reader source {SOURCE} not found")
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("the native reader needs g++, which is not on "
                           "PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXXFLAGS, "-o", tmp, str(SOURCE),
                               "-lpthread"], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("building the native reader failed:\n"
                               + proc.stderr[-2000:])
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _load():
    """The loaded library, building it at the first call; None (with the
    reason kept for ``build_error``) when it cannot be built or loaded."""
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError) as exc:
        _build_error = str(exc)
        return None
    lib.tr_parse_csv.restype = ctypes.c_void_p
    lib.tr_parse_csv.argtypes = [ctypes.c_char_p, ctypes.c_char,
                                 ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int]
    lib.tr_rows.restype = ctypes.c_int64
    lib.tr_rows.argtypes = [ctypes.c_void_p]
    lib.tr_data.restype = ctypes.POINTER(ctypes.c_double)
    lib.tr_data.argtypes = [ctypes.c_void_p]
    lib.tr_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library could not be built or loaded, or None."""
    _load()
    return _build_error


def read_header(path: str, sep: str = ",") -> List[str]:
    with open(path, "r") as fh:
        return [c.strip() for c in fh.readline().rstrip("\n\r").split(sep)]


def parse_csv_columns(path: str, columns: Sequence[str], sep: str = ",",
                      n_threads: int = 0) -> Optional[np.ndarray]:
    """Parse the named numeric columns of a CSV into an (N, n_cols) float64
    array (non-numeric cells and every cell of a row with a quote become
    NaN).  Returns None if the library is unavailable, a column is
    missing or the file cannot be read."""
    lib = _load()
    if lib is None:
        return None
    header = read_header(path, sep)
    try:
        idx = [header.index(c) for c in columns]
    except ValueError:
        return None
    arr_idx = (ctypes.c_int * len(idx))(*idx)
    handle = lib.tr_parse_csv(str(path).encode(), sep.encode(), arr_idx,
                              len(idx), 1, n_threads)
    if not handle:
        return None
    try:
        rows = lib.tr_rows(handle)
        if rows < 0:
            return None
        if rows == 0:
            return np.zeros((0, len(idx)))
        buf = np.ctypeslib.as_array(lib.tr_data(handle),
                                    shape=(rows, len(idx)))
        return np.array(buf, dtype=np.float64)   # copy before free
    finally:
        lib.tr_free(handle)
