"""Build and load the hand-written CUDA kernels (csrc/*.cu) as one shared
library with a plain C interface, bound through ctypes.

The library is compiled with nvcc for sm_90a (Hopper) on first use, from
the package's own sources only, into ``extrack_tpu_torch/_build/``; the
file name carries a hash of the sources and flags, so an edited kernel is
rebuilt and a current one is reused.  nvcc's ``-Xptxas -v`` report
(registers, shared memory, spills per kernel) is kept beside the library
as ``<name>.log``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# pointer arguments, then int arguments, then the stream
_SIGNATURES = {
    "extrack_forward": [_P] * 15 + [_I] * 6 + [_P],
    "extrack_grad": [_P] * 19 + [_I] * 7 + [_P],
}


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "it is needed to build the CUDA kernels")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libextrack_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it is current."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *map(str, sorted(CSRC.glob("*.cu")))]
    res = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.extrack_error_string.argtypes = [ctypes.c_int]
    lib.extrack_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library; raises when there is no CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the extrack CUDA kernels need a CUDA device, and "
            "torch.cuda.is_available() is False")
    return _load()


def check(rc: int, name: str):
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = _load().extrack_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")
