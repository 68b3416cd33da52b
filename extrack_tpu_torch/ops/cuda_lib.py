"""Build and load the hand-written CUDA kernels (csrc/*.cu) as one shared
library with a plain C interface, bound through ctypes.

The library is compiled with nvcc for sm_90a (Hopper) on first use, from
the package's own sources only, into ``extrack_tpu_torch/_build/``: one
nvcc process per ``.cu`` file, all started together, then one link.  The
file name carries a hash of the sources and flags, so an edited kernel is
rebuilt and a current one is reused.  nvcc's ``-Xptxas -v`` report
(registers, shared memory, spills per kernel) is kept beside the library
as ``<name>.log``.  ``enable_profile()`` switches a process to a build
with the kernels' clock64 cycle split compiled in (``-DEXTRACK_PROFILE``,
read by ``profile_counters``), for the profiling tools only.
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# pointer arguments, then int arguments, then the stream
_SIGNATURES = {
    "extrack_forward": [_P] * 15 + [_I] * 6 + [_P],
    "extrack_grad": [_P] * 19 + [_I] * 9 + [_P],
    "extrack_hvp": [_P] * 19 + [_I] * 9 + [_P],
    "extrack_grad_occupancy": [_I] * 6,
    "extrack_hvp_occupancy": [_I] * 6,
    "extrack_predict": [_P] * 17 + [_I] * 9 + [_P],
    "extrack_hist": [_P] * 14 + [_I] * 8 + [_P],
    "extrack_refine": [_P] * 11 + [_I] * 6 + [_P],
    "extrack_topk": [_P] * 12 + [_I] * 12 + [_P],
}
# dynamic shared memory one block of a kernel may opt in to, per device
_SMEM_QUERIES = ("extrack_grad_smem", "extrack_predict_smem", "extrack_hist_smem",
                 "extrack_refine_smem", "extrack_topk_smem")
# bytes of per-track carries the persistent blocks may hold in global
# scratch when the carries do not fit in shared memory
SCRATCH_BUDGET = 1 << 30


PROFILE_SECTIONS = 12      # kProfSlots in csrc/common.cuh


def enable_profile():
    """Build and load the kernels with their cycle split compiled in.  Call
    before the first ``library()``; the profile build is a library of its
    own (its flags are in the hash)."""
    if _load.cache_info().currsize:
        raise RuntimeError("enable_profile() after the library was loaded")
    if "-DEXTRACK_PROFILE" not in NVCC_FLAGS:
        NVCC_FLAGS.append("-DEXTRACK_PROFILE")


def profile_counters(kernel: str) -> list:
    """The cycle counters of ``kernel`` ("grad" or "topk") summed over every
    track since the last read, then zeroed (profile builds only)."""
    out = (ctypes.c_ulonglong * PROFILE_SECTIONS)()
    fn = getattr(library(), f"extrack_{kernel}_prof")
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    check(fn(ctypes.addressof(out)), f"{kernel} profile read")
    return list(out)


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
    nvcc = find_nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate()[0] for p in procs]
    failed = [o.stem for o, p in zip(objs, procs) if p.returncode != 0]
    tmp = out.with_name(f"{tag}.so.tmp")
    if not failed:
        res = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o",
                              str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
        logs.append(res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append("link")
    out.with_suffix(".log").write_text("".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n"
                           + "".join(logs))
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
    for name in _SMEM_QUERIES:
        getattr(lib, name).argtypes = [ctypes.c_int]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library; raises when there is no CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the extrack CUDA kernels need a CUDA device, and "
            "torch.cuda.is_available() is False")
    return _load()


def check_device(device):
    """Raise unless ``device`` is the CPU or CUDA with a device present:
    entry points that default to the card never carry on quietly on the
    CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} needs a CUDA device, and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain engine on the CPU")


@functools.cache
def smem_bytes(query: str, device_index: int) -> int:
    """Dynamic shared memory a block of one kernel may opt in to on this
    card: ``query`` (one of ``_SMEM_QUERIES``) returns the card's opt-in
    limit (227 KB on Hopper) less the kernel's static shared memory."""
    rc = getattr(library(), query)(device_index)
    if rc < 0:
        check(-rc, f"{query} (shared memory query)")
    return rc


def grid(query: str, dev, B: int, K: int, fixed_bytes: int,
         carry_bytes: int):
    """Blocks and scratch for a kernel that walks one track per block with
    one thread per slot (K4, K5, K6).  When ``fixed_bytes`` of shared
    memory plus the track's ``carry_bytes`` fit what a block may opt in to
    (``query``), one block per track and no scratch; else persistent
    blocks, as many as the card keeps resident, each with its carries in
    global scratch.  Returns (nblk, float32 scratch tensor or None)."""
    if fixed_bytes + carry_bytes <= smem_bytes(query, dev.index):
        return max(B, 1), None
    threads = (K + 31) // 32 * 32
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nblk = max(1, min(B, sms * max(1, 2048 // threads),
                      SCRATCH_BUDGET // carry_bytes))
    return nblk, torch.empty(nblk * carry_bytes // 4, dtype=torch.float32,
                             device=dev)


def check_args(want, dev):
    """Raise unless every (tensor, shape, dtype) of ``want`` is contiguous
    on ``dev`` with that shape and dtype: the checks before raw pointers go
    to a kernel."""
    if dev.type != "cuda":
        raise ValueError(f"kernel inputs must be CUDA tensors, got {dev}")
    for t, shape, dtype in want:
        if (t.device != dev or t.dtype != dtype
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
            raise ValueError(
                f"kernel input {tuple(t.shape)} {t.dtype} on {t.device} "
                f"(contiguous={t.is_contiguous()}); expected {tuple(shape)} "
                f"{dtype} contiguous on {dev}")


def check(rc: int, name: str):
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = _load().extrack_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")
