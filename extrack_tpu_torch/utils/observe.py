"""Observability: fit metrics, structured logs, profiler traces, checkpoints.

* ``FitRecorder``: per-evaluation records (objective, parameters, wall
  time), optional JSONL sink, usable as the ``callback`` of ``fit.fit``;
* ``trace``: a context manager around ``torch.profiler`` that writes a
  Chrome trace (CPU and, on the card, CUDA activity) into ``log_dir``;
* ``CheckpointManager``: atomic JSON checkpoints of (parameters,
  objective, evaluation count) with resume; ``fit.fit`` saves on every
  improvement, so an interrupted fit warm-restarts from its best point.

The JSON formats are the JAX package's (``extrack_tpu/utils/observe.py``):
a checkpoint or a JSONL record written by either package reads in the
other.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class FitRecord:
    n_eval: int
    objective: float
    values: Dict[str, float]
    wall_time: float


def _scalars(values) -> Dict[str, float]:
    """The scalar entries of a parameter dict as floats (tensors, numpy
    scalars and floats alike)."""
    return {k: float(v) for k, v in values.items() if np.ndim(v) == 0}


class FitRecorder:
    """Collects per-evaluation fit metrics; optionally appends JSONL."""

    def __init__(self, jsonl_path: Optional[str] = None,
                 print_every: int = 0):
        self.records: List[FitRecord] = []
        self.jsonl_path = jsonl_path
        self.print_every = print_every
        self._t0 = time.perf_counter()

    def __call__(self, n_eval: int, objective: float,
                 values: Dict[str, float]):
        rec = FitRecord(n_eval, float(objective), _scalars(values),
                        time.perf_counter() - self._t0)
        self.records.append(rec)
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as fh:
                fh.write(json.dumps(dataclasses.asdict(rec)) + "\n")
        if self.print_every and n_eval % self.print_every == 0:
            print(f"[fit {n_eval:>4}] -logL={objective:.4f} "
                  f"t={rec.wall_time:.1f}s")

    @property
    def best(self) -> Optional[FitRecord]:
        return min(self.records, key=lambda r: r.objective, default=None)


@contextlib.contextmanager
def trace(log_dir: str = "extrack_tpu_torch_trace"):
    """Profile a region with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) and write its Chrome trace,
    ``trace.json``, into ``log_dir`` (open it in Perfetto or
    chrome://tracing).  Yields the profiler, whose ``key_averages()``
    summarises the region."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class CheckpointManager:
    """Atomic JSON checkpoints of fit state with resume."""

    def __init__(self, path: str):
        self.path = path

    def save(self, values: Dict[str, float], objective: float,
             n_eval: int, extra: Optional[dict] = None):
        payload = {"values": _scalars(values),
                   "objective": float(objective), "n_eval": int(n_eval),
                   "extra": extra or {}}
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt")
        with os.fdopen(fd, "w") as fh:
            json.dump(payload, fh)
        os.replace(tmp, self.path)

    def load(self) -> Optional[dict]:
        if not os.path.exists(self.path):
            return None
        with open(self.path) as fh:
            return json.load(fh)
