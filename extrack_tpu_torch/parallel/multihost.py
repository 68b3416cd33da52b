"""Several processes: each loads only its own slice of the tracks.

The reference's only parallelism is a single-host fork pool
(extrack/tracking.py:33-39).  Across processes (one per GPU, on one host
or several), every process loads ONLY its own slice of the dataset
(``process_slice``, ``split_paths``), builds its batch on its device and
calls ``global_batch``: the processes then agree on the row count and on
the dataset's lengths, and the fit's objective all-reduces value and
gradient once per evaluation.  Track data never crosses between
processes, only sums.

Rank and world size come from ``torch.distributed`` when a process group
is initialized (``init_process_group`` with its address, world size and
rank), and are 0 and 1 otherwise, so the same code runs in one process.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from extrack_tpu_torch import data as tdata
from extrack_tpu_torch.parallel.mesh import Mesh, make_mesh


def _rank_world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_mesh() -> Mesh:
    """The 1-D data mesh of the run: this process's device(s) and the
    process group."""
    return make_mesh()


def process_slice(n_items: int,
                  process_index: Optional[int] = None,
                  process_count: Optional[int] = None) -> slice:
    """The half-open range of dataset items this process should load.

    Balanced contiguous split; use it to subset file lists or row ranges
    BEFORE reading, so each process touches only its own bytes.
    """
    rank, world = _rank_world()
    pi = rank if process_index is None else process_index
    pc = world if process_count is None else process_count
    base, extra = divmod(n_items, pc)
    start = pi * base + min(pi, extra)
    return slice(start, start + base + (1 if pi < extra else 0))


def split_paths(paths: Sequence[str]) -> Sequence[str]:
    """Subset a file list to this process's share (read only your slice)."""
    return list(paths)[process_slice(len(paths))]


def _gather_host(x: np.ndarray, mesh: Mesh) -> list:
    """Every rank's host array (shapes may differ), in rank order."""
    out = [None] * mesh.world_size
    dist.all_gather_object(out, x, group=mesh.group)
    return out


def global_batch(local: tdata.TrackBatch,
                 mesh: Optional[Mesh] = None) -> tdata.TrackBatch:
    """This process's TrackBatch made one process's share of a batch
    spread over the group.

    ``local`` holds THIS process's tracks, padded to a time axis the
    processes share (``from_dict(..., max_len=..., data_max=...)``).  The
    result pads every process to the same local row count (an all-reduce
    MAX, rounded up to a multiple of this process's devices), sets
    ``np_lengths`` to the GLOBAL lengths (every process's padded rows, in
    rank order, gathered on the host) so that the closing gate ``min_len``
    is the same everywhere, and, with per-step dt, ``dt_repr`` to the
    median of every process's dt (the survival tables' representative dt
    of the global batch).  It is ``process_local``: the sharded drivers
    split its rows over this process's devices and sum over the group, so
    it goes directly to ``fit.make_objective(sharded=True)`` and
    ``mesh.sharded_log_likelihood``.
    """
    mesh = mesh or global_mesh()
    n_dev = len(mesh.devices)
    b = local.batch_size
    if mesh.group is not None:
        b = int(mesh.all_reduce(torch.tensor([b], dtype=torch.int64),
                                "max")[0])
    padded = local.pad_batch_to(max(1, -(-b // n_dev)) * n_dev)
    lens_local = padded.lengths.cpu().numpy()
    dt_repr = None
    if mesh.group is None:
        lens = lens_local
    else:
        lens = np.concatenate(_gather_host(lens_local, mesh))
        if padded.dt is not None:
            dts = _gather_host(padded.dt.cpu().numpy(), mesh)
            dt_repr = float(tdata.median(torch.as_tensor(
                np.concatenate([d.ravel() for d in dts]))))
    return padded._replace(np_lengths=lens, dt_repr=dt_repr,
                           process_local=True)
