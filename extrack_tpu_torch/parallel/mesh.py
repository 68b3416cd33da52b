"""Data parallelism over tracks: a 1-D mesh of devices and processes.

The reference parallelizes with a fork pool that maps chunks of tracks to
CPU workers and sums their log likelihoods on the host
(extrack/tracking.py:33-39, 1061-1069).  Here the tracks split into equal
shards over a ``data`` mesh: every shard runs the same kernel (K2 for the
objective, K4 for the posteriors, K5 for the histogram, K6 for the
refinement; the plain version on CPU tensors), scalars and histograms sum
over the shards, and per-track outputs come back in the caller's order.
Model tables are small and replicate, except the per-track leaves
(per-peak ``loc_err2`` (B, T, D), per-track-dt ``sig2`` (B, T-1, P)),
which split with the tracks.

The torch idiom is one process per GPU, so a mesh is ``(devices, group)``:
the devices this process drives, and the process group
(``torch.distributed``'s default group when one is initialized, else
None).  Its size is ``len(devices) x world_size``.  Across processes the
sums go through ``torch.distributed.all_reduce`` and per-track outputs
through an all-gather on the host (gloo gathers CPU tensors only; NCCL
gathers on the rank's GPU).  A batch of ``multihost.global_batch`` holds
only this process's rows (``process_local``): it splits over this
process's devices, and its per-track outputs stay this process's.  Any
other batch is taken as the same on every process, and each process runs
its part of it.

Launches run under a ``torch.cuda.device`` guard of their shard's device.
Several GPUs in one process follow the same code path, but only meshes of
one GPU per process have run on a card.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from extrack_tpu_torch import data as tdata
from extrack_tpu_torch.core.tables import ModelTables

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's shard devices and the process group (or None)."""
    devices: tuple
    group: Optional[object] = None

    @property
    def world_size(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def size(self) -> int:
        return len(self.devices) * self.world_size

    def comm_device(self) -> torch.device:
        """Where the collectives' tensors live: the rank's GPU for NCCL,
        the host for gloo."""
        if dist.get_backend(self.group) == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the group (itself without one), on its
        device, detached."""
        if self.group is None:
            return t.detach()
        x = t.detach().to(self.comm_device()).clone()
        dist.all_reduce(x, op=getattr(dist.ReduceOp, op.upper()),
                        group=self.group)
        return x.to(t.device)

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes) stacked along the first axis
        in rank order, on ``t``'s device."""
        if self.group is None:
            return t
        x = t.detach().to(self.comm_device()).contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world_size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts).to(t.device)


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A 1-D data mesh.  ``devices`` (names or ``torch.device``, repeats
    allowed: ``["cpu"] * 8`` gives eight shards on the CPU) default to the
    current CUDA device when a process group exists, to every visible CUDA
    device otherwise, and to one CPU shard where there is no card;
    ``n_devices`` keeps the first that many."""
    group = dist.group.WORLD if (dist.is_available()
                                 and dist.is_initialized()) else None
    if devices is None:
        if torch.cuda.is_available():
            devices = ([torch.cuda.current_device()] if group is not None
                       else list(range(torch.cuda.device_count())))
            devices = [torch.device("cuda", i) for i in devices]
        else:
            devices = ["cpu"]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"make_mesh: {n_devices} devices asked for, "
                             f"{len(devices)} given")
        devices = devices[:n_devices]
    return Mesh(tuple(devices), group)


def mesh_for(sharded, device) -> Mesh:
    """The mesh a driver's ``sharded`` argument names for a batch on
    ``device``: a Mesh as given; True the visible CUDA devices for a CUDA
    batch (``make_mesh``), one CPU shard for a CPU batch."""
    if isinstance(sharded, Mesh):
        return sharded
    if torch.device(device).type == "cpu":
        return make_mesh(devices=["cpu"])
    return make_mesh()


def launch_guard(dev: torch.device):
    """The launch guard of a shard: its CUDA device made current."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class ShardedBatch(tdata.TrackBatch):
    """A TrackBatch padded to a multiple of its shard count, with this
    process's shards.

    The padded rows (length 0) come last.  ``shards`` are TrackBatches on
    their devices, ``offsets`` their first rows in this batch,
    ``n_tracks`` the tracks before padding and ``mesh`` the mesh."""

    def __init__(self, padded: tdata.TrackBatch, shards, offsets,
                 n_tracks: int, mesh: Mesh):
        super().__init__(padded.positions, padded.lengths, padded.loc_err,
                         padded.is_bleached, padded.frames, padded.dt,
                         padded.np_lengths, dt_repr=padded.dt_repr,
                         process_local=padded.process_local)
        self.shards = shards
        self.offsets = offsets
        self.n_tracks = n_tracks
        self.mesh = mesh

    @property
    def shard_rows(self) -> int:
        return self.shards[0].batch_size

    def gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Per-shard per-track outputs as one tensor in the caller's track
        order, the padding dropped: this process's rows of a
        ``process_local`` batch, every process's rows otherwise."""
        out_dev = self.positions.device
        local = torch.cat([p.to(out_dev) for p in parts])
        if not self.process_local:
            local = self.mesh.all_gather_rows(local)
        return local[:self.n_tracks]


def _take(batch: tdata.TrackBatch, sl: slice, lens: np.ndarray,
          dev: torch.device, dt_repr) -> tdata.TrackBatch:
    def rows(x):
        return None if x is None else x[sl].to(dev)

    return tdata.TrackBatch(
        rows(batch.positions), rows(batch.lengths), rows(batch.loc_err),
        rows(batch.is_bleached), rows(batch.frames), rows(batch.dt),
        np_lengths=lens[sl], dt_repr=dt_repr,
        process_local=batch.process_local)


def shard_batch(batch: tdata.TrackBatch, mesh: Mesh) -> ShardedBatch:
    """Pad the batch to a multiple of the shard count and cut this
    process's shards, each moved to its device.

    A ``process_local`` batch splits over this process's devices; any
    other over the whole mesh, this process taking its contiguous part.
    Padded tracks have length 0 and contribute exactly zero, so sharding
    never changes results.  With per-step dt every shard keeps the
    batch's representative dt (its median, or ``dt_repr``), so its
    survival tables are the batch's."""
    if isinstance(batch, ShardedBatch) and batch.mesh == mesh:
        return batch
    n = len(mesh.devices) if batch.process_local else mesh.size
    b = batch.batch_size
    padded = batch.pad_batch_to(max(1, -(-b // n)) * n)
    m = padded.batch_size // n
    first = 0 if batch.process_local else mesh.rank * len(mesh.devices)
    lens = (padded.lengths.cpu().numpy() if batch.process_local
            else tdata.host_lengths(padded))
    dt_repr = padded.dt_repr
    if dt_repr is None and padded.dt is not None:
        dt_repr = float(tdata.median(padded.dt))
    offsets = [(first + i) * m for i in range(len(mesh.devices))]
    shards = [_take(padded, slice(o, o + m), lens, dev, dt_repr)
              for o, dev in zip(offsets, mesh.devices)]
    return ShardedBatch(padded, shards, offsets, b, mesh)


def per_track_leaf(x: torch.Tensor, n_tracks: int, n_rows: int) -> bool:
    """Whether a table leaf splits with the tracks: a (B, ., .) leaf of
    the batch's tracks, padded or not; every other leaf replicates."""
    return x.ndim == 3 and x.shape[0] in (n_tracks, n_rows)


def table_specs(tables: ModelTables, batch_size: int) -> ModelTables:
    """Per-leaf rule under a data mesh: ``DATA_AXIS`` for the leaves that
    split with the tracks (per-peak ``loc_err2``, per-track-dt ``sig2``),
    None for those that replicate."""
    return ModelTables(*(DATA_AXIS if per_track_leaf(x, batch_size,
                                                     batch_size) else None
                         for x in tables))


def _split_leaf(x: torch.Tensor, sb: ShardedBatch, i: int,
                dev: torch.device) -> torch.Tensor:
    """Shard ``i``'s rows of a per-track leaf, padded as the batch is."""
    rows = sb.batch_size
    if x.shape[0] < rows:
        x = torch.cat([x, x.new_ones((rows - x.shape[0],) + x.shape[1:])])
    return x[sb.offsets[i]:sb.offsets[i] + sb.shard_rows].to(dev)


def split_tables(tables: ModelTables, sb: ShardedBatch) -> List[ModelTables]:
    """One ModelTables per shard of ``sb``, on its device: per-track
    leaves cut with the shard's rows, the others copied (autograd flows
    through both)."""
    out = []
    for i, dev in enumerate(sb.mesh.devices):
        out.append(ModelTables(*(
            _split_leaf(x, sb, i, dev)
            if per_track_leaf(x, sb.n_tracks, sb.batch_size)
            else x.to(dev) for x in tables)))
    return out


def sharded_log_likelihood(batch: tdata.TrackBatch, tables: ModelTables,
                           *, window: int = 6, nb_substeps: int = 1,
                           min_len: int = 3,
                           mesh: Optional[Mesh] = None,
                           compute_engine: str = "xla",
                           has_len2: bool = True) -> torch.Tensor:
    """Total logL with the tracks sharded over ``mesh``, a sum over the
    shards and, across processes, an all-reduce.

    Each shard runs ``grad_kernel.neg_log_likelihood``: K2 on a CUDA shard
    when a gradient is taken, K1 for a value alone, the plain engine on a
    CPU one.  Without a process group the sum is differentiable as it
    stands.  With one, the value is the all-reduced total and autograd
    gives this process's share of the gradient: sum the gradients over
    the group, as ``fit.make_objective(sharded=True)`` does in the one
    all-reduce of each evaluation.  Without ``mesh`` it is the plain sum
    on the batch's device.  ``compute_engine`` and ``has_len2`` are
    accepted for compatibility: the wrappers choose by device, and the
    kernels find length-2 tracks themselves."""
    from extrack_tpu_torch.ops import grad_kernel
    del compute_engine, has_len2
    kw = dict(window=window, nb_substeps=nb_substeps, min_len=min_len)
    if mesh is None:
        return -grad_kernel.neg_log_likelihood(
            batch.positions, batch.lengths, batch.is_bleached, tables, **kw)
    sb = shard_batch(batch, mesh)
    out_dev = sb.positions.device
    total = 0.0
    for s, tb, dev in zip(sb.shards, split_tables(tables, sb), mesh.devices):
        with launch_guard(dev):
            nl = grad_kernel.neg_log_likelihood(
                s.positions, s.lengths, s.is_bleached, tb, **kw)
        total = total - nl.to(out_dev)
    if mesh.group is None:
        return total
    return _AllReduceSum.apply(total, mesh)


class _AllReduceSum(torch.autograd.Function):
    """All-reduce in the forward pass; this process's share of the
    gradient (the identity) in the backward pass."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sharded_posteriors(batch: tdata.TrackBatch, tables: ModelTables, *,
                       window: int = 5, min_len: int = 3, mesh: Mesh,
                       compute_engine: str = "xla"):
    """(logl (B,), preds (B, T, S)) with the tracks sharded over ``mesh``:
    K4 on each CUDA shard (``predict_kernel.predict``), the plain version
    on a CPU one; the caller's tracks in order, the padding dropped.
    ``compute_engine`` is accepted for compatibility."""
    from extrack_tpu_torch.ops import predict_kernel
    del compute_engine
    sb = shard_batch(batch, mesh)
    logls, preds = [], []
    for s, tb, dev in zip(sb.shards, split_tables(tables, sb), mesh.devices):
        with launch_guard(dev):
            lg, pr = predict_kernel.predict(s.positions, s.lengths,
                                            s.is_bleached, tb, window=window,
                                            min_len=min_len)
        logls.append(lg)
        preds.append(pr)
    return sb.gather(logls), sb.gather(preds)


def sharded_histogram(batch: tdata.TrackBatch, tables: ModelTables, *,
                      window: int = 7, min_len: int = 3, mesh: Mesh,
                      compute_engine: str = "xla", nb_substeps: int = 1):
    """(T, S) duration histogram: K5 on each CUDA shard
    (``hist_kernel.hist``; ``window`` counts sub-steps), the plain version
    on a CPU one, summed over the shards and all-reduced over the group
    (the reference reduces per-chunk histograms the same way,
    extrack/histograms.py:360-367).  ``compute_engine`` is accepted for
    compatibility."""
    from extrack_tpu_torch.ops import hist_kernel
    del compute_engine
    sb = shard_batch(batch, mesh)
    out_dev = sb.positions.device
    hist = None
    for s, tb, dev in zip(sb.shards, split_tables(tables, sb), mesh.devices):
        with launch_guard(dev):
            h = hist_kernel.hist(s.positions, s.lengths, s.is_bleached, tb,
                                 window=window, min_len=min_len,
                                 nb_substeps=nb_substeps).to(out_dev)
        hist = h if hist is None else hist + h
    return mesh.all_reduce(hist)


def sharded_refine(positions, lengths, loc_err2, log_trans, sig2_states, *,
                   window: int = 7, mesh: Mesh,
                   compute_engine: str = "xla", process_local: bool = False):
    """(mu (B,T,D), sigma (B,T,D)) with the tracks sharded over ``mesh``:
    K6 on each CUDA shard (``refine_kernel.refine``), the plain version on
    a CPU one.  ``loc_err2`` splits with the tracks when per-peak
    (B, T, D) and replicates otherwise.  ``process_local`` marks rows that
    are this process's share (their outputs stay this process's).
    ``compute_engine`` is accepted for compatibility."""
    from extrack_tpu_torch.ops import refine_kernel
    del compute_engine
    sb = shard_batch(tdata.TrackBatch(positions, lengths,
                                      process_local=process_local), mesh)
    per_peak = per_track_leaf(loc_err2, sb.n_tracks, sb.batch_size)
    mus, sigmas = [], []
    for i, (s, dev) in enumerate(zip(sb.shards, mesh.devices)):
        le2 = (_split_leaf(loc_err2, sb, i, dev) if per_peak
               else loc_err2.to(dev))
        with launch_guard(dev):
            mu, sg = refine_kernel.refine(
                s.positions, s.lengths, le2, log_trans.to(dev),
                sig2_states.to(dev), window=window,
                what=f"refinement shard of {s.batch_size} tracks on {dev}")
        mus.append(mu)
        sigmas.append(sg)
    return sb.gather(mus), sb.gather(sigmas)
