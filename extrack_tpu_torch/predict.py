"""Per-position state posterior annotation.

Equivalent of the reference predict_Bs (extrack/tracking.py:792-906): runs
the likelihood walk with posterior accumulation and returns, per track, the
probability of each localization being in each state.  On CUDA every batch
runs the posterior kernel K4 (ops/predict_kernel); CPU tensors run the plain
engine.  ``predict_Bs`` length-buckets the dataset so short tracks do not
pay the longest track's steps; the output does not depend on the buckets.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from extrack_tpu_torch import data as tdata
from extrack_tpu_torch import device as tdevice
from extrack_tpu_torch import params as tparams
from extrack_tpu_torch.core import tables
from extrack_tpu_torch.ops import forward_kernel, predict_kernel
from extrack_tpu_torch.parallel import mesh as pmesh


def tables_from_values(values, loc_err_in, dt_arr, *, nb_states, cell_dims,
                       device, dtype, matrix_type=1, nb_substeps=1,
                       dt_repr=None) -> tables.ModelTables:
    """Parameter extraction and table build on ``device`` in ``dtype``:
    ``values`` is the resolved parameter dict, ``loc_err_in`` the per-peak
    error batch or None, ``dt_repr`` the survival tables' representative
    dt (None: the median of ``dt_arr``)."""
    Ds, Fs, rates, loc_err, pBL = tparams.extract_arrays(
        values, nb_states, input_loc_err=loc_err_in, device=device,
        dtype=dtype)
    return tables.build_tables(Ds, loc_err, Fs, rates, pBL, dt_arr,
                               cell_dims=cell_dims, nb_substeps=nb_substeps,
                               matrix_type=matrix_type, dt_repr=dt_repr)


def forward_from_values(values, positions, lengths, is_bleached,
                        loc_err_in, dt_arr, *, nb_states, cell_dims,
                        window, min_len, matrix_type=1, nb_substeps=1,
                        return_preds=True, dt_repr=None):
    """Parameter extraction, table build and the walk in one call, on the
    device and in the dtype of ``positions`` (``tables_from_values``).
    Returns ``(logl, preds)`` with ``return_preds`` (one sub-step only),
    else ``logl``."""
    tb = tables_from_values(values, loc_err_in, dt_arr, nb_states=nb_states,
                            cell_dims=cell_dims, device=positions.device,
                            dtype=positions.dtype, matrix_type=matrix_type,
                            nb_substeps=nb_substeps, dt_repr=dt_repr)
    if return_preds:
        if nb_substeps != 1:
            raise ValueError("posteriors require nb_substeps == 1")
        return predict_kernel.predict(positions, lengths, is_bleached, tb,
                                      window=window, min_len=min_len)
    return forward_kernel.forward(positions, lengths, is_bleached, tb,
                                  window=window, nb_substeps=nb_substeps,
                                  min_len=min_len)


def predict_batch(batch: tdata.TrackBatch,
                  spec_or_values,
                  dt,
                  nb_states: int,
                  cell_dims=(1.0,),
                  window: int = 5,
                  min_len: Optional[int] = None,
                  matrix_type: int = 1,
                  input_loc_err: bool = False,
                  chunk_size: int = 16384,
                  compute_engine: str = "auto",
                  sharded=False):
    """(logl (B,), preds (B, T, S)) for a TrackBatch, on its device.

    The plain engine carries K*(T+W)*S history floats per track, so CPU
    batches run in ``chunk_size`` chunks; K4 keeps the history on chip
    and takes a CUDA batch in one launch.  ``compute_engine``: 'auto' or
    'pallas' run K4 on a CUDA batch, 'xla' raises there; a CPU batch runs
    the plain engine whatever the value.

    ``sharded`` (True, or a ``parallel.mesh.Mesh``) splits the tracks
    over the mesh's shards: K4 on each CUDA shard
    (``mesh.sharded_posteriors``; the tables built once for the batch), the
    outputs in the batch's order.  With a process group each process runs
    its part and every process gets the whole result.
    """
    tdevice.check_compute_engine(compute_engine, batch.positions.device,
                                  "predict_batch")
    return _predict_batch(batch, spec_or_values, dt, nb_states,
                          cell_dims=cell_dims, window=window,
                          min_len=min_len, matrix_type=matrix_type,
                          input_loc_err=input_loc_err, chunk_size=chunk_size,
                          sharded=sharded)


def _predict_batch(batch: tdata.TrackBatch, spec_or_values, dt,
                   nb_states: int, *, cell_dims, window: int,
                   min_len: Optional[int], input_loc_err: bool,
                   matrix_type: int = 1, chunk_size: int = 16384,
                   dt_repr: Optional[float] = None, sharded=False):
    """``predict_batch`` after its checks, with the survival tables'
    representative dt ``dt_repr`` (None: each chunk's own)."""
    values = (spec_or_values.resolve()
              if isinstance(spec_or_values, tparams.Parameters)
              else spec_or_values)
    if min_len is None:
        min_len = tdata.default_min_len(tdata.host_lengths(batch))
    dt_arr = batch.dt if batch.dt is not None else dt
    if sharded:
        mesh = pmesh.mesh_for(sharded, batch.positions.device)
        tb = tables_from_values(
            values, batch.loc_err if input_loc_err else None, dt_arr,
            nb_states=nb_states, cell_dims=tuple(cell_dims),
            device=batch.positions.device, dtype=batch.positions.dtype,
            matrix_type=matrix_type, dt_repr=dt_repr)
        return pmesh.sharded_posteriors(batch, tb, window=window,
                                        min_len=min_len, mesh=mesh)
    B = batch.batch_size
    step = max(1, B if batch.positions.device.type == "cuda"
               else chunk_size)

    def rows(x, sl):
        return x[sl] if isinstance(x, torch.Tensor) and x.ndim > 1 else x

    logls, preds = [], []
    for start in range(0, max(B, 1), step):
        sl = slice(start, start + step)
        lg, pr = forward_from_values(
            values, batch.positions[sl], batch.lengths[sl],
            batch.is_bleached[sl],
            batch.loc_err[sl] if input_loc_err else None, rows(dt_arr, sl),
            nb_states=nb_states, cell_dims=tuple(cell_dims), window=window,
            min_len=min_len, matrix_type=matrix_type, dt_repr=dt_repr)
        logls.append(lg)
        preds.append(pr)
    return torch.cat(logls), torch.cat(preds)


def predict_Bs(all_tracks: Dict[str, np.ndarray],
               dt,
               params,
               cell_dims=(1.0,),
               nb_states: int = 2,
               frame_len: int = 5,
               max_nb_states: int = 200,
               threshold: float = 0.1,
               workers: int = 1,
               input_LocErr=None,
               verbose: int = 0,
               nb_max: int = 1,
               sharded=False,
               *,
               device="cuda",
               dtype=None) -> Dict[str, np.ndarray]:
    """Reference-compatible wrapper (extrack/tracking.py:792-906), on
    ``device`` (the card by default; ``device="cpu"`` runs the plain
    engine) in ``dtype`` (float32 on CUDA, where K4 computes, float64
    elsewhere).

    ``workers``/``nb_max``/``threshold``/``max_nb_states``/``verbose`` are
    accepted for API compatibility; the fixed window (``frame_len``)
    replaces threshold pruning.  Returns the length-keyed dict of (n, L, S)
    posteriors.  ``sharded`` as ``predict_batch``, bucket by bucket.
    """
    del max_nb_states, threshold, workers, verbose, nb_max
    device, dtype = tdevice.resolve_device(device, dtype)
    dts = dt if isinstance(dt, dict) else None
    batches = tdata.from_dict_bucketed(
        all_tracks, max_buckets=4, input_loc_err=input_LocErr, dt=dts,
        device=device, dtype=dtype)
    min_len = tdata.default_min_len(
        np.concatenate([tdata.host_lengths(b) for b in batches]))
    dt_repr = tdata.dt_median(all_tracks, dts)
    out: Dict[str, np.ndarray] = {}
    for b in batches:
        _, preds = _predict_batch(
            b, params, dt if dts is None else 0.0, nb_states,
            cell_dims=cell_dims, window=frame_len, min_len=min_len,
            input_loc_err=input_LocErr is not None, dt_repr=dt_repr,
            sharded=sharded)
        out.update(tdata.to_dict(b, preds))
    return out
