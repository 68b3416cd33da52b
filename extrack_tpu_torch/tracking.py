"""Reference-compatible namespace: the equivalents of extrack.tracking.

Users of the reference import everything from ``extrack.tracking``
(extrack/__init__.py:1); this module re-exports the port's equivalents and
adds the reference's own functions, so that moving a script over is a
one-line import change.  The engine-level functions live in
``extrack_tpu_torch.core``; the drivers in ``fit`` and ``predict``.
``Proba_Cs`` and ``cum_Proba_Cs`` run K1 on the card by default
(``device="cpu"`` runs the plain engine); the helpers take and return
numpy arrays, as the reference's do.
"""
from __future__ import annotations

import numpy as np
import torch

from extrack_tpu_torch import data as tdata
from extrack_tpu_torch import device as tdevice
from extrack_tpu_torch.core import gaussian as _gaussian
from extrack_tpu_torch.core.engine import (batch_log_likelihood,  # noqa: F401
                                           forward)
from extrack_tpu_torch.core.tables import (ModelTables,  # noqa: F401
                                           branch_log_trans, build_tables,
                                           cap_log, displacement_var,
                                           fov_stay_prob, state_codes,
                                           stationary_fractions,
                                           transition_matrix)
from extrack_tpu_torch.fit import fit, make_objective, param_fitting  # noqa
from extrack_tpu_torch.ops import forward_kernel
from extrack_tpu_torch.params import (Parameters,  # noqa: F401
                                      extract_arrays, generate_params,
                                      get_params)
from extrack_tpu_torch.predict import (forward_from_values,  # noqa: F401
                                       predict_Bs, predict_batch)


def Proba_Cs(Cs, LocErr, ds, Fs, TrMat, pBL, isBL, cell_dims, nb_substeps=1,
             frame_len=6, min_len=3, threshold=0.2, max_nb_states=120, *,
             device="cuda", dtype=None):
    """Per-track log likelihoods (B,) of a rectangular (B, T, D) track
    array from raw model arrays, on ``device`` (the card by default: one
    K1 launch, ``forward_kernel.forward``) in ``dtype``: the reference
    signature (extrack/tracking.py:769-787).  ``ds`` are per-state step
    stds sqrt(2*D*dt); ``TrMat`` is the per-sub-step transition
    probability matrix; ``LocErr`` a scalar, (D,) per dimension, or
    per-peak.  ``threshold``/``max_nb_states`` are accepted for
    compatibility (the fixed window replaces pruning)."""
    del threshold, max_nb_states
    device, dtype = tdevice.resolve_device(device, dtype)

    def tensor(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                               device=device)

    Cs = tensor(Cs)
    B, T, D = Cs.shape
    S = np.shape(TrMat)[0]
    d2 = tensor(ds) ** 2
    log_trans = cap_log(tensor(TrMat))
    sub_codes = torch.as_tensor(state_codes(S, nb_substeps), device=device)
    sub_d = torch.sqrt(d2[sub_codes].mean(dim=-1))
    p_stay = fov_stay_prob(sub_d, [c for c in cell_dims if c is not None])
    end_core = torch.log(pBL + (1.0 - p_stay) * (1.0 - pBL))
    # prepend axes up to (B|1, T|1, D|1): a (D,) error is per dimension
    le2 = tensor(LocErr) ** 2
    tb = ModelTables(
        log_trans=log_trans, log_frac=cap_log(tensor(Fs)),
        sig2=displacement_var(d2[None], nb_substeps),
        log_survive=cap_log(p_stay * (1.0 - pBL)),
        end_ll=torch.logsumexp(branch_log_trans(log_trans, nb_substeps)
                               + end_core[:, None], dim=0),
        loc_err2=le2.reshape((1,) * (3 - le2.ndim) + tuple(le2.shape)))
    lengths = torch.full((B,), T, dtype=torch.int32, device=device)
    isbl = torch.full((B,), float(isBL), dtype=dtype, device=device)
    return forward_kernel.forward(Cs, lengths, isbl, tb, window=frame_len,
                                  nb_substeps=nb_substeps, min_len=min_len)


_batch_cache: dict = {}


def clear_batch_cache():
    """Drop the cached TrackBatches of ``cum_Proba_Cs``.  Call after
    editing track arrays in place for a guaranteed rebuild."""
    _batch_cache.clear()


def _fingerprint(d):
    """Shape, dtype, head and tail bytes and a 256-element strided sample
    of every array of a length-keyed dict: O(1) a call, and it catches any
    bulk change (an edit of a few interior elements can collide)."""
    if not isinstance(d, dict):
        return None
    out = []
    for k in sorted(d):
        a = np.asarray(d[k])
        flat = a.ravel()
        sample = flat[::max(1, flat.size // 256)][:256]
        out.append((k, a.shape, str(a.dtype),
                    flat[:4].tobytes() if a.size else b"",
                    flat[-4:].tobytes() if a.size else b"",
                    sample.tobytes()))
    return tuple(out)


def _cached_from_dict(all_tracks, input_LocErr, dt, device, dtype):
    """The TrackBatch of a length-keyed dict on ``device``, built once for
    the same content (``cum_Proba_Cs`` is the reference's objective: a
    script calls it once per optimizer iteration on the same dataset, and
    the upload to the card is what the cache saves).  At most four
    batches are kept."""
    key = (_fingerprint(all_tracks), _fingerprint(input_LocErr),
           _fingerprint(dt), str(device), str(dtype))
    batch = _batch_cache.get(key)
    if batch is None:
        batch = tdata.from_dict(all_tracks, input_loc_err=input_LocErr,
                                dt=dt if isinstance(dt, dict) else None,
                                device=device, dtype=dtype)
        if len(_batch_cache) >= 4:
            _batch_cache.pop(next(iter(_batch_cache)))
        _batch_cache[key] = batch
    return batch


def cum_Proba_Cs(params, all_tracks, dt, cell_dims, input_LocErr, nb_states,
                 nb_substeps, frame_len, verbose=1, workers=1, Matrix_type=1,
                 threshold=0.2, max_nb_states=120,
                 max_number_of_tracks_per_matrix=2000, *, device="cuda",
                 dtype=None):
    """Negative total log likelihood over a dataset, on ``device`` (the
    card by default: one K1 launch over the cached batch) in ``dtype``:
    the reference signature (extrack/tracking.py:991-1088).  The chunking
    and pruning knobs are accepted for compatibility.  Parameter
    extraction, table build and walk are
    ``predict.forward_from_values``; the TrackBatch is cached across calls
    (``clear_batch_cache``).  Returns inf for negative fractions, as the
    reference's validity guard (tracking.py:1017)."""
    del workers, threshold, max_nb_states, max_number_of_tracks_per_matrix
    device, dtype = tdevice.resolve_device(device, dtype)
    batch = _cached_from_dict(all_tracks, input_LocErr, dt, device, dtype)
    values = (params.resolve() if isinstance(params, Parameters)
              else dict(params))
    fracs = [float(values[f"F{i}"]) for i in range(nb_states)
             if f"F{i}" in values]
    if fracs and min(fracs) < 0:
        if verbose:
            print("inf (invalid fractions)")
        return float("inf")
    lens = tdata.host_lengths(batch)
    logl = forward_from_values(
        values, batch.positions, batch.lengths, batch.is_bleached,
        batch.loc_err if input_LocErr is not None else None,
        batch.dt if batch.dt is not None else float(dt),
        nb_states=nb_states, cell_dims=tuple(cell_dims), window=frame_len,
        min_len=tdata.default_min_len(lens), matrix_type=Matrix_type,
        nb_substeps=nb_substeps, return_preds=False)
    out = -float(logl.double().cpu().numpy()[lens > 0].sum())
    if verbose:
        print(out)
    return out


def extract_params(params, dt, nb_states, nb_substeps, input_LocErr=None,
                   Matrix_type=1):
    """Resolve fit parameters into model arrays: the reference signature
    and return convention (extrack/tracking.py:913-986), ``(LocErr, ds,
    Fs, TrMat, pBL)`` as numpy, with ``ds = sqrt(2*D*dt)`` and ``TrMat``
    the sub-step transition-probability matrix of ``Matrix_type``.

    ``LocErr`` follows the reference's containers: a one-element list
    holding a (1, 1, S_err) array for fitted errors, or the per-peak input
    list (mapped through slope/offset where the parameters have them)
    when ``input_LocErr`` is given.  ``dt`` may be a scalar or a list of
    per-step (B, T-1) arrays.
    """
    values = (params.resolve() if isinstance(params, Parameters)
              else dict(params))
    # the scalar loc_err slot is unused with per-peak input (LocErr is
    # built from input_LocErr below): a dummy lets slope/offset-only
    # parameter sets resolve
    Ds, Fs, rates, _, pBL = extract_arrays(
        values, nb_states,
        input_loc_err=1.0 if input_LocErr is not None else None)
    TrMat = transition_matrix(rates, nb_substeps=nb_substeps,
                              matrix_type=Matrix_type).numpy()
    Ds, Fs, pBL = Ds.numpy(), Fs.numpy(), float(pBL)

    if input_LocErr is not None:
        per_peak = (list(input_LocErr.values())
                    if isinstance(input_LocErr, dict) else list(input_LocErr))
        if "slope_LocErr" in values:
            slope = float(values["slope_LocErr"])
            offset = float(values["offset_LocErr"])
            LocErr = [np.clip(np.asarray(v) * slope + offset, 1e-6, np.inf)
                      for v in per_peak]
        else:
            LocErr = per_peak
    else:
        names = sorted(k for k in values if k.startswith("LocErr"))
        LocErr = [np.array([float(values[k]) for k in names])[None, None]]

    if isinstance(dt, list):
        ds = [np.sqrt(2 * Ds[None, None] * np.asarray(t)[:, :, None])
              for t in dt]
    else:
        ds = np.sqrt(2 * Ds * dt)
    return LocErr, ds, Fs, TrMat, pBL


def get_all_Bs(nb_Cs, nb_states):
    """All state sequences of length ``nb_Cs`` as an integer matrix,
    (nb_states**nb_Cs, nb_Cs), least-significant position first: the
    reference's layout (extrack/tracking.py:746-757)."""
    ids = np.arange(nb_states ** nb_Cs)
    return (ids[:, None] // nb_states ** np.arange(nb_Cs)) % nb_states


def get_Ts_from_Bs(all_Bs, TrMat):
    """Log transition probability of each sequence under ``TrMat``: the
    reference signature (extrack/tracking.py:759-767); ``all_Bs`` may
    carry any leading batch axes."""
    all_Bs = np.asarray(all_Bs)
    lt = np.log(np.asarray(TrMat))
    return lt[all_Bs[..., :-1], all_Bs[..., 1:]].sum(axis=-1)


def ds_froms_states(ds, cur_states):
    """Per-step displacement std**2 of state sequences: consecutive
    sub-step variances averaged (a transition sits mid-step), then averaged
    over the sequence axis (extrack/tracking.py:58-65).  Returns (..., 1),
    the reference's trailing spatial axis."""
    d2 = np.asarray(ds)[np.asarray(cur_states)] ** 2
    d2 = (d2[..., 1:] + d2[..., :-1]) / 2.0
    return d2.mean(axis=-1)[..., None]


def _tensor(a):
    return (a if isinstance(a, torch.Tensor)
            else torch.as_tensor(np.asarray(a, dtype=np.float64)))


def log_integrale_dif(Ci, l2, cur_d2s, m_arr, s2_arr):
    """One Gaussian-marginalization step: the reference signature
    (extrack/tracking.py:76-98), ``core.gaussian.propagate``; returns
    (new_m, new_s2, log_const) tensors, the constant summed over the
    trailing spatial axis."""
    return _gaussian.propagate(*map(_tensor, (Ci, l2, cur_d2s, m_arr,
                                              s2_arr)))


def first_log_integrale_dif(Ci, l2, cur_d2s):
    """First-step convolution under a flat prior: the reference signature
    (extrack/tracking.py:101-107), ``core.gaussian.first_convolve``;
    returns (m_arr, s2_arr) tensors."""
    return _gaussian.first_convolve(*map(_tensor, (Ci, l2, cur_d2s)))
