"""Precomputed model tables for the likelihood engine (PyTorch).

Everything that depends only on (parameters, dt, geometry) and not on the
track data is folded into small dense tables outside the time loop:

* per-substep transition matrix with the reference's five discretizations
  (``Matrix_type``, extrack/tracking.py:952-975),
* per-frame-step displacement variances for every pattern of ``nb_substeps+1``
  hidden sub-states (extrack/tracking.py:495-506),
* FOV survival probabilities integrated on a 1000-point grid
  (extrack/tracking.py:518-524),
* the bleaching / leaving-FOV end term folded over one extra hidden transition
  (extrack/tracking.py:613-631).

Every function is differentiable with torch autograd w.r.t. the physical
parameters, so the whole fit objective admits ``backward()``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

_EPS_D = 1e-200
LOG_FLOOR = -1e15


def state_codes(nb_states: int, width: int) -> np.ndarray:
    """(S**width, width) matrix of all state sequences, newest state first.

    Equivalent information to the reference's ``get_all_Bs``
    (extrack/tracking.py:746-757), as a static numpy constant.
    """
    k = np.arange(nb_states ** width)
    pows = nb_states ** np.arange(width - 1, -1, -1)
    return (k[:, None] // pows[None, :]) % nb_states


def transition_matrix(rates: torch.Tensor, nb_substeps: int = 1,
                      matrix_type: int = 1) -> torch.Tensor:
    """Per-substep transition probability matrix from an (S, S) rate matrix
    (off-diagonal rates per frame; the diagonal is ignored).  Mirrors
    extract_params' ``Matrix_type`` variants (extrack/tracking.py:952-975):
    0 linear, 1 ``1-exp(-r)`` (default), 2 matrix exponential, 3 arithmetic
    and 4 geometric blends of 0 and 2."""
    S = rates.shape[0]
    eye = torch.eye(S, dtype=rates.dtype, device=rates.device)
    off = rates * (1.0 - eye) / nb_substeps

    def _linear(m):
        return m + eye * (1.0 - m.sum(dim=1, keepdim=True))

    if matrix_type == 0:
        return _linear(off)
    if matrix_type == 1:
        return _linear(1.0 - torch.exp(-off))
    generator = off - eye * off.sum(dim=1, keepdim=True)
    expm = torch.linalg.matrix_exp(generator)
    if matrix_type == 2:
        return expm
    lin = _linear(off)
    if matrix_type == 3:
        return 0.5 * (lin + expm)
    if matrix_type == 4:
        return torch.sqrt(lin * expm)
    raise ValueError(f"unknown matrix_type {matrix_type}")


def stationary_fractions(tr_mat) -> np.ndarray:
    """Stationary distribution of a transition matrix via eigen
    decomposition (host numpy; used by the simulator)."""
    tr = np.asarray(tr_mat, dtype=np.float64)
    vals, vecs = np.linalg.eig(tr.T)
    idx = int(np.argmin(np.abs(vals - 1.0)))
    pi = np.abs(np.real(vecs[:, idx]))
    return pi / pi.sum()


def displacement_var(d2: torch.Tensor, nb_substeps: int) -> torch.Tensor:
    """Per-pattern displacement variance for one frame step.

    ``d2``: (..., S) squared diffusion step length 2*D*dt per state.
    Returns (..., S**(nb_substeps+1)), pattern digits newest sub-state
    first; a transition sits at the middle of each sub-step, so the
    variance is the mean of adjacent-pair averages
    (extrack/tracking.py:500-506)."""
    S = d2.shape[-1]
    n = nb_substeps
    codes = state_codes(S, n + 1)
    w = np.zeros((S ** (n + 1), S))
    for j in range(n + 1):
        scale = 0.5 if (j == 0 or j == n) else 1.0
        np.add.at(w, (np.arange(S ** (n + 1)), codes[:, j]), scale / n)
    return d2 @ torch.as_tensor(w.T, dtype=d2.dtype, device=d2.device)


def fov_stay_prob(sub_d: torch.Tensor, cell_dims: Sequence[float],
                  grid_size: int = 1000) -> torch.Tensor:
    """Probability of staying inside the field of view for one frame step:
    for each bounded cell dimension L, the mean of Phi((L-x)/d) - Phi(-x/d)
    over a uniform grid of x in (0, L) (extrack/tracking.py:518-524)."""
    p = torch.ones_like(sub_d)
    for L in cell_dims:
        if L is None:
            continue
        xs = torch.linspace(L / (2 * grid_size), L - L / (2 * grid_size),
                            grid_size, dtype=sub_d.dtype,
                            device=sub_d.device)
        d = sub_d[..., None] + _EPS_D
        cur = (torch.special.ndtr((L - xs) / d)
               - torch.special.ndtr(-xs / d)).mean(dim=-1)
        p = p * cur
    return p


class ModelTables(NamedTuple):
    """Everything the engine needs besides the track data.

    Shapes use S states, n sub-steps, A = S**n, P = S**(n+1), and Tm1 frame
    steps (or 1 when dt is constant; rows broadcast).
    """
    log_trans: torch.Tensor       # (S, S) per-substep log transition probs
    log_frac: torch.Tensor        # (S,) initial state log fractions
    sig2: torch.Tensor            # (Tm1|1, P) or (B, Tm1, P) variances
    log_survive: torch.Tensor     # (A,) log(p_stay * (1 - pBL))
    end_ll: torch.Tensor          # (S,) folded end term per newest state
    loc_err2: torch.Tensor        # broadcastable to (B, T, D)

    @property
    def nb_states(self) -> int:
        return self.log_trans.shape[0]


def cap_log(p: torch.Tensor) -> torch.Tensor:
    """log(p) with log(0) floored at a finite -1e15.

    exp still underflows to exactly 0, but -inf would give NaN in the
    kernels' max-shifted sums (inf - inf) and in the engine's gated terms
    (0 * -inf).  Double-where, so the zero branch's 1/0 never reaches the
    gradient (a plain maximum(log(p), floor) backpropagates 0 * inf)."""
    pos = p > 0
    safe = torch.where(pos, p, torch.ones_like(p))
    return torch.where(pos, torch.log(safe),
                       torch.full_like(p, LOG_FLOOR))


def build_tables(Ds, loc_err, Fs, rates, pBL, dt,
                 cell_dims: Sequence[float] = (1.0,),
                 nb_substeps: int = 1,
                 matrix_type: int = 1,
                 dt_repr: Optional[float] = None) -> ModelTables:
    """Assemble ModelTables from physical parameters (all tensors of one
    dtype and device; Ds (S,), Fs (S,), rates (S, S), pBL scalar; loc_err
    scalar, (D,) or broadcastable to (B, T, D); dt scalar, (Tm1,) or
    (B, Tm1))."""
    dt = torch.as_tensor(dt, dtype=Ds.dtype, device=Ds.device)
    S = Ds.shape[0]
    n = nb_substeps

    tr = transition_matrix(rates, nb_substeps=n, matrix_type=matrix_type)
    log_trans = cap_log(tr)
    log_frac = cap_log(Fs)

    d2 = 2.0 * Ds * dt[..., None]                      # (..., S)
    if d2.ndim == 1:
        d2 = d2[None]
    sig2 = displacement_var(d2, n)                      # (..., P)

    # survival over the S**n patterns of new sub-states, at a
    # representative dt (the median, averaging the two middle values)
    if dt_repr is None:
        dt_r = torch.quantile(dt.flatten(), 0.5) if dt.ndim else dt
    else:
        dt_r = torch.as_tensor(dt_repr, dtype=Ds.dtype, device=Ds.device)
    d2_r = 2.0 * Ds * dt_r
    sub_codes = torch.as_tensor(state_codes(S, n), device=Ds.device)
    sub_d = torch.sqrt(d2_r[sub_codes].mean(dim=-1))
    p_stay = fov_stay_prob(sub_d, cell_dims)            # (A,)
    log_survive = cap_log(p_stay * (1.0 - pBL))

    # end term: one extra hidden extension of n sub-steps, folded per
    # newest state
    lt_branch = branch_log_trans(log_trans, n)          # (A, S)
    end_core = cap_log(pBL + (1.0 - p_stay) * (1.0 - pBL))
    end_ll = torch.logsumexp(lt_branch + end_core[:, None], dim=0)

    loc_err2 = torch.as_tensor(loc_err, dtype=Ds.dtype,
                               device=Ds.device) ** 2
    while loc_err2.ndim < 3:
        loc_err2 = loc_err2[None]
    return ModelTables(log_trans=log_trans, log_frac=log_frac, sig2=sig2,
                       log_survive=log_survive, end_ll=end_ll,
                       loc_err2=loc_err2)


def branch_log_trans(log_trans: torch.Tensor, nb_substeps: int
                     ) -> torch.Tensor:
    """(A, S): log prob of appending sub-state pattern ``a`` (digits newest
    first) after previous newest state ``s``: T[s, a_{n-1}] ... T[a_1, a_0]."""
    S = log_trans.shape[0]
    codes = state_codes(S, nb_substeps)
    out = log_trans.T[codes[:, -1]]
    for j in range(nb_substeps - 1):
        out = out + log_trans[codes[:, j + 1], codes[:, j]][:, None]
    return out


def init_log_prob(log_trans: torch.Tensor, log_frac: torch.Tensor,
                  nb_substeps: int) -> torch.Tensor:
    """(P,) log prob of the initial window of n+1 sub-states (newest
    first): log F[oldest] + transition chain."""
    S = log_trans.shape[0]
    codes = state_codes(S, nb_substeps + 1)
    out = log_frac[codes[:, -1]]
    for j in range(nb_substeps):
        out = out + log_trans[codes[:, j + 1], codes[:, j]]
    return out


def tables_from_numpy(arrays, device, dtype) -> ModelTables:
    """ModelTables from a mapping of field name -> array (for example the
    fields of a table built elsewhere), on ``device`` in ``dtype``."""
    return ModelTables(**{f: torch.as_tensor(np.array(arrays[f]),
                                             dtype=dtype, device=device)
                          for f in ModelTables._fields})
