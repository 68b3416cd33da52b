"""Track simulation with FOV geometry, bleaching and per-peak errors (host
numpy).

Functional equivalent of the reference simulator (extrack/simulate_tracks.py):
``sim_fov`` reproduces sim_FOV (:123-244): sub-stepped Brownian motion,
stroboscopic sampling, re-splitting of tracks at field-of-view exits, per-step
bleaching, chi-square distributed per-peak localization errors.  Everything is
vectorized NumPy driven by ``numpy.random.default_rng`` generators, so
10^5-10^6-track datasets simulate in seconds with no accelerator.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from extrack_tpu_torch.core.tables import stationary_fractions


def markov_states(rng: np.random.Generator, tr_mat: np.ndarray,
                  initial_fractions: np.ndarray, nb_tracks: int,
                  length: int) -> np.ndarray:
    """(nb_tracks, length) state chains, vectorized over tracks.

    Reference: markovian_process, simulate_tracks.py:11-22.
    """
    cum_rows = np.cumsum(tr_mat, axis=1).astype(np.float32)
    cum0 = np.cumsum(initial_fractions)
    S = tr_mat.shape[0]
    states = np.empty((nb_tracks, length), dtype=np.int8)
    u = rng.random((nb_tracks, length), dtype=np.float32)
    states[:, 0] = np.searchsorted(cum0, u[:, 0], side="right").clip(
        0, len(cum0) - 1)
    for k in range(1, length):
        rows = cum_rows[states[:, k - 1]]
        states[:, k] = np.clip(
            (u[:, k, None] > rows).sum(axis=1, dtype=np.int8), 0, S - 1)
    return states


def _sub_transition(tr_mat: np.ndarray, nb_sub_steps: int) -> np.ndarray:
    sub = np.array(tr_mat, dtype=np.float64) / nb_sub_steps
    np.fill_diagonal(sub, 0.0)
    np.fill_diagonal(sub, 1.0 - sub.sum(axis=1))
    return sub


def _merge_dicts(parts):
    """Concatenate a list of (tracks, states, sigmas) dict triples."""
    out = ({}, {}, {})
    keys = sorted({k for p in parts for k in p[0]}, key=int)
    for k in keys:
        for j in range(3):
            out[j][k] = np.concatenate([p[j][k] for p in parts if k in p[0]])
    return out


def sim_fov(nb_tracks: int = 10000,
            max_track_len: int = 40,
            min_track_len: int = 2,
            LocErr=0.02,
            Ds=(0.0, 0.05),
            nb_dims: int = 2,
            initial_fractions=None,
            TrMat=None,
            LocErr_std: float = 0.0,
            dt: float = 0.02,
            pBL: float = 0.1,
            cell_dims: Sequence[Optional[float]] = (0.5, None, None),
            nb_sub_steps: int = 20,
            seed: Optional[int] = None,
            verbose: bool = False,
            max_chunk_tracks: int = 200_000):
    """Simulate tracks that enter/leave a bounded FOV and photobleach.

    Reference: sim_FOV, simulate_tracks.py:123-244.  Returns (tracks, states,
    sigmas) dicts keyed by track length; sigmas are the per-peak localization
    error stds actually applied (chi-square distributed around LocErr when
    LocErr_std > 0, simulate_tracks.py:207-209).  Datasets beyond
    ``max_chunk_tracks`` simulate in memory-bounded chunks.
    """
    if nb_tracks > max_chunk_tracks:
        seeds = np.random.SeedSequence(seed).spawn(
            int(np.ceil(nb_tracks / max_chunk_tracks)))
        parts = []
        left = nb_tracks
        for ss in seeds:
            n = min(max_chunk_tracks, left)
            left -= n
            parts.append(sim_fov(
                nb_tracks=n, max_track_len=max_track_len,
                min_track_len=min_track_len, LocErr=LocErr, Ds=Ds,
                nb_dims=nb_dims, initial_fractions=initial_fractions,
                TrMat=TrMat, LocErr_std=LocErr_std, dt=dt, pBL=pBL,
                cell_dims=cell_dims, nb_sub_steps=nb_sub_steps,
                seed=np.random.default_rng(ss).integers(2 ** 31),
                verbose=False, max_chunk_tracks=max_chunk_tracks))
        out = _merge_dicts(parts)
        if verbose:
            print("number of tracks:", ", ".join(
                f"{k} pos: {len(v)}" for k, v in sorted(
                    out[0].items(), key=lambda kv: int(kv[0]))))
        return out
    rng = np.random.default_rng(seed)
    Ds = np.asarray(Ds, dtype=np.float64)
    TrMat = np.asarray(TrMat if TrMat is not None
                       else [[0.9, 0.1], [0.1, 0.9]], dtype=np.float64)
    S = TrMat.shape[0]
    if initial_fractions is None:
        initial_fractions = stationary_fractions(TrMat)
    LocErr = np.broadcast_to(np.asarray(LocErr, dtype=np.float64), (3,))
    # unbounded axes may be left out: (0.5,) means (0.5, None, None)
    cell_dims = tuple(cell_dims) + (None,) * (3 - len(cell_dims))
    cell = np.array([np.inf if c is None else float(c) for c in cell_dims])
    bounded = np.isfinite(cell)
    # the reference multiplies the track budget by 2 per bounded axis to
    # compensate for FOV losses (simulate_tracks.py:172)
    n_total = int(nb_tracks * 2 ** bounded.sum())

    sub = _sub_transition(TrMat, nb_sub_steps)
    sub_dt = dt / nb_sub_steps
    T = max_track_len
    L = T * nb_sub_steps

    # --- all Brownian paths at once (frame-resolution positions) ----------
    states_sub = markov_states(rng, sub, initial_fractions, n_total, L)
    # displacement j-1 -> j is governed by the state at sub-step j-1
    # (simulate_tracks.py:182); float32 throughout — simulation noise
    # dwarfs rounding
    gov = np.concatenate([states_sub[:, :1], states_sub[:, :-1]], axis=1)
    steps = rng.standard_normal((n_total, L, 3), dtype=np.float32)
    steps *= np.sqrt(2.0 * Ds * sub_dt).astype(np.float32)[gov][..., None]
    start = (rng.random((n_total, 1, 3)) * 2 * np.where(bounded, cell, 1.0)
             - np.where(bounded, cell, 1.0)).astype(np.float32)
    steps[:, 0] = 0.0
    pos = np.cumsum(steps, axis=1, dtype=np.float32) + start
    frame_idx = np.arange(0, L, nb_sub_steps)
    pos = pos[:, frame_idx]                       # (N, T, 3)
    states = states_sub[:, frame_idx]             # (N, T)

    # --- FOV membership and maximal in-FOV runs (vectorized) --------------
    in_fov = np.ones((n_total, T), dtype=bool)
    for ax in range(3):
        if bounded[ax]:
            in_fov &= (pos[:, :, ax] > 0) & (pos[:, :, ax] < cell[ax])
    padded = np.zeros((n_total, T + 2), dtype=bool)
    padded[:, 1:-1] = in_fov
    d = np.diff(padded.astype(np.int8), axis=1)
    run_track, run_start = np.nonzero(d == 1)
    _, run_end = np.nonzero(d == -1)              # same count, aligned
    run_len = run_end - run_start

    # --- bleaching: truncate each run at its first bleach event -----------
    if pBL > 0:
        u = rng.random((len(run_len), T))
        bleach_draw = (u < pBL) & (np.arange(T)[None, :] < run_len[:, None])
        any_bl = bleach_draw.any(axis=1)
        first_bl = np.argmax(bleach_draw, axis=1)
        run_len = np.where(any_bl, np.minimum(first_bl + 1, run_len), run_len)
        # once bleached, the particle is gone: drop this run's remainder AND
        # any later FOV re-entries of the same particle
        # (simulate_tracks.py:200-205 sets inFOV=[False] after a bleach)
        cum_excl = np.cumsum(any_bl) - any_bl
        _, grp_start, grp_cnt = np.unique(run_track, return_index=True,
                                          return_counts=True)
        base = np.repeat(cum_excl[grp_start], grp_cnt)
        prior_bleach = cum_excl - base
        run_len = np.where(prior_bleach > 0, 0, run_len)
    keep = run_len >= min_track_len
    run_track, run_start, run_len = (run_track[keep], run_start[keep],
                                     run_len[keep])

    # --- per-peak sigmas and measurement noise (vectorized per length) ----
    if len(run_len) == 0:
        raise ValueError("no tracks survived the FOV/bleaching filters")
    k_chi = 2.0 / (LocErr_std ** 2 + 1e-20)
    out_c: Dict[str, np.ndarray] = {}
    out_b: Dict[str, np.ndarray] = {}
    out_s: Dict[str, np.ndarray] = {}
    if verbose:
        uniq, cnt = np.unique(run_len, return_counts=True)
        print("number of tracks:",
              ", ".join(f"{u} pos: {c}" for u, c in zip(uniq, cnt)))
    for L in np.unique(run_len):
        sel = run_len == L
        rows = run_start[sel][:, None] + np.arange(L)[None, :]
        trk = run_track[sel][:, None]
        p = pos[trk, rows]                       # (n, L, 3)
        st = states[trk, rows]                   # (n, L)
        if LocErr_std > 0:
            sigma = (rng.chisquare(k_chi, p.shape).astype(np.float32)
                     * (LocErr / k_chi).astype(np.float32))
        else:
            sigma = np.broadcast_to(LocErr.astype(np.float32), p.shape)
        noisy = p + rng.standard_normal(p.shape, dtype=np.float32) * sigma
        key = str(int(L))
        out_c[key] = noisy[:, :, :nb_dims]
        out_b[key] = st
        out_s[key] = sigma[:, :, :nb_dims]
    return out_c, out_b, out_s


# the reference's name (extrack/simulate_tracks.py:123)
sim_FOV = sim_fov
