"""Track simulation with FOV geometry, bleaching and per-peak errors.

Functional equivalent of the reference simulator (extrack/simulate_tracks.py):
``sim_fov`` reproduces sim_FOV (:123-244): sub-stepped Brownian motion,
stroboscopic sampling, re-splitting of tracks at field-of-view exits, per-step
bleaching, chi-square distributed per-peak localization errors; ``sim_nobias``
reproduces sim_noBias (:56-111).  Both are vectorized NumPy driven by
``numpy.random.default_rng`` generators, so 10^5-10^6-track datasets simulate
in seconds with no accelerator, and a seed gives the JAX package's draws bit
for bit.

``sim_fov_batch`` is the same model in torch on a device (the card by
default), drawing from a ``torch.Generator``: it returns length-bucketed
``TrackBatch``es that never leave the device, for 10^6-track datasets.
``brownian_frames`` generates fixed-length tracks there for benchmarks.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from extrack_tpu_torch import data as tdata
from extrack_tpu_torch import device as tdevice
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


def sim_nobias(track_lengths: Sequence[int] = (7, 8, 9, 10, 11),
               track_nb_dist: Sequence[int] = (1000, 800, 700, 600, 550),
               LocErr: float = 0.02,
               Ds: Sequence[float] = (0.0, 0.05),
               TrMat=None,
               initial_fractions=None,
               dt: float = 0.02,
               nb_dims: int = 2,
               nb_sub_steps: int = 30,
               seed: Optional[int] = None):
    """Fixed-length tracks, no FOV / bleaching bias.

    Reference: sim_noBias, simulate_tracks.py:56-111.  Returns (tracks,
    states) dicts keyed by track length.
    """
    rng = np.random.default_rng(seed)
    Ds = np.asarray(Ds, dtype=np.float64)
    TrMat = np.asarray(TrMat if TrMat is not None
                       else [[0.9, 0.1], [0.2, 0.8]], dtype=np.float64)
    if initial_fractions is None:
        initial_fractions = stationary_fractions(TrMat)
    sub = _sub_transition(TrMat, nb_sub_steps)
    sub_dt = dt / nb_sub_steps

    all_cs, all_bs = {}, {}
    for n_tracks, t_len in zip(track_nb_dist, track_lengths):
        L = (t_len - 1) * nb_sub_steps + 1
        states = markov_states(rng, sub, initial_fractions, n_tracks, L)
        steps = rng.normal(size=(n_tracks, L, nb_dims)) * np.sqrt(
            2.0 * Ds * sub_dt)[states][..., None]
        pos = np.cumsum(steps, axis=1)
        pos += rng.normal(0, LocErr, pos.shape)
        frame_idx = np.arange(0, L, nb_sub_steps)
        all_cs[str(t_len)] = pos[:, frame_idx]
        all_bs[str(t_len)] = states[:, frame_idx]
    return all_cs, all_bs


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


# ---------------------------------------------------------------------------
# On-device simulation (torch)
# ---------------------------------------------------------------------------

def _gamma(generator, a: float, n: int, device) -> torch.Tensor:
    """(n,) float64 Gamma(a, 1) draws from ``generator``, by Marsaglia and
    Tsang's squeeze-free rejection (ACM TOMS 26, 2000), with the
    U^(1/a) boost below a = 1.  torch's own gamma sampler takes no
    generator."""
    f64 = dict(dtype=torch.float64, device=device)
    a1 = a + 1.0 if a < 1.0 else a
    d = a1 - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.empty(n, **f64)
    todo = torch.arange(n, device=device)
    while todo.numel():
        x = torch.randn(todo.numel(), generator=generator, **f64)
        u = torch.rand(todo.numel(), generator=generator, **f64)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp(min=1e-300)))
        out[todo[ok]] = d * v[ok]
        todo = todo[~ok]
    if a < 1.0:
        out *= torch.rand(n, generator=generator, **f64) ** (1.0 / a)
    return out


def _sim_fov_chunk(generator, n, T, nsub, R, min_len, d2sub, cum_tr,
                   cum_frac, cell, loc_err, loc_err_std, pBL, bounded,
                   nb_dims=3):
    """One simulation chunk on ``d2sub``'s device: n particles -> n*R
    padded runs.

    Device equivalent of the host path in :func:`sim_fov` (itself
    mirroring sim_FOV, simulate_tracks.py:123-244).  Sub-state transitions
    run at sub-step resolution in a loop over frames; FOV membership and
    bleaching act at frame resolution (as in the host version); each
    particle's first R maximal in-FOV runs become fixed-shape output rows
    (length 0 when absent).

    Returns (positions (n*R, T*nb_dims), states (n*R, T) int8, sigmas
    (n*R, T*nb_dims) or None when loc_err_std == 0, lengths (n*R,)
    int32), float32.  Only the ``nb_dims`` observed axes get sigmas and
    noise, and no constant-sigma array is made, so a chunk's memory stays
    bounded.
    """
    dev = d2sub.device
    f32 = dict(dtype=torch.float32, device=dev)
    S = cum_tr.shape[0]

    def rand(*shape):
        return torch.rand(shape, generator=generator, **f32)

    def randn(*shape):
        return torch.randn(shape, generator=generator, **f32)

    # --- sub-stepped Markov chain, emitted at frame resolution -------------
    s = (rand(n)[:, None] > cum_frac[None, :]).sum(1).clamp_(max=S - 1)
    states = torch.empty((n, T), dtype=torch.int8, device=dev)
    states[:, 0] = s
    var = torch.empty((n, T - 1), **f32)
    for t in range(T - 1):
        u = rand(nsub, n)
        v = torch.zeros(n, **f32)
        for j in range(nsub):
            # displacement into sub-step j+1 is governed by the state at j
            # (simulate_tracks.py:182)
            v += d2sub[s]
            s = (u[j][:, None] > cum_tr[s]).sum(1).clamp_(max=S - 1)
        var[:, t] = v
        states[:, t + 1] = s

    # --- frame positions ----------------------------------------------------
    bcell = torch.tensor([c if b else 1.0 for c, b in zip(cell, bounded)],
                         **f32)
    start = (rand(n, 3) * 2.0 - 1.0) * bcell
    disp = randn(n, T - 1, 3) * var.sqrt_()[..., None]
    r = torch.cat([torch.zeros((n, 1, 3), **f32), disp.cumsum(1)], dim=1)
    r += start[:, None]
    del disp, var

    # --- FOV membership + bleach truncation (frame resolution) -------------
    t_idx = torch.arange(T, device=dev)
    fov = torch.ones((n, T), dtype=torch.bool, device=dev)
    for ax in range(3):
        if bounded[ax]:
            fov &= (r[:, :, ax] > 0) & (r[:, :, ax] < cell[ax])
    if pBL > 0:
        event = (rand(n, T) < pBL) & fov
        # the bleached frame itself is still observed (run_len =
        # first_bl + 1 in the host path); everything after it is gone
        cutoff = torch.where(event, t_idx, T - 1).amin(1)
        fov &= t_idx[None, :] <= cutoff[:, None]

    # --- run decomposition, fixed cap of R runs per particle ---------------
    prev = torch.cat([torch.zeros((n, 1), dtype=torch.bool, device=dev),
                      fov[:, :-1]], dim=1)
    is_start = fov & ~prev
    run_id = is_start.cumsum(1) - 1
    starts, lens = [], []
    for rr in range(R):
        ln = (fov & (run_id == rr)).sum(1)
        starts.append(torch.where(is_start & (run_id == rr), t_idx,
                                  T - 1).amin(1))
        lens.append(torch.where(ln >= min_len, ln, 0))
    starts = torch.stack(starts, dim=1)                       # (n, R)
    lens = torch.stack(lens, dim=1).to(torch.int32)           # (n, R)
    del prev, is_start, run_id, fov

    # --- per-peak errors + measurement noise at particle level -------------
    # (runs never overlap, so per-particle-frame draws are identical in
    # distribution to the host's per-run-peak draws)
    shape = (n, T, nb_dims)
    if loc_err_std > 0:
        k_chi = 2.0 / (loc_err_std ** 2)
        sigma = (2.0 * _gamma(generator, k_chi / 2.0, n * T * nb_dims, dev)
                 ).to(torch.float32).view(shape) \
            * (loc_err[:nb_dims] / k_chi)
    else:
        sigma = loc_err[:nb_dims]
    noisy = r[..., :nb_dims] + randn(*shape) * sigma
    del r

    # --- gather runs into fixed-shape rows ----------------------------------
    idx = (starts[:, :, None] + t_idx).clamp_(max=T - 1)     # (n, R, T)
    tmask = t_idx < lens[:, :, None]                          # (n, R, T)

    def take(a):                       # (n, T, w) -> (n, R, T, w)
        w = a.shape[2]
        return torch.gather(a[:, None].expand(n, R, T, w), 2,
                            idx[..., None].expand(n, R, T, w))

    out_pos = torch.where(tmask[..., None], take(noisy), 0.0)
    out_states = torch.where(tmask, take(states[..., None])[..., 0], 0)
    out_sig = None
    if loc_err_std > 0:
        out_sig = torch.where(tmask[..., None], take(sigma), 1.0).reshape(
            n * R, T * nb_dims)
    return (out_pos.reshape(n * R, T * nb_dims),
            out_states.to(torch.int8).reshape(n * R, T), out_sig,
            lens.reshape(n * R))


def sim_fov_batch(nb_tracks: int = 10000,
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
                  runs_per_particle: int = 4,
                  chunk: int = 250_000,
                  max_buckets: int = 4,
                  *,
                  device="cuda",
                  dtype=None):
    """sim_FOV on a device: padded TrackBatch buckets that never leave it.

    Same model as :func:`sim_fov` / the reference (simulate_tracks.py:
    123-244): sub-stepped Brownian motion over a Markov state chain,
    uniform seeding over twice the FOV per bounded axis, re-splitting at
    FOV exits, per-frame bleaching, chi-square per-peak errors.  Each
    particle contributes up to ``runs_per_particle`` FOV runs (re-entries
    beyond that are dropped; with default geometry that is <0.1% of
    tracks); ``chunk`` particles simulate at a time, so memory stays
    bounded.

    ``device`` defaults to the card and raises without one; ``device=
    "cpu"`` simulates on the CPU.  The draws come from one
    ``torch.Generator`` on the device seeded with ``seed`` (0 when None),
    in float32; the batches' positions, errors and bleach flags are in
    ``dtype`` (float32 on the card, float64 elsewhere, by default).
    Unbounded axes may be left out of ``cell_dims``, as in ``sim_fov``.

    Returns ``(batches, states)``: lists of TrackBatch (length-bucketed,
    runs sorted by descending length, ``np_lengths`` filled) and matching
    (B, T_bucket) int8 ground-truth state labels.  Empty output rows
    (length 0) are trimmed.  Only the (T+1)-entry length histogram crosses
    to the host.
    """
    device, dtype = tdevice.resolve_device(device, dtype)
    Ds = np.asarray(Ds, dtype=np.float64)
    TrMat = np.asarray(TrMat if TrMat is not None
                       else [[0.9, 0.1], [0.1, 0.9]], dtype=np.float64)
    if initial_fractions is None:
        initial_fractions = stationary_fractions(TrMat)
    f32 = dict(dtype=torch.float32, device=device)
    loc_err3 = torch.tensor(np.broadcast_to(
        np.asarray(LocErr, dtype=np.float32), (3,)).copy(), **f32)
    cell_dims = tuple(cell_dims) + (None,) * (3 - len(cell_dims))
    cell = [1.0 if c is None else float(c) for c in cell_dims]
    bounded = tuple(c is not None for c in cell_dims)
    n_total = int(nb_tracks * 2 ** sum(bounded))

    sub = _sub_transition(TrMat, nb_sub_steps)
    cum_tr = torch.tensor(np.cumsum(sub, axis=1), **f32)
    cum_frac = torch.tensor(np.cumsum(initial_fractions), **f32)
    d2sub = torch.tensor(2.0 * Ds * (dt / nb_sub_steps), **f32)
    T = max_track_len
    R = min(runs_per_particle, max(1, (T + 1) // 2))

    generator = torch.Generator(device=device)
    generator.manual_seed(seed if seed is not None else 0)
    parts = []
    left = n_total
    while left > 0:
        n = min(chunk, left)
        left -= n
        parts.append(_sim_fov_chunk(
            generator, n, T, nb_sub_steps, R, max(2, min_track_len), d2sub,
            cum_tr, cum_frac, cell, loc_err3, float(LocErr_std), float(pBL),
            bounded, nb_dims=nb_dims))
    pos = torch.cat([p[0] for p in parts])
    states = torch.cat([p[1] for p in parts])
    sig = torch.cat([p[2] for p in parts]) if LocErr_std > 0 else None
    lens = torch.cat([p[3] for p in parts])
    del parts      # free the per-chunk copies before the bucket gathers

    # compact + length-sort on the device; only the (T+1)-entry length
    # histogram crosses to the host
    order = torch.argsort(-lens, stable=True)
    counts = torch.bincount(lens, minlength=T + 1).cpu().numpy()
    n_alive = int(counts[1:].sum())
    if n_alive == 0:
        raise ValueError("no tracks survived the FOV/bleaching filters")
    widths = np.arange(T, 0, -1)
    widths = widths[counts[widths] > 0]          # descending, non-empty
    lens_host = np.repeat(widths, counts[widths]).astype(np.int32)
    data_max = int(widths[0])
    order = order[:n_alive]
    lens_sorted = lens[order]

    batches, states_out = [], []
    i0 = 0
    for i1 in _bucket_cuts(lens_host, max_buckets):
        t_max = int(lens_host[i0])
        sel = order[i0:i1]
        lens_b = lens_sorted[i0:i1]
        batches.append(tdata.TrackBatch(
            positions=_bucket_take(pos, sel, t_max, T, nb_dims).to(dtype),
            lengths=lens_b,
            loc_err=(_bucket_take(sig, sel, t_max, T, nb_dims).to(dtype)
                     if LocErr_std > 0 else None),
            is_bleached=(lens_b < data_max).to(dtype),
            np_lengths=lens_host[i0:i1]))
        states_out.append(_bucket_take(states, sel, t_max, T, 1)[..., 0])
        i0 = i1
    return batches, states_out


def _bucket_take(flat2d, sel, t_max, T, width):
    """One length bucket, (rows, t_max, width), from a chunk output's 2D
    (rows, T*width) rows."""
    return flat2d[sel].reshape(-1, T, width)[:, :t_max]


def _bucket_cuts(lens_desc: np.ndarray, max_buckets: int):
    """Cut END indices (final = len) minimizing total padded work
    sum(n_i * T_i) over <= max_buckets contiguous groups of the descending
    per-track length array.  Thin adapter over the shared bucket-partition
    DP (data.partition_cuts, which works on the ascending distinct-length
    list): ascending distinct cut e maps to descending position N - csum[e].
    """
    uniq, cnt = np.unique(lens_desc, return_counts=True)   # ascending
    cuts = tdata.partition_cuts(uniq.tolist(), cnt.tolist(), max_buckets)
    csum = np.concatenate([[0], np.cumsum(cnt)])
    N = len(lens_desc)
    return sorted(int(N - csum[e]) for e in [0] + cuts if e < len(uniq))


def brownian_frames(generator, nb_tracks: int, track_len: int, Ds, Fs,
                    tr_mat, loc_err: float, dt: float, nb_dims: int = 2,
                    *, device="cuda", dtype=None):
    """Fixed-length tracks with frame-resolution transitions, generated on
    a device for benchmarks: no host round trips.

    ``generator`` is a ``torch.Generator`` on ``device`` (None: one seeded
    with 0).  ``device`` defaults to the card and raises without one;
    ``dtype`` to float32 there and float64 elsewhere.  Returns (positions
    (B, T, D), states (B, T) int32).
    """
    device, dtype = tdevice.resolve_device(device, dtype)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    f = dict(dtype=dtype, device=device)
    Ds = torch.as_tensor(np.asarray(Ds, dtype=np.float64), **f)
    Fs = np.asarray(Fs, dtype=np.float64)
    tr = np.asarray(tr_mat, dtype=np.float64)
    cum_f = torch.as_tensor(np.cumsum(Fs / Fs.sum()), **f)
    cum_tr = torch.as_tensor(np.cumsum(tr / tr.sum(1, keepdims=True),
                                       axis=1), **f)
    S = cum_f.shape[0]
    # inverse-CDF draws (categorical over the normalized weights, as
    # jax.random.categorical): the initial state from Fs, each next one
    # from its row of tr_mat
    u = torch.rand((track_len, nb_tracks), generator=generator, **f)
    states = torch.empty((nb_tracks, track_len), dtype=torch.int64,
                         device=device)
    s = (u[0][:, None] > cum_f).sum(1).clamp_(max=S - 1)
    states[:, 0] = s
    for t in range(1, track_len):
        s = (u[t][:, None] > cum_tr[s]).sum(1).clamp_(max=S - 1)
        states[:, t] = s
    d2 = 2.0 * Ds * dt
    step_var = (d2[states[:, :-1]] + d2[states[:, 1:]]) / 2.0
    disp = torch.randn((nb_tracks, track_len - 1, nb_dims),
                       generator=generator, **f) * step_var.sqrt()[..., None]
    r = torch.cat([torch.zeros((nb_tracks, 1, nb_dims), **f),
                   disp.cumsum(1)], dim=1)
    x = r + loc_err * torch.randn(r.shape, generator=generator, **f)
    return x, states.to(torch.int32)


# ---------------------------------------------------------------------------
# Reference-named utility API (extrack/simulate_tracks.py:11-54,113-121),
# with the reference's signatures; numpy, as in the JAX package.

def get_fractions_from_TrMat(TrMat):
    """Steady-state occupancies of a transition-probability matrix.

    Reference: extrack/simulate_tracks.py:24-54 (analytic for 2/3 states,
    power iteration otherwise); here one eigen-decomposition covers every
    state count.
    """
    return np.asarray(stationary_fractions(np.asarray(TrMat, float)))


def markovian_process(TrMat, initial_fractions, nb_tracks, track_len,
                      seed: Optional[int] = None):
    """State chains of a discrete Markov process, (nb_tracks, track_len) int.

    Reference: extrack/simulate_tracks.py:11-22.  Vectorized over tracks
    via inverse-CDF sampling on cumulative rows (the reference loops over
    time with a per-state accumulation); optional ``seed`` for
    reproducibility.
    """
    rng = np.random.default_rng(seed)
    TrMat = np.asarray(TrMat, float)
    cum_rows = np.cumsum(TrMat, axis=1)
    states = np.empty((nb_tracks, track_len), dtype=int)
    # clip before cum_rows is indexed: under-normalized fractions can make
    # searchsorted return nb_states (the reference assigns that remainder
    # to the last state, simulate_tracks.py:11-22)
    states[:, 0] = np.minimum(
        np.searchsorted(np.cumsum(np.asarray(initial_fractions)),
                        rng.random(nb_tracks), side="right"),
        len(TrMat) - 1)
    u = rng.random((nb_tracks, track_len - 1))
    for k in range(1, track_len):
        rows = cum_rows[states[:, k - 1]]
        states[:, k] = (u[:, k - 1:k] >= rows).sum(axis=1)
    return np.clip(states, 0, len(TrMat) - 1)


def is_in_FOV(positions, cell_dims):
    """Per-position FOV membership mask with a trailing sentinel ``False``.

    Reference: extrack/simulate_tracks.py:113-121 (the sentinel marks the
    end of the track for the exit-split logic).
    """
    positions = np.asarray(positions)
    in_fov = np.ones(len(positions) + 1, dtype=bool)
    for i, l in enumerate(cell_dims):
        if l is not None:
            cur = (positions[:, i] < l) & (positions[:, i] > 0)
            in_fov &= np.concatenate([cur, [False]])
    return in_fov


# the reference's names (extrack/simulate_tracks.py:56,123)
sim_FOV = sim_fov
sim_noBias = sim_nobias
