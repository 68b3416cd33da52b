"""State-duration (segment-length) histograms.

Equivalent of the reference histogram engine (extrack/histograms.py:26-457):
the posterior-weighted distribution of consecutive same-state segment
lengths, a non-Markovian diagnostic of the fitted model.

The engine is the fixed-window DP (``window_segment_histogram``): the
likelihood engine's K = S**window register is augmented with a per-slot
distribution over the length of the run holding the window's oldest frame
and a per-slot histogram of the segments completed in the dropped history,
both mixed by the same fusion weights as the Gaussian moments.  Exact when
the window covers the whole track.  On CUDA every batch runs kernel K5
(ops/hist_kernel); CPU tensors run this plain version.  The top-K engines
of the JAX package (the XLA ``segment_histogram`` and kernel K7) are not
ported yet.

Deviations from the reference are the JAX package's, kept as they are:
the end-of-track term is the tracking module's transition-weighted fold,
and full-track-length segments are counted (DEVIATIONS.md 3b).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from extrack_tpu_torch import data as tdata
from extrack_tpu_torch import params as tparams
from extrack_tpu_torch.core import engine, tables
from extrack_tpu_torch.ops import cuda_lib


def _segment_tables(codes: np.ndarray, W: int, T: int, S: int,
                    stride: int = 1):
    """Static per-slot segment decorations of the W-frame window.

    For each register slot (its W states known in advance, oldest ->
    newest order = reversed code digits):
      * seg_int (K, T, S): completed runs fully inside the window, excluding
        the run touching the window's oldest frame (that one joins the
        carried run distribution);
      * seg_all (W+1, K, T, S): all runs among the newest v window digits,
        for every v (tracks shorter than the window never drop frames);
      * ext (K,): length of the run at the window's oldest end.
    """
    K = codes.shape[0]
    Wf = (W - 1) // stride + 1        # frames in the window
    seg_int = np.zeros((K, T, S), np.float64)
    seg_all = np.zeros((Wf + 1, K, T, S), np.float64)
    ext = np.zeros((K,), np.int32)

    def runs(a):
        out, start = [], 0
        for j in range(1, len(a) + 1):
            if j == len(a) or a[j] != a[j - 1]:
                out.append((j - start, int(a[j - 1])))
                start = j
        return out

    for k in range(K):
        # frame states oldest -> newest: every stride-th sub-digit starting
        # from the oldest (frames sit at digit positions W-1, W-1-n, ..., 0)
        seq = codes[k, ::-1][::stride]
        r = runs(seq)
        ext[k] = r[0][0]
        for ln, s in r[1:]:
            seg_int[k, min(ln, T) - 1, s] += 1
        for v in range(2, Wf + 1):
            for ln, s in runs(seq[Wf - v:]):
                seg_all[v, k, min(ln, T) - 1, s] += 1
    return seg_int, seg_all, ext


def window_segment_histogram(positions, lengths, is_bleached,
                             tb: tables.ModelTables, *, window: int = 7,
                             min_len: int = 3, nb_substeps: int = 1):
    """Posterior-weighted segment-length histogram via the fixed window:
    the plain version of K5, in ``positions``' dtype on its device.

    Each slot of the likelihood register carries ``run`` (K, T, B), the
    distribution over the length of the run containing the window's
    oldest frame, and ``histc`` (K, S*T, B), the expected histogram of
    segments completed in the dropped history; both are mixed by the
    fusion weights.  At a track's last frame the softmax of the register
    weighs the carried histogram, the carried run (extended by the
    window's own oldest run) and the window's static segments.

    With nb_substeps = n > 1 the register covers ``window`` hidden
    sub-steps ((window-1) % n must be 0 so frames align with the window);
    segment lengths are decoded at frame resolution (DEVIATIONS.md 3b).

    Returns (T, S): row l-1 = expected number of length-l segments per
    state, summed over tracks (per-track posterior normalized).  Tracks of
    fewer than 2 frames contribute nothing.
    """
    B, T, D = positions.shape
    S = tb.nb_states
    W = window
    n = nb_substeps
    if (W - 1) % n:
        raise ValueError(f"window-1 ({W - 1}) must be a multiple of "
                         f"nb_substeps ({n}) so frames align")
    Wf = (W - 1) // n + 1             # frames covered by the window
    spec = engine.make_register_spec(S, W, n)
    K, A, G = spec.K, spec.A, spec.G
    dtype, dev = positions.dtype, positions.device
    lengths = lengths.to(device=dev, dtype=torch.int64)
    isbl = is_bleached.to(dtype)[None, :]
    wk = engine.walk_setup(positions, tb, spec)
    m, s2, lp = wk.m, wk.s2, wk.lp

    def const(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    # static segment decorations, per-slot histograms flattened (K, S*T)
    seg_int_np, seg_all_np, ext_np = _segment_tables(spec.codes, W, T, S,
                                                     stride=n)
    seg_int = const(seg_int_np.transpose(0, 2, 1).reshape(K, S * T))
    seg_all = const(seg_all_np.transpose(0, 1, 3, 2).reshape(Wf + 1, K,
                                                             S * T))
    e_old = const(spec.codes[:, W - 1, None] == np.arange(S))       # (K, S)
    # boundary-run shift: bin m reads carried bin m - (ext-1)
    src = np.arange(T)[None, :] - (ext_np[:, None] - 1)
    shift_idx = torch.as_tensor(np.clip(src, 0, T - 1), device=dev)
    shift_ok = const(src >= 0)
    rows_k = torch.arange(K, device=dev)[:, None]
    # parent p = g*A + o: does the FRAME run extend across the drop?
    # (the next frame is n sub-digits newer than the dropped oldest one)
    ext_ok = const(spec.codes[:, W - 1 - n] == spec.codes[:, W - 1]
                   ).reshape(G, A)[:, :, None, None]

    run = torch.zeros((K, T, B), dtype=dtype, device=dev)
    run[:, 0] = 1.0                                   # run length 1
    histc = torch.zeros((K, S * T, B), dtype=dtype, device=dev)
    out = torch.zeros((S * T,), dtype=dtype, device=dev)
    unit = torch.zeros((G, A, T, B), dtype=dtype, device=dev)
    unit[:, :, 0] = 1.0
    for t in range(1, T):
        x_t, l2_t = wk.xs_pos[t], wk.xs_l2[t]
        is_final = t == lengths - 1
        is_interior = t < lengths - 1

        tot = l2_t[:, None, :] + s2
        quad = (-0.5 * torch.log(2 * np.pi * tot)
                - (x_t[:, None, :] - m) ** 2 / (2 * tot))
        lc = quad.sum(dim=0)                                  # (K, B)

        # ---- final-track contribution ---------------------------------
        fin = lp + isbl * wk.end_k + lc
        pbar = torch.softmax(fin, dim=0) * is_final[None, :].to(dtype)
        v = min(t + 1, Wf)
        carry_mode = t + 1 > Wf
        seg_static = seg_int if carry_mode else seg_all[v]    # (K, S*T)
        total = histc
        if carry_mode:
            boundary = run[rows_k, shift_idx] * shift_ok[..., None]
            total = histc + (boundary[:, None] * e_old[:, :, None, None]
                             ).reshape(K, S * T, B)
        out = out + ((pbar[:, None, :] * total).sum(dim=(0, 2))
                     + seg_static.T @ pbar.sum(dim=1))

        # ---- branch + fuse (the engine's shared transport step) -------
        new_m = (m * l2_t[:, None, :] + x_t[:, None, :] * s2) / tot
        tail = l2_t[:, None, :] * s2 / tot
        gate = float(t + 1 >= min_len)
        _, wn, lp_new, m_f, _, s2_new = engine.branch_fuse(
            lp, lc, new_m, tail, wk.sig2_ag_at(t), gate, wk.lt_b,
            wk.lsurv_b, G, A)

        # ---- run / hist transport across the drop ---------------------
        runv = run.reshape(G, A, T, B)
        histv = histc.reshape(G, A, S * T, B)
        if t >= Wf - 1:                    # the oldest frame leaves
            shifted = torch.cat([torch.zeros_like(run[:, :1]),
                                 run[:, :-1]], dim=1)
            sel = torch.where(ext_ok > 0, shifted.reshape(G, A, T, B), unit)
            histv = histv + (((1.0 - ext_ok) * runv)[:, :, None]
                             * e_old.reshape(G, A, S, 1, 1)
                             ).reshape(G, A, S * T, B)
        else:
            sel = runv
        # children of group g are slots a*G+g
        run_new = sum(wn[:, :, o, None, :] * sel[None, :, o]
                      for o in range(A)).reshape(K, T, B)
        hist_new = sum(wn[:, :, o, None, :] * histv[None, :, o]
                       for o in range(A)).reshape(K, S * T, B)

        keep = is_interior[None, :]
        m = torch.where(keep[None], m_f.reshape(D, K, B), m)
        s2 = torch.where(keep[None], s2_new.reshape(D, K, B), s2)
        lp = torch.where(keep, lp_new.reshape(K, B), lp)
        run = torch.where(keep[:, None], run_new, run)
        histc = torch.where(keep[:, None], hist_new, histc)
    return out.reshape(S, T).T


def decode_segments(seqs, weights, lengths, nb_states: int):
    """Histogram of same-state run lengths, weighted per sequence.

    seqs: (B, M, T) int states in forward time order; weights: (B, M);
    lengths: (B,) valid frame counts.  Returns (T, S).
    Vectorized equivalent of the reference's per-step run decoding
    (extrack/histograms.py:253-284).
    """
    B, M, T = seqs.shape
    S = nb_states
    seqs = seqs.long()
    lengths = lengths.long()
    t_idx = torch.arange(T, device=seqs.device)
    valid = t_idx[None, :] < lengths[:, None]                   # (B, T)
    change = torch.cat([seqs[:, :, 1:] != seqs[:, :, :-1],
                        torch.ones((B, M, 1), dtype=torch.bool,
                                   device=seqs.device)], dim=-1)
    is_end = ((change | (t_idx[None, None] == (lengths - 1)[:, None, None]))
              & valid[:, None, :])
    endpos = torch.where(is_end, t_idx[None, None], -1)
    last_end = torch.cummax(
        torch.cat([torch.full((B, M, 1), -1, device=seqs.device),
                   endpos[:, :, :-1]], dim=-1), dim=2).values
    seg_len = torch.where(is_end, t_idx[None, None] - last_end, 0)  # 1..T

    flat_idx = ((seg_len - 1) * S + seqs).reshape(-1)
    vals = (weights[..., None].expand(seqs.shape) * is_end).reshape(-1)
    hist = torch.zeros(T * S, dtype=weights.dtype, device=weights.device)
    hist.index_add_(0, flat_idx.clamp(0, T * S - 1), vals)
    return hist.reshape(T, S)


def _check_engine(engine_name: str, sharded: bool):
    if engine_name in ("topk", "topk_pallas"):
        raise NotImplementedError(
            f"engine={engine_name!r}: the top-K histogram engines (the XLA "
            "segment_histogram, extrack_tpu/histograms.py:59, and kernel "
            "K7, extrack_tpu/ops/pallas_topk.py) are not ported yet; use "
            "engine='window'")
    if engine_name != "window":
        raise ValueError(f"unknown engine {engine_name!r}; the port's "
                         "engine is 'window'")
    if sharded:
        raise NotImplementedError(
            "sharded histograms wait for the torch.distributed port "
            "(ROADMAP Queue 1 item 15)")


def hist_batch(batch: tdata.TrackBatch,
               params,
               dt,
               cell_dims=(0.5, None, None),
               nb_states: int = 2,
               max_nb_states: int = 500,
               nb_substeps: int = 1,
               input_loc_err: bool = False,
               matrix_type: int = 1,
               engine: str = "window",
               window: int = 7,
               chunk: Optional[int] = None,
               min_len: Optional[int] = None,
               sharded: bool = False) -> torch.Tensor:
    """(T, S) duration histogram of a TrackBatch, on its device.

    ``window`` counts frames; with nb_substeps = n the register covers
    n*(window-1)+1 sub-steps.  A CUDA batch is one K5 launch (or one per
    ``chunk`` tracks when given); the plain version on the CPU carries
    ~K*S*T floats per track, so CPU batches run in chunks.
    ``max_nb_states`` belongs to the top-K engines, which are not ported.
    """
    from extrack_tpu_torch.ops import hist_kernel
    del max_nb_states
    _check_engine(engine, sharded)
    values = (params.resolve() if isinstance(params, tparams.Parameters)
              else params)
    if min_len is None:
        min_len = tdata.default_min_len(tdata.host_lengths(batch))
    window_sub = nb_substeps * (window - 1) + 1
    B = batch.batch_size
    if chunk is None:
        per_track = nb_states ** window_sub * nb_states * batch.max_len * 16
        chunk = (max(B, 1) if batch.positions.device.type == "cuda"
                 else int(min(65536, max(4096, (1 << 31) // per_track))))
    dt_arr = batch.dt if batch.dt is not None else dt
    cell_dims = tuple(c for c in cell_dims if c is not None)

    def rows(x, sl):
        return x[sl] if isinstance(x, torch.Tensor) and x.ndim > 1 else x

    hist = None
    for start in range(0, max(B, 1), chunk):
        sl = slice(start, start + chunk)
        pos = batch.positions[sl]
        Ds, Fs, rates, loc_err, pBL = tparams.extract_arrays(
            values, nb_states,
            input_loc_err=batch.loc_err[sl] if input_loc_err else None,
            device=pos.device, dtype=pos.dtype)
        tb = tables.build_tables(Ds, loc_err, Fs, rates, pBL,
                                 rows(dt_arr, sl), cell_dims=cell_dims,
                                 nb_substeps=nb_substeps,
                                 matrix_type=matrix_type)
        h = hist_kernel.hist(pos, batch.lengths[sl], batch.is_bleached[sl],
                             tb, window=window_sub, min_len=min_len,
                             nb_substeps=nb_substeps)
        hist = h if hist is None else hist + h
    return hist


def len_hist(all_tracks: Dict[str, np.ndarray],
             params,
             dt,
             cell_dims=(0.5, None, None),
             nb_states: int = 2,
             max_nb_states: int = 500,
             workers: int = 1,
             nb_substeps: int = 1,
             input_LocErr=None,
             matrix_type: int = 1,
             engine: str = "window",
             window: int = 7,
             chunk: Optional[int] = None,
             sharded: bool = False,
             *,
             device="cuda",
             dtype=None) -> np.ndarray:
    """Reference-compatible entry point (extrack/histograms.py:294-373), on
    ``device`` (the card by default; ``device="cpu"`` runs the plain
    version) in ``dtype`` (float32 on CUDA, where K5 computes, float64
    elsewhere).

    Returns (max_track_len, S) as float64.  The tracks go into 4 length
    buckets (one K5 launch each on the card); each bucket's histogram is
    padded to the longest length and the buckets are summed, which gives
    the histogram of one padded batch.  ``min_len`` comes from all
    lengths.  ``workers`` is accepted for compatibility; ``engine`` must
    be 'window' (the top-K engines raise ``NotImplementedError``).
    """
    del workers
    cuda_lib.check_device(device)
    _check_engine(engine, sharded)
    if dtype is None:
        dtype = (torch.float32 if torch.device(device).type == "cuda"
                 else torch.float64)
    batches = tdata.from_dict_bucketed(
        all_tracks, max_buckets=4, input_loc_err=input_LocErr,
        dt=dt if isinstance(dt, dict) else None, device=device, dtype=dtype)
    min_len = tdata.default_min_len(
        np.concatenate([tdata.host_lengths(b) for b in batches]))
    out = np.zeros((max(b.max_len for b in batches), nb_states))
    for b in batches:
        h = hist_batch(b, params, dt if not isinstance(dt, dict) else 0.0,
                       cell_dims=cell_dims, nb_states=nb_states,
                       nb_substeps=nb_substeps,
                       input_loc_err=input_LocErr is not None,
                       matrix_type=matrix_type, window=window, chunk=chunk,
                       min_len=min_len)
        out[:b.max_len] += h.double().cpu().numpy()
    return out


def ground_truth_hist(all_Bs: Dict[str, np.ndarray],
                      nb_states: int = 2,
                      long_tracks: bool = False,
                      nb_steps_lim: int = 20) -> np.ndarray:
    """Segment histogram of simulated ground-truth state labels.

    Reference: extrack/histograms.py:403-457.  Uses the same vectorized
    decoder with unit weights.
    """
    keys = [k for k in all_Bs if len(all_Bs[k]) > 0
            and (not long_tracks or int(k) >= nb_steps_lim)]
    if not keys:
        return np.zeros((0, nb_states))
    tmax = max(int(k) for k in keys)
    hist = np.zeros((tmax, nb_states))
    for k in keys:
        arr = torch.as_tensor(np.asarray(all_Bs[k]))
        b, t = arr.shape
        h = decode_segments(arr[:, None, :], torch.ones((b, 1),
                                                        dtype=torch.float64),
                            torch.full((b,), t), nb_states)
        hist[:t] += h.numpy()
    return hist
