"""State-duration (segment-length) histograms.

Equivalent of the reference histogram engine (extrack/histograms.py:26-457):
the posterior-weighted distribution of consecutive same-state segment
lengths, a non-Markovian diagnostic of the fitted model.

Two engines:

* the fixed-window DP (``window_segment_histogram``, the default): the
  likelihood engine's K = S**window register is augmented with a per-slot
  distribution over the length of the run holding the window's oldest
  frame and a per-slot histogram of the segments completed in the dropped
  history, both mixed by the same fusion weights as the Gaussian moments.
  Exact when the window covers the whole track.  On CUDA every batch runs
  kernel K5 (ops/hist_kernel); CPU tensors run this plain version.
* the top-K engine (``segment_histogram``), the reference's own pruning
  rule (extrack/histograms.py:179-206): a register of ``max_nb_states``
  explicit state sequences per track, re-selected each frame by a one-step
  look-ahead score, with parent/state backpointers decoded at the end
  (``decode_backpointers``).  On CUDA kernel K7 (ops/topk_kernel) runs
  the register walk and the decode, one histogram row per track; CPU
  tensors run ``segment_backpointers``.

Deviations from the reference are the JAX package's, kept as they are:
the end-of-track term is the tracking module's transition-weighted fold,
pruning also applies at the last interior step, and full-track-length
segments are counted (DEVIATIONS.md 3b).
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional

import numpy as np
import torch

from extrack_tpu_torch import data as tdata
from extrack_tpu_torch import device as tdevice
from extrack_tpu_torch import params as tparams
from extrack_tpu_torch.core import engine, tables
from extrack_tpu_torch.parallel import mesh as pmesh

_NEG = -1e30              # log weight of an unused register slot
# engine names accepted by hist_batch / len_hist, as the JAX package's, and
# the engine each runs: one implementation per device
_ENGINES = {"window": "window", "pallas": "window", "xla": "window",
            "topk": "topk", "topk_pallas": "topk"}
TOPK_CHUNK = 32768        # tracks per K7 launch: the backpointers dominate


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


def segment_backpointers(positions, lengths, is_bleached,
                         tb: tables.ModelTables, *, max_nb_states: int = 512,
                         min_len: int = 3, nb_substeps: int = 1):
    """The top-K register walk, the plain version of K7, in ``positions``'
    dtype on its device.

    Each track keeps M = ``max_nb_states`` explicit state sequences, each
    with a Gaussian mean and variance per dimension, a log-probability, an
    accumulated survival term and its newest state; unused slots carry log
    weight -1e30.  At each frame t = 1..T-1 the observation is folded into
    every row, a track ending at t adds the softmax of its closing weights
    to ``w_final``, and each row branches into A = S**n children scored by
    the look-ahead integral of the next observation; a stable sort keeps
    the top M (ties go to the lower child index a*M + parent).  Tracks
    that have ended record identity parents and unchanged states.  dt may
    be constant, per step or per track.

    Returns (parents (T-1, B, M) int64, states (T-1, B, M) int8, w_final
    (B, M)): row t-1 holds each survivor's parent slot and newest state
    after step t, the JAX package's layout.
    """
    B, T, D = positions.shape
    S = tb.nb_states
    n = nb_substeps
    A = S ** n                                 # branch patterns per step
    P = S ** (n + 1)
    newest_div = S ** (n - 1)                  # pattern -> newest digit
    M = max_nb_states
    if M < P:
        raise ValueError(f"max_nb_states ({M}) must be >= "
                         f"nb_states^(nb_substeps+1) = {P}")
    dtype, dev = positions.dtype, positions.device
    lengths = lengths.to(device=dev, dtype=torch.int64)
    isbl = is_bleached.to(device=dev, dtype=dtype)[:, None]
    l2 = tb.loc_err2.to(dtype).expand(B, T, D)
    lsurv = tb.log_survive.to(dtype)[:, None]                  # (A, 1)
    lt_tab = tables.branch_log_trans(tb.log_trans, n).to(dtype)  # (A, S)
    end_k = tb.end_ll.to(dtype)
    sig2 = tb.sig2.to(dtype)
    R = sig2.shape[-2]

    def sig2_at(t):
        return sig2[..., min(t, R - 1), :]     # (P,) or (B, P)

    def log_normal(x, mean, var):
        # summed over the dimensions left to right, as K7 sums them, so that
        # the two compute the same scores bit for bit
        terms = -0.5 * torch.log(2 * np.pi * var) - (x - mean) ** 2 / (2 * var)
        return sum(terms[..., d] for d in range(D))

    # initial register: all S^(n+1) two-frame patterns, then unused slots
    pairs = tables.state_codes(S, n + 1)       # (P, n+1) newest first
    lp = torch.full((B, M), _NEG, dtype=dtype, device=dev)
    lp[:, :P] = tables.init_log_prob(tb.log_trans, tb.log_frac, n).to(dtype)
    ll = torch.zeros((B, M), dtype=dtype, device=dev)
    newest = torch.zeros(M, dtype=torch.int64, device=dev)
    newest[:P] = torch.as_tensor(pairs[:, 0], device=dev)
    newest = newest.expand(B, M)
    sig2_pat = sig2_at(0)[..., np.pad(np.arange(P), (0, M - P))]
    m = positions[:, 0, None, :].expand(B, M, D)
    s2 = (l2[:, 0, None, :] + sig2_pat.reshape(-1, M)[..., None]).expand(
        B, M, D)
    w_final = torch.zeros((B, M), dtype=dtype, device=dev)

    a_idx = torch.arange(A, device=dev)[:, None]                # (A, 1)
    slots = torch.arange(M, device=dev).expand(B, M)
    parents, states = [], []
    for t in range(1, T):
        x_t, l2_t = positions[:, t, None, :], l2[:, t, None, :]
        tn = min(t + 1, T - 1)
        x_n, l2_n = positions[:, tn, None, None, :], l2[:, tn, None, None, :]
        s2row = sig2_at(t)
        is_final = (t == lengths - 1)[:, None]
        keep = (t < lengths - 1)[:, None]

        # observation at frame t, shared by the closing and the branch
        tot = l2_t + s2
        lc = log_normal(x_t, m, tot)
        fin = lp + ll + isbl * end_k[newest] + lc
        w_final = w_final + torch.where(is_final, torch.softmax(fin, -1), 0.0)

        # children (B, A, M): new sub-state pattern axis first
        new_m = (m * l2_t + x_t * s2) / tot
        tail = l2_t * s2 / tot
        gate = float(t + 1 >= min_len)
        lt = lt_tab.T[newest].transpose(1, 2)
        pat = a_idx * S + newest[:, None, :]
        sig2_new = (s2row[pat] if s2row.ndim == 1 else
                    s2row.gather(1, pat.reshape(B, A * M)).reshape(B, A, M))
        lp_child = lp[:, None, :] + lt + lc[:, None, :]
        ll_child = ll[:, None, :] + gate * lsurv
        s2_child = sig2_new[..., None] + tail[:, None]          # (B,A,M,D)

        # look-ahead score (histograms.py:183-199): LP + next-obs integral
        look = lp_child + log_normal(x_n, new_m[:, None], l2_n + s2_child)
        order = torch.sort(-look.reshape(B, A * M), dim=1,
                           stable=True).indices[:, :M]
        parent = order % M
        new_state = order // M // newest_div

        m = torch.where(keep[..., None],
                        new_m.gather(1, parent[..., None].expand(B, M, D)), m)
        s2 = torch.where(keep[..., None], s2_child.reshape(B, A * M, D).gather(
            1, order[..., None].expand(B, M, D)), s2)
        lp = torch.where(keep, lp_child.reshape(B, -1).gather(1, order), lp)
        ll = torch.where(keep, ll_child.reshape(B, -1).gather(1, order), ll)
        newest = torch.where(keep, new_state, newest)
        parents.append(torch.where(keep, parent, slots))
        states.append(newest.to(torch.int8))
    if T < 2:
        empty = torch.zeros((0, B, M), dtype=torch.int64, device=dev)
        return empty, empty.to(torch.int8), w_final
    return torch.stack(parents), torch.stack(states), w_final


def segment_histogram(positions, lengths, is_bleached,
                      tb: tables.ModelTables, *, max_nb_states: int = 512,
                      min_len: int = 3, nb_substeps: int = 1,
                      per_track: bool = False):
    """(T, S) posterior-weighted segment-length histogram of the top-K
    engine, summed over the tracks: ``segment_backpointers`` decoded by
    ``decode_backpointers``.  With ``nb_substeps`` = n > 1 each frame step
    branches over all S**n sub-state patterns and segments are decoded at
    frame resolution (DEVIATIONS.md 3b); ``tb`` is built with the same n.
    ``per_track``: each track's own (B, T, S) histogram instead, the rows
    that K7's fused decode writes.
    """
    S = tb.nb_states
    parents, states, w_final = segment_backpointers(
        positions, lengths, is_bleached, tb, max_nb_states=max_nb_states,
        min_len=min_len, nb_substeps=nb_substeps)
    return decode_backpointers(parents, states, w_final, lengths,
                               tables.state_codes(S, nb_substeps + 1), S,
                               max_nb_states, per_track)


def decode_backpointers(parents, states, w_final, lengths, pairs, S, M,
                        per_track: bool = False):
    """Backtrack (T-1, B, M) parent/state backpointers (any integer dtype,
    any strides) into explicit sequences and decode their segments, on
    their device, into the (T, S) histogram or, with ``per_track``, each
    track's (B, T, S) histogram.  Shared by the plain top-K engine and
    K7's raw mode.

    After reverse step i (walk step t = i+1) the chain maps final slots to
    the register after step t-1; vals[i] is the state at frame i+2 of each
    final slot."""
    Tm1, B, _ = parents.shape
    dev = w_final.device
    chain = torch.arange(M, device=dev).expand(B, M)
    vals = [None] * Tm1
    for i in range(Tm1 - 1, -1, -1):
        vals[i] = states[i].gather(1, chain)
        chain = parents[i].gather(1, chain).long()
    # chain now indexes the INITIAL register: frames 0 and 1 come from the
    # two-frame init patterns; vals[T-2] targets frame T (discarded)
    pairs_pad = torch.zeros((M, pairs.shape[1]), dtype=torch.int8,
                            device=dev)
    pairs_pad[:pairs.shape[0]] = torch.as_tensor(pairs, device=dev)
    seqs = torch.stack([pairs_pad[:, -1][chain], pairs_pad[:, 0][chain]]
                       + vals[:Tm1 - 1], dim=-1)
    return decode_segments(seqs, w_final, lengths, S, per_track)


def decode_segments(seqs, weights, lengths, nb_states: int,
                    per_track: bool = False):
    """Histogram of same-state run lengths, weighted per sequence.

    seqs: (B, M, T) int states in forward time order; weights: (B, M);
    lengths: (B,) valid frame counts.  Returns (T, S), or with
    ``per_track`` each track's (B, T, S).
    Equivalent of the reference's per-step run decoding
    (extrack/histograms.py:253-284), one pass over the frames with a run
    counter per sequence: a segment ends at frame t when the next state
    differs or the track ends there, and its weight goes to bin (its
    length - 1, state).  Each sequence keeps its own column of T*S bins: a frame adds
    one value to each column, so no two adds of one launch meet and the
    bins take the same bits on every run on the card (unlike an atomic
    index_add_ into one histogram); a row sum reduces them at the end.
    Bin-major columns keep a frame's adds to neighbouring sequences close
    in memory.  Work and memory are linear in T.
    """
    B, M, T = seqs.shape
    S = nb_states
    N = B * M
    dev, dtype = weights.device, weights.dtype
    seqs = seqs.reshape(N, T)
    w = weights.reshape(N)
    last = lengths.to(device=dev, dtype=torch.int32).repeat_interleave(M) - 1
    run = torch.zeros(N, dtype=torch.int32, device=dev)    # length - 1
    bins = torch.zeros((T * S, N), dtype=dtype, device=dev)
    for t in range(T):
        cur = seqs[:, t]
        end = last == t
        if t + 1 < T:
            end |= (last > t) & (seqs[:, t + 1] != cur)
        bins.scatter_add_(0, (run * S + cur).long()[None], (w * end)[None])
        run = torch.where(end, 0, run + 1)
    if per_track:
        return bins.reshape(T * S, B, M).sum(2).T.reshape(B, T, S)
    return bins.sum(1).reshape(T, S)


def _check_engine(engine_name: str, nb_substeps: int) -> str:
    """The engine that ``engine_name`` runs, 'window' or 'topk'.  The JAX
    package's names of its two implementations of each ('pallas'/'xla',
    'topk_pallas') run the port's one implementation per device."""
    if engine_name not in _ENGINES:
        raise ValueError(f"unknown engine {engine_name!r}; the engines are "
                         f"{sorted(_ENGINES)}")
    if engine_name == "pallas" and nb_substeps != 1:
        raise NotImplementedError(
            "nb_substeps > 1 requires engine='window' or 'topk'")
    return _ENGINES[engine_name]


def _shard_choice(kind: str, engine_name: str, sharded):
    """``sharded`` as the window engine takes it; the top-K engine warns
    and runs unsharded, as the JAX package's does."""
    if sharded and kind == "topk":
        warnings.warn(
            f"len_hist: sharded=True is not supported for engine="
            f"{engine_name!r}; running on a single device.", RuntimeWarning,
            stacklevel=3)
        return False
    return sharded


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
               sharded=False) -> np.ndarray:
    """(T, S) duration histogram of a TrackBatch, as a numpy array in the
    batch's dtype (copied from its device), as the JAX package returns it.

    engine 'window' (or 'pallas' / 'xla'): ``window`` counts frames; with
    nb_substeps = n the register covers n*(window-1)+1 sub-steps.  A CUDA
    batch is one K5 launch (or one per ``chunk`` tracks when given); the
    plain version on the CPU carries ~K*S*T floats per track, so CPU
    batches run in chunks.

    engine 'topk' (or 'topk_pallas'): a register of ``max_nb_states``
    sequences, rounded up to a multiple of 128 as the JAX package does
    (500 -> 512).  A CUDA batch is one K7 launch per 32768 tracks at most,
    each followed by the decode; CPU batches run the plain version in
    chunks.

    ``sharded`` (True, or a ``parallel.mesh.Mesh``) splits each chunk's
    tracks over the mesh's shards, K5 on each (``mesh.sharded_histogram``;
    ``chunk`` then bounds the tracks of one shard), summed over the shards
    and the process group.  The top-K engine warns and runs unsharded.
    """
    kind = _check_engine(engine, nb_substeps)
    return _hist_batch(
        batch, params, dt, cell_dims=cell_dims, nb_states=nb_states,
        max_nb_states=max_nb_states, nb_substeps=nb_substeps,
        input_loc_err=input_loc_err, matrix_type=matrix_type,
        kind=kind, window=window, chunk=chunk, min_len=min_len,
        sharded=_shard_choice(kind, engine, sharded)).cpu().numpy()


def _hist_batch(batch: tdata.TrackBatch, params, dt, *, cell_dims,
                nb_states: int, max_nb_states: int, nb_substeps: int,
                input_loc_err: bool, matrix_type: int, kind: str,
                window: int, chunk: Optional[int], min_len: Optional[int],
                dt_repr: Optional[float] = None,
                sharded=False) -> torch.Tensor:
    """``hist_batch`` after its engine check (``kind`` 'window' or
    'topk'), with the survival tables' representative dt ``dt_repr``
    (None: each table build's own, ``tables.build_tables``)."""
    from extrack_tpu_torch.ops import hist_kernel, topk_kernel
    values = (params.resolve() if isinstance(params, tparams.Parameters)
              else params)
    if min_len is None:
        min_len = tdata.default_min_len(tdata.host_lengths(batch))
    window_sub = nb_substeps * (window - 1) + 1
    M = max(-(-max_nb_states // 128) * 128, 128)
    B = batch.batch_size
    on_card = batch.positions.device.type == "cuda"
    if chunk is None:
        per_track = nb_states ** window_sub * nb_states * batch.max_len * 16
        chunk = (max(B, 1) if on_card
                 else int(min(65536, max(4096, (1 << 31) // per_track))))
        if kind == "topk" and not on_card:
            # backpointers and the decode's temporaries: ~64 bytes per
            # slot and frame
            chunk = max(1, (1 << 30) // (M * batch.max_len * 64))
    if kind == "topk" and on_card:
        chunk = min(chunk, TOPK_CHUNK)
    mesh = None
    if sharded:
        # the chunk bound is per shard: each shard runs the same walk
        mesh = pmesh.mesh_for(sharded, batch.positions.device)
        chunk *= mesh.size
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
                                 matrix_type=matrix_type, dt_repr=dt_repr)
        args = (pos, batch.lengths[sl], batch.is_bleached[sl], tb)
        if mesh is not None:
            part = tdata.TrackBatch(pos, args[1], is_bleached=args[2],
                                    process_local=batch.process_local)
            h = pmesh.sharded_histogram(part, tb, window=window_sub,
                                        min_len=min_len, mesh=mesh,
                                        nb_substeps=nb_substeps)
        elif kind == "topk":
            h = topk_kernel.segment_topk(*args, max_nb_states=M,
                                         min_len=min_len,
                                         nb_substeps=nb_substeps)
        else:
            h = hist_kernel.hist(*args, window=window_sub, min_len=min_len,
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
             sharded=False,
             *,
             device="cuda",
             dtype=None) -> np.ndarray:
    """Reference-compatible entry point (extrack/histograms.py:294-373), on
    ``device`` (the card by default; ``device="cpu"`` runs the plain
    version) in ``dtype`` (float32 on CUDA, where the kernels compute,
    float64 elsewhere).

    Returns (max_track_len, S) as float64.  The tracks go into 4 length
    buckets; each bucket's histogram is padded to the longest length and
    the buckets are summed, which gives the histogram of one padded batch.
    ``min_len`` comes from all lengths.  ``workers`` is accepted for
    compatibility.  ``engine``: 'window' (the default; 'pallas' and 'xla'
    name it too) runs one K5 launch per bucket on the card; 'topk' (or
    'topk_pallas') keeps the top ``max_nb_states`` sequences (rounded up
    to a multiple of 128), one K7 launch per 32768 tracks of a bucket.
    With a dt dict every bucket's survival tables take the dataset's
    representative dt (``tdata.dt_median``), as JAX's one padded batch
    does.  ``sharded`` as ``hist_batch``, bucket by bucket.
    """
    del workers
    device, dtype = tdevice.resolve_device(device, dtype)
    kind = _check_engine(engine, nb_substeps)
    sharded = _shard_choice(kind, engine, sharded)
    dts = dt if isinstance(dt, dict) else None
    batches = tdata.from_dict_bucketed(
        all_tracks, max_buckets=4, input_loc_err=input_LocErr, dt=dts,
        device=device, dtype=dtype)
    min_len = tdata.default_min_len(
        np.concatenate([tdata.host_lengths(b) for b in batches]))
    dt_repr = tdata.dt_median(all_tracks, dts)
    out = np.zeros((max(b.max_len for b in batches), nb_states))
    for b in batches:
        h = _hist_batch(b, params, dt if dts is None else 0.0,
                        cell_dims=cell_dims, nb_states=nb_states,
                        max_nb_states=max_nb_states, nb_substeps=nb_substeps,
                        input_loc_err=input_LocErr is not None,
                        matrix_type=matrix_type, kind=kind, window=window,
                        chunk=chunk, min_len=min_len, dt_repr=dt_repr,
                        sharded=sharded)
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
