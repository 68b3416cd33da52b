"""Position refinement: most-likely true positions and their uncertainty.

Equivalent of the reference refined_localization module
(extrack/refined_localization.py:48-338): for every localization, the
posterior over the particle's true position is a Gaussian mixture formed by
combining, per hidden state, a prior propagated from all earlier positions,
a prior propagated from all later positions, and the observation itself
(prod_3GaussPDF, :229-285); track ends use two-term products (:221,291).

Both directions are the likelihood engine's fixed-register scan (the suffix
direction is the prefix scan on per-track-reversed data with the transposed
transitions), each emitting its register per step.  Slots are ordered with
the newest state in the leading digit, so the per-state alignment of the
two sides is a reshape to (S, K/S) blocks.  As in the reference, the
weights carry transition terms only: no occupation fractions, survival or
bleaching (get_LC_Km_Ks accumulates LT+LC only and the backward pass uses
uniform fractions, refined_localization.py:93-96,218).

On CUDA every length bucket runs kernel K6 (ops/refine_kernel); CPU tensors
run the plain ``refine_positions``.  A 1-frame track refines to its
observation (mu = x, sigma = its localization error) on both.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from extrack_tpu_torch import data as tdata
from extrack_tpu_torch import device as tdevice
from extrack_tpu_torch.core import gaussian as gaussian_ops
from extrack_tpu_torch.core.engine import _moment_match, make_register_spec
from extrack_tpu_torch.core.tables import (branch_log_trans, cap_log,
                                           state_codes)

_TINY = 1e-30
# the reference's default refinement schedule (extrack_tpu/refine.py
# default_window, ops/pallas_refine.py pick_jb / refine_block_cap): the
# largest window <= 7 whose register, suffix stash and pair chunk fit a
# 40 MiB budget of the TPU kernel's scratch memory for at least 128 tracks
_SCHEDULE_BUDGET = 40 * 1024 * 1024


def _refine_scan(positions, l2, lengths, log_trans, sig2_states, W):
    """Prefix scan emitting, for every step t in 1..T-1, the register
    (m, s2, lp) describing r_t given x_{<t} (before x_t is injected).

    sig2_states: (S,) displacement variance per state (2*D*dt); pair
    variance is the mean of the two adjacent states' values as in the
    engine.  Returns (ms (B,T,K,D), s2s (B,T,K,D), lps (B,T,K)) with step 0
    a dummy of zeros.
    """
    B, T, D = positions.shape
    S = log_trans.shape[0]
    spec = make_register_spec(S, W, 1)
    K, G, A = spec.K, spec.G, spec.A
    dev = positions.device

    def idx(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    lt_ag = branch_log_trans(log_trans, 1)[:, idx(spec.prev0_g)]   # (S, G)
    sig2_pair = 0.5 * (sig2_states[:, None] + sig2_states[None, :])  # (a,s)
    sig2_ag = sig2_pair[:, idx(spec.prev0_g)]                      # (S, G)
    pairs = state_codes(S, 2)
    lp0 = log_trans[idx(pairs[:, 1]), idx(pairs[:, 0])]            # LT only
    lp = (lp0[idx(spec.init_pat)]
          - spec.dummy_digits * math.log(S)).expand(B, K)
    sig2_init = sig2_pair.reshape(-1)[idx(spec.init_pat)]
    m = positions[:, 0, None, :].expand(B, K, D)
    s2 = (l2[:, 0, None, :] + sig2_init[None, :, None]).expand(B, K, D)

    ms, s2s, lps = [torch.zeros_like(m)], [torch.zeros_like(s2)], [
        torch.zeros_like(lp)]
    for t in range(1, T):
        ms.append(m)
        s2s.append(s2)
        lps.append(lp)
        x_t, l2_t = positions[:, t], l2[:, t]
        tot = l2_t[:, None, :] + s2
        new_m = (m * l2_t[:, None, :] + x_t[:, None, :] * s2) / tot
        tail = l2_t[:, None, :] * s2 / tot
        lc = (-0.5 * torch.log(2 * math.pi * tot)
              - (x_t[:, None, :] - m) ** 2 / (2 * tot)).sum(-1)
        base = (lp + lc).reshape(B, G, A)
        lp_child = base[:, None] + lt_ag[None, :, :, None]
        lp_new, (m_f, tail_f), _ = _moment_match(
            lp_child,
            [new_m.reshape(B, 1, G, A, D), tail.reshape(B, 1, G, A, D)])
        s2_new = sig2_ag[None, :, :, None] + tail_f
        keep = (t < lengths - 1)[:, None]
        m = torch.where(keep[..., None], m_f.reshape(B, K, D), m)
        s2 = torch.where(keep[..., None], s2_new.reshape(B, K, D), s2)
        lp = torch.where(keep, lp_new.reshape(B, K), lp)
    return torch.stack(ms, 1), torch.stack(s2s, 1), torch.stack(lps, 1)


def _reverse_tracks(arr, lengths):
    """Per-track time reversal of a padded (B, T, ...) array."""
    B, T = arr.shape[:2]
    idx = (lengths[:, None] - 1
           - torch.arange(T, device=arr.device)[None, :]).clamp(0, T - 1)
    idx = idx.reshape((B, T) + (1,) * (arr.ndim - 2)).expand(arr.shape)
    return torch.gather(arr, 1, idx)


def position_mixtures(positions, lengths, loc_err2, log_trans, sig2_states,
                      *, window: int = 7):
    """The full per-position true-position Gaussian mixture.

    Equivalent of the reference get_pos_PDF (refined_localization.py:
    207-302): at every localization, a mixture over state-matched
    (prefix-slot, suffix-slot) pairs; track ends mix over single-side
    slots, and a 1-frame track's position is its observation alone.

    Returns ``(mu (B,T,C,D), var (B,T,C,D), lw (B,T,C), labels (C,))`` with
    C = S*(K/S)^2 components, s-major; unused components carry -inf weight
    (ends populate components c = s*KS^2 + i*KS).  ``labels[c]`` is the
    hidden state of the position under component c.
    """
    B, T, D = positions.shape
    S = log_trans.shape[0]
    K = S ** window
    KS = K // S
    dev = positions.device
    lengths = lengths.to(device=dev, dtype=torch.int64)
    l2 = loc_err2.to(positions.dtype).expand(B, T, D)

    # prefix: priors from earlier positions (transitions in forward time)
    pm, ps2, plp = _refine_scan(positions, l2, lengths, log_trans,
                                sig2_states, window)
    # suffix: priors from later positions, the prefix scan on reversed
    # tracks with the transposed transition matrix
    # (refined_localization.py:216-218)
    sm, ss2, slp = _refine_scan(_reverse_tracks(positions, lengths),
                                _reverse_tracks(l2, lengths), lengths,
                                log_trans.T, sig2_states, window)
    sm = _reverse_tracks(sm, lengths)
    ss2 = _reverse_tracks(ss2, lengths)
    slp = _reverse_tracks(slp, lengths)

    x = positions[:, :, None, :]
    l2k = l2[:, :, None, :]

    # ---- end products: obs x prior from the single available side ------
    def prod2(m, s2, lp):
        tot = s2 + l2k
        mu = (x * s2 + m * l2k) / tot
        var = s2 * l2k / tot
        lw = lp + (-0.5 * torch.log(2 * math.pi * tot)
                   - (x - m) ** 2 / (2 * tot)).sum(-1)
        return mu, var, lw                          # (B,T,K,D) x2, (B,T,K)

    mu_s, var_s, lw_s = prod2(sm, ss2, slp)         # for k = 0
    mu_p, var_p, lw_p = prod2(pm, ps2, plp)         # for k = L-1
    # a 1-frame track has no side: its position is the observation
    lone = (lengths == 1)[:, None, None, None]
    mu_s = torch.where(lone, x.expand_as(mu_s), mu_s)
    var_s = torch.where(lone, l2k.expand_as(var_s), var_s)
    lw_s = torch.where(lone[..., 0], torch.zeros_like(lw_s), lw_s)

    # ---- interior: state-matched three-way products --------------------
    # slots are ordered newest-state-major: block s = slots [s*KS, (s+1)*KS)
    def blocks(a, extra):
        return a.reshape((B, T, S, KS) + extra)

    pmb, ps2b, plpb = blocks(pm, (D,)), blocks(ps2, (D,)), blocks(plp, ())
    smb, ss2b, slpb = blocks(sm, (D,)), blocks(ss2, (D,)), blocks(slp, ())

    # product of prefix and suffix priors (per state block, all slot pairs)
    v1 = ps2b[:, :, :, :, None, :]                  # (B,T,S,KS,1,D)
    v2 = ss2b[:, :, :, None, :, :]                  # (B,T,S,1,KS,D)
    m1 = pmb[:, :, :, :, None, :]
    m2 = smb[:, :, :, None, :, :]
    tot12 = v1 + v2
    mu12 = (m1 * v2 + m2 * v1) / tot12
    var12 = v1 * v2 / tot12
    lc12 = (-0.5 * torch.log(2 * math.pi * tot12)
            - (m1 - m2) ** 2 / (2 * tot12)).sum(-1)
    # then product with the observation
    xl = positions[:, :, None, None, None, :]       # (B,T,1,1,1,D)
    l2i = l2[:, :, None, None, None, :]
    tot_o = var12 + l2i
    mu_i = (xl * var12 + mu12 * l2i) / tot_o
    var_i = var12 * l2i / tot_o
    lw_i = (plpb[:, :, :, :, None] + slpb[:, :, :, None, :] + lc12
            + (-0.5 * torch.log(2 * math.pi * tot_o)
               - (xl - mu12) ** 2 / (2 * tot_o)).sum(-1))

    C = S * KS * KS
    mu_i = mu_i.reshape(B, T, C, D)
    var_i = var_i.reshape(B, T, C, D)
    lw_i = lw_i.reshape(B, T, C)

    # embed the K = S*KS end components at c = k*KS (slot k = s*KS + i)
    def embed(mu_e, var_e, lw_e):
        mu = torch.zeros_like(mu_i)
        var = torch.ones_like(var_i)
        lw = torch.full_like(lw_i, -math.inf)
        mu[:, :, ::KS] = mu_e
        var[:, :, ::KS] = var_e
        lw[:, :, ::KS] = lw_e
        return mu, var, lw

    mu_first, var_first, lw_first = embed(mu_s, var_s, lw_s)
    mu_last, var_last, lw_last = embed(mu_p, var_p, lw_p)

    k_idx = torch.arange(T, device=dev)[None, :]
    first = (k_idx == 0)[:, :, None]
    last = (k_idx == lengths[:, None] - 1)[:, :, None]

    # two-point tracks: both ends, no interior; 'first' takes precedence
    # at k=0 and 'last' at k=1
    def pick(a_first, a_last, a_int):
        extra = (1,) * (a_int.ndim - 3)
        return torch.where(first.reshape(first.shape + extra), a_first,
                           torch.where(last.reshape(last.shape + extra),
                                       a_last, a_int))

    mu = pick(mu_first, mu_last, mu_i)
    var = pick(var_first, var_last, var_i)
    lw = pick(lw_first, lw_last, lw_i)
    valid = (k_idx < lengths[:, None])[:, :, None]
    lw = torch.where(valid, lw, -math.inf)
    labels = torch.arange(S, device=dev).repeat_interleave(KS * KS)
    return mu, var, lw, labels


def _moment_match_mixture(mu, var, lw):
    """Posterior-weighted mean and variance of a padded Gaussian mixture
    over its component axis (axis 2)."""
    mx = lw.amax(dim=2, keepdim=True)
    w = torch.exp(lw - torch.where(torch.isfinite(mx), mx,
                                   torch.zeros_like(mx)))
    sw = w.sum(dim=2).clamp_min(_TINY)[..., None]               # (B,T,1)
    return ((w[..., None] * mu).sum(dim=2) / sw,
            (w[..., None] * var).sum(dim=2) / sw)


def refine_positions(positions, lengths, loc_err2, log_trans, sig2_states,
                     *, window: int = 7):
    """Refined per-localization position posteriors: the plain version of
    K6.

    Returns (mu (B,T,D), sigma (B,T,D)), the moment-matched mean and std
    of the true-position mixture at every localization
    (position_refinement, refined_localization.py:304-338); zeros past
    each track's length.
    """
    B, T, D = positions.shape
    lengths = lengths.to(device=positions.device, dtype=torch.int64)
    mu_c, var_c, lw, _ = position_mixtures(
        positions, lengths, loc_err2, log_trans, sig2_states, window=window)
    mu, var = _moment_match_mixture(mu_c, var_c, lw)
    valid = (torch.arange(T, device=positions.device)[None, :]
             < lengths[:, None])[..., None]
    zero = torch.zeros((), dtype=mu.dtype, device=mu.device)
    return torch.where(valid, mu, zero), torch.where(valid, var.sqrt(), zero)


def _pick_jb(KS: int) -> int:
    """The reference schedule's pair-chunk height: the largest divisor of
    K/S up to 16."""
    return next(j for j in range(min(16, KS), 0, -1) if KS % j == 0)


def _block_cap(T: int, D: int, K: int, KS: int, JB: int) -> int:
    """The reference schedule's track block: how many tracks (a multiple
    of 128) whose stash, register, combine precomputes, pair chunk and end
    products fit the schedule's budget."""
    per_track = 4 * ((2 * D + 1) * T * K + (2 * D + 1) * K
                     + (4 * D + 4) * K + 14 * KS * JB + 6 * K)
    return (_SCHEDULE_BUDGET // per_track) // 128 * 128


def default_window(nb_states: int, T: int = 16, D: int = 2) -> int:
    """Refinement window for ``nb_states`` states on tracks padded to ``T``
    frames in ``D`` dimensions: the JAX package's default schedule, not a
    budget of this card.  It is the largest window <= 7 (the reference's
    default) whose register of S**window slots would fit the TPU kernel's
    40 MiB scratch budget for 128 tracks, else 2 (7/5/4/3 for 2/3/4/5
    states at T=16, D=2).  ``position_refinement`` and ``refine_batch``
    call it with the batch's padded length and dimensions when
    ``frame_len`` is not given, so a refinement without ``frame_len``
    uses the reference's window.  Up to 64 states its register stays
    inside the CUDA kernel's 4096 slots (K6 maps past 1024 with a thread a
    fusion group; the largest default is 6^4 = 1296, 6 states on short
    1-D tracks); a window past 4096 slots raises on a CUDA bucket and
    names the largest window that fits."""
    S = int(nb_states)
    for w in range(7, 1, -1):
        K = S ** w
        if _block_cap(T, D, K, K // S, _pick_jb(K // S)) >= 128:
            return w
    return 2


def refine_batch(batch: tdata.TrackBatch, LocErr, ds, TrMat,
                 frame_len: Optional[int] = None,
                 compute_engine: str = "auto",
                 sharded=False):
    """TrackBatch-native refinement: (mu (B,T,D), sigma (B,T,D), B) as
    numpy arrays in the batch's dtype (copied from its device) and the
    number of tracks, as the JAX package returns them.  ``LocErr`` may be a
    scalar or array, or anything
    dict-like to signal that ``batch.loc_err`` holds per-peak errors.
    ``TrMat`` is the (S, S) transition probability matrix, ``ds`` the
    per-state step stds sqrt(2*D*dt).  ``frame_len`` defaults to
    ``default_window(S, batch.max_len, batch.nb_dims)``.  A forbidden
    transition (a zero in ``TrMat``) gets the finite log floor of
    ``tables.cap_log``.  ``compute_engine``: 'auto' or 'pallas' run K6 on
    a CUDA batch, 'xla' raises there; a CPU batch runs the plain version
    whatever the value.  ``sharded`` (True, or a ``parallel.mesh.Mesh``)
    splits the tracks over the mesh's shards, K6 on each
    (``mesh.sharded_refine``), the outputs in the batch's order; with a
    process group each process runs its part and every process gets the
    whole result."""
    from extrack_tpu_torch.ops import refine_kernel
    from extrack_tpu_torch.parallel import mesh as pmesh
    dev, dtype = batch.positions.device, batch.positions.dtype
    tdevice.check_compute_engine(compute_engine, dev, "refine_batch")

    def tensor(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                               device=dev)

    log_trans = cap_log(tensor(TrMat))
    S = log_trans.shape[0]
    window = frame_len or default_window(S, batch.max_len, batch.nb_dims)
    if isinstance(LocErr, dict) or (LocErr is None
                                    and batch.loc_err is not None):
        loc_err2 = batch.loc_err ** 2
    else:
        loc_err2 = tensor(LocErr) ** 2
        loc_err2 = loc_err2.reshape((1,) * (3 - loc_err2.ndim)
                                    + loc_err2.shape)
    if sharded:
        mu, sigma = pmesh.sharded_refine(
            batch.positions, batch.lengths, loc_err2, log_trans,
            tensor(ds) ** 2, window=window,
            mesh=pmesh.mesh_for(sharded, dev),
            process_local=batch.process_local)
    else:
        mu, sigma = refine_kernel.refine(
            batch.positions, batch.lengths, loc_err2, log_trans,
            tensor(ds) ** 2, window=window,
            what=f"refinement bucket of {batch.batch_size} tracks (pass "
                 "frame_len to choose the window)")
    return mu.cpu().numpy(), sigma.cpu().numpy(), batch.batch_size


def position_refinement(all_tracks: Dict[str, np.ndarray],
                        LocErr,
                        ds,
                        Fs,
                        TrMat,
                        frame_len: Optional[int] = None,
                        threshold: float = 0.1,
                        max_nb_states: int = 1000,
                        compute_engine: str = "auto",
                        sharded=False,
                        *,
                        device="cuda",
                        dtype=None
                        ) -> Tuple[Dict[str, np.ndarray],
                                   Dict[str, np.ndarray]]:
    """Reference-compatible entry point (refined_localization.py:304-338), on
    ``device`` (the card by default; ``device="cpu"`` runs the plain
    version) in ``dtype`` (float32 on CUDA, where K6 computes, float64
    elsewhere).

    ``ds`` are per-state step stds sqrt(2*D*dt); ``TrMat`` is the
    transition probability matrix; ``LocErr`` a scalar, or a length-keyed
    dict of per-peak errors.  ``Fs``, ``threshold`` and ``max_nb_states``
    are accepted for compatibility (fractions do not enter refinement and
    the fixed window replaces threshold pruning).  The tracks go into 4
    length buckets, one K6 launch each on the card.  Returns (mus, sigmas)
    dicts; sigmas follow the reference in reporting the first dimension's
    std per position.  ``frame_len`` defaults to ``default_window`` at the
    longest track and the tracks' dimensions, as the JAX package's
    one-batch entry point computes it; ``compute_engine`` and ``sharded``
    as ``refine_batch``.
    """
    del Fs, threshold, max_nb_states
    device, dtype = tdevice.resolve_device(device, dtype)
    if frame_len is None:       # the JAX package's window: one batch
        lens = [int(k) for k, v in all_tracks.items() if len(v)]
        D = np.shape(all_tracks[str(max(lens))])[-1] if lens else 2
        frame_len = default_window(np.shape(TrMat)[0], max(lens, default=1),
                                   D)
    batches = tdata.from_dict_bucketed(
        all_tracks, max_buckets=4,
        input_loc_err=LocErr if isinstance(LocErr, dict) else None,
        device=device, dtype=dtype)
    mus: Dict[str, np.ndarray] = {}
    sigmas: Dict[str, np.ndarray] = {}
    for b in batches:
        mu, sigma, _ = refine_batch(b, LocErr, ds, TrMat,
                                    frame_len=frame_len,
                                    compute_engine=compute_engine,
                                    sharded=sharded)
        mus.update(tdata.to_dict(b, mu))
        sigmas.update(tdata.to_dict(b, sigma[..., 0]))
    return mus, sigmas


# ---------------------------------------------------------------------------
# The raw mixture API (reference get_pos_PDF and its consumers), the
# fixed-state refinement and the rendering (extrack_tpu/refine.py:259-560,
# 742-784).  Plain torch where the JAX package computes in XLA; the
# posteriors of ``get_best_estimates`` run K4 on the card.

def _numpy_loc_err2(LocErr, device, dtype):
    """A scalar, (D,) or per-peak localization error as squared variances
    broadcastable to (B, T, D), leading axes prepended."""
    le2 = torch.as_tensor(np.asarray(LocErr, dtype=np.float64) ** 2,
                          dtype=dtype, device=device)
    return le2.reshape((1,) * (3 - le2.ndim) + tuple(le2.shape))


def get_pos_PDF(Cs, LocErr, ds, Fs, TrMat, frame_len: int = 7,
                threshold: float = 0.2, max_nb_states: int = 1000, *,
                device="cuda", dtype=None):
    """Per-position Gaussian mixtures for a rectangular track array, on
    ``device`` (the card by default) in ``dtype``.

    Reference-compatible wrapper (get_pos_PDF,
    refined_localization.py:207-302): returns ``(all_pos_means,
    all_pos_stds, all_pos_weights, all_pos_Bs)``, lists over positions of
    (n_tracks, C, D) means, (n_tracks, C, 1) stds, (n_tracks, C) log
    weights and (C,) state labels, as numpy arrays (``position_mixtures``;
    components with -inf weight are padding).  The fixed window replaces
    threshold pruning (``threshold``/``max_nb_states`` accepted for
    compatibility); ``Fs`` does not enter refinement.  A forbidden
    transition gets ``tables.cap_log``'s finite floor, as in
    ``refine_batch``."""
    del threshold, max_nb_states, Fs
    device, dtype = tdevice.resolve_device(device, dtype)
    Cs = np.asarray(Cs)
    n, T, D = Cs.shape

    def tensor(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                               device=device)

    mu, var, lw, labels = position_mixtures(
        tensor(Cs), torch.full((n,), T, device=device),
        _numpy_loc_err2(LocErr, device, dtype), cap_log(tensor(TrMat)),
        tensor(ds) ** 2, window=frame_len)
    mu, var, lw = (a.cpu().numpy() for a in (mu, var, lw))
    std = np.sqrt(var[..., :1])     # the reference's 1-column std
    labels = labels.cpu().numpy()
    return ([mu[:, k] for k in range(T)], [std[:, k] for k in range(T)],
            [lw[:, k] for k in range(T)], [labels for _ in range(T)])


def get_all_estimates(all_pos_weights, all_pos_Bs, all_pos_means,
                      all_pos_stds):
    """Maximum-weight mixture component per position.

    Reference: get_all_estimates, refined_localization.py:340-365.  Returns
    (best_mus (n, T, D), best_sigs (n, T, 1), best_Bs (n, T) int).
    """
    best_mus, best_sigs, best_Bs = [], [], []
    for w, Bs, mus, sigs in zip(all_pos_weights, all_pos_Bs, all_pos_means,
                                all_pos_stds):
        w = np.asarray(w)
        idx = np.argmax(w, axis=1)
        rows = np.arange(len(w))
        best_mus.append(np.asarray(mus)[rows, idx])
        best_sigs.append(np.asarray(sigs)[rows, idx])
        best_Bs.append(np.asarray(Bs)[idx] if np.ndim(Bs) == 1
                       else np.asarray(Bs)[rows, idx])
    return (np.stack(best_mus, axis=1), np.stack(best_sigs, axis=1),
            np.stack(best_Bs, axis=1).astype(int))


def get_global_sigs_mus(all_pos_means, all_pos_stds, all_pos_weights,
                        idx: int = 0):
    """Moment summary of one track's per-position mixtures.

    Reference: get_global_sigs_mus, refined_localization.py:521-533: means
    weighted by exp(LC), stds by exp(LC)^2 (the reference's formula, as
    it is).  Padding components (weight -inf) contribute zero.  Returns
    (w_mus (T, D), w_sigs (T,)).
    """
    w_mus, w_sigs = [], []
    for mus, sigs, LC in zip(all_pos_means, all_pos_stds, all_pos_weights):
        mus = np.asarray(mus)[idx]
        sigs = np.asarray(sigs)[idx]
        LC = np.asarray(LC)[idx]
        LC = LC - np.max(LC)
        w = np.exp(LC)[:, None]
        w_sigs.append(np.sum(w ** 2 * sigs) / np.sum(w ** 2))
        w_mus.append(np.sum(w * mus, axis=0) / np.sum(w, axis=0))
    return np.array(w_mus), np.array(w_sigs)


def matrix_tables(LocErr, ds, Fs, TrMat, device, dtype):
    """The model tables of ``get_best_estimates``, straight from the
    transition matrix as the JAX package builds them: pair variances
    from the step stds ``ds``, no survival (no cell); the end term is
    unread (no track is bleached) and pBL 0.1 keeps it finite."""
    from extrack_tpu_torch.core.tables import build_tables

    def tensor(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                               device=device)

    ds2 = np.asarray(ds, dtype=np.float64) ** 2
    S = ds2.shape[0]
    return build_tables(tensor(np.zeros(S)), tensor(LocErr), tensor(Fs),
                        tensor(np.zeros((S, S))), 0.1, 1.0,
                        cell_dims=())._replace(
        log_trans=torch.log(tensor(TrMat)),
        sig2=tensor(0.5 * (ds2[:, None] + ds2[None, :])).reshape(1, -1))


def get_best_estimates(Cs, LocErr, ds, Fs, TrMat, frame_len: int = 10, *,
                       device="cuda", dtype=None):
    """Refined positions for the argmax-posterior state sequence, on
    ``device`` (the card by default) in ``dtype``.

    Reference: get_best_estimates, refined_localization.py:551-559: the
    per-frame state posteriors (window min(frame_len, 8), one K4 launch on
    the card, ``predict_kernel.predict``, on ``matrix_tables``), their
    argmax states, then the fixed-state refinement.  (The reference's loop
    keeps only the last track; all tracks are returned, as the JAX package
    does.)  Returns (mus (n, T, D), sigs (n, T, D)) as numpy arrays.
    """
    from extrack_tpu_torch.ops import predict_kernel
    device, dtype = tdevice.resolve_device(device, dtype)
    n, T, _ = np.shape(Cs)
    tb = matrix_tables(LocErr, ds, Fs, TrMat, device, dtype)
    positions = torch.as_tensor(np.asarray(Cs, dtype=np.float64),
                                dtype=dtype, device=device)
    lengths = torch.full((n,), T, dtype=torch.int32, device=device)
    _, preds = predict_kernel.predict(
        positions, lengths, torch.zeros(n, dtype=dtype, device=device), tb,
        window=min(frame_len, 8), min_len=2)
    mus, sigs = refine_positions_fixed_states(
        positions, lengths, tb.loc_err2,
        torch.as_tensor(np.asarray(ds, dtype=np.float64) ** 2, dtype=dtype,
                        device=device), torch.argmax(preds, dim=2))
    return mus.cpu().numpy(), sigs.cpu().numpy()


def refine_positions_fixed_states(positions, lengths, loc_err2, sig2_states,
                                  states):
    """Refined positions for known state sequences (one Gaussian per
    position, no mixture): the reference's fixed-Bs variant
    (get_pos_PDF_fixedBs, refined_localization.py:483-519), typically fed
    with argmax-of-posterior states.  A forward and a backward Kalman pass
    (the backward one on per-track reversed tracks), then the
    precision-weighted product with the observation.

    states: (B, T) integer per-frame states.  Returns (mu (B,T,D),
    sigma (B,T,D)), zeros past each track's length.
    """
    B, T, D = positions.shape
    dev, dtype = positions.device, positions.dtype
    lengths = lengths.to(device=dev, dtype=torch.int64)
    l2 = loc_err2.to(dtype).expand(B, T, D)
    d2 = sig2_states.to(dtype)[states.to(device=dev, dtype=torch.int64)]
    sig2_step = 0.5 * (d2[:, :-1] + d2[:, 1:])              # (B, T-1)

    def one_direction(pos, l2_, s2step):
        # the prior (m, s2) of r_t given x_{<t}, for t = 1 .. T-1
        m = pos[:, 0]
        s2 = l2_[:, 0] + s2step[:, 0][:, None]
        s2pad = torch.cat([s2step, s2step[:, -1:]], dim=1)
        ms, s2s = [torch.zeros_like(m)], [torch.zeros_like(s2)]
        for t in range(1, T):
            ms.append(m)
            s2s.append(s2)
            x_t, l2_t = pos[:, t], l2_[:, t]
            tot = l2_t + s2
            new_m = (m * l2_t + x_t * s2) / tot
            new_s2 = s2pad[:, t][:, None] + l2_t * s2 / tot
            live = (t < lengths - 1)[:, None]
            m = torch.where(live, new_m, m)
            s2 = torch.where(live, new_s2, s2)
        return torch.stack(ms, 1), torch.stack(s2s, 1)

    pm, ps2 = one_direction(positions, l2, sig2_step)
    # sig2_step[t] is the edge t -> t+1: the reversed track's edge k is
    # the original edge L-2-k, so the edges reverse with L-1 of them
    rstep = _reverse_tracks(sig2_step, (lengths - 1).clamp_min(1))
    sm, ss2 = one_direction(_reverse_tracks(positions, lengths),
                            _reverse_tracks(l2, lengths), rstep)
    sm = _reverse_tracks(sm, lengths)
    ss2 = _reverse_tracks(ss2, lengths)

    k_idx = torch.arange(T, device=dev)[None, :]
    first = (k_idx == 0)[..., None]
    last = (k_idx == lengths[:, None] - 1)[..., None]
    zero = torch.zeros((), dtype=dtype, device=dev)
    # the precision-weighted product of the terms present (the
    # observation always)
    prec = 1.0 / l2
    mu_num = positions * prec
    prec = prec + torch.where(first, zero, 1.0 / ps2.clamp_min(_TINY))
    mu_num = mu_num + torch.where(first, zero, pm / ps2.clamp_min(_TINY))
    prec = prec + torch.where(last, zero, 1.0 / ss2.clamp_min(_TINY))
    mu_num = mu_num + torch.where(last, zero, sm / ss2.clamp_min(_TINY))
    var = 1.0 / prec
    mu = mu_num * var
    valid = (k_idx < lengths[:, None])[..., None]
    return torch.where(valid, mu, zero), torch.where(valid, var.sqrt(), zero)


def save_gifs(all_tracks: Dict[str, np.ndarray],
              mus: Dict[str, np.ndarray],
              sigmas: Dict[str, np.ndarray],
              gif_pathnames: str = "./tracks",
              nb_pix: int = 200,
              fps: int = 1,
              max_tracks: int = 3):
    """Render per-position refined-position PDFs as animated GIFs: the
    moment-matched Gaussian of each position over the observed track
    (save_gifs, refined_localization.py:367-411).  Host numpy, matplotlib
    and imageio (imported here, so that the package needs neither)."""
    import matplotlib
    matplotlib.use("Agg")
    import imageio
    from matplotlib import pyplot as plt

    for key in all_tracks:
        for i in range(min(len(all_tracks[key]), max_tracks)):
            track = all_tracks[key][i]
            mu = mus[key][i]
            sig = np.broadcast_to(np.asarray(sigmas[key][i]).reshape(
                len(track), -1)[:, :1], (len(track), 1))
            lim = np.abs(track - track.mean(0)).max() * 1.2 + 1e-6
            grid = np.linspace(-lim, lim, nb_pix)
            frames = []
            for k in range(len(track)):
                fig, ax = plt.subplots(figsize=(4, 4))
                gx = np.exp(-(grid[None, :] - (mu[k, 0] - track[:, 0].mean()))
                            ** 2 / (2 * sig[k, 0] ** 2))
                gy = np.exp(-(grid[:, None] - (mu[k, 1] - track[:, 1].mean()))
                            ** 2 / (2 * sig[k, 0] ** 2))
                ax.imshow(gy * gx, extent=[-lim, lim, -lim, lim],
                          origin="lower", cmap="hot")
                ax.plot(track[:, 0] - track[:, 0].mean(),
                        track[:, 1] - track[:, 1].mean(), "c.-", lw=0.8)
                ax.set_title(f"position {k}")
                fig.canvas.draw()
                frames.append(np.asarray(fig.canvas.buffer_rgba())[:, :, :3])
                plt.close(fig)
            imageio.mimsave(f"{gif_pathnames}{key}_{i}.gif", frames,
                            duration=1000.0 / max(fps, 1))


def refinement_args(params, nb_states: int, dt: float):
    """``position_refinement``'s model arguments from fitted parameters (a
    Parameters object or a resolved values dict): (LocErr, ds, Fs, TrMat)
    with LocErr the first localization error as a float, ds = sqrt(2 D
    dt) per state and TrMat the per-frame transition matrix, numpy in
    float64, as the JAX package's entry points compute them."""
    from extrack_tpu_torch import params as tparams
    from extrack_tpu_torch.core.tables import transition_matrix
    vals = params.resolve() if hasattr(params, "resolve") else params
    Ds, Fs, rates, loc_err, _ = tparams.extract_arrays(vals, nb_states)
    tr = transition_matrix(rates).numpy()
    ds = np.sqrt(2.0 * Ds.numpy() * dt)
    return float(loc_err.reshape(-1)[0]), ds, Fs.numpy(), tr


def do_gifs_from_params(all_tracks, params, dt, gif_pathnames="./tracks",
                        frame_len: int = 7, nb_states: int = 2,
                        nb_pix: int = 200, fps: int = 1,
                        max_tracks: int = 3, *, device="cuda", dtype=None):
    """Refine (``position_refinement`` on ``device``: K6 on the card) and
    render per-position PDF GIFs straight from fitted parameters
    (do_gifs_from_params, refined_localization.py:562-566)."""
    loc_err, ds, Fs, tr = refinement_args(params, nb_states, dt)
    mus, sigmas = position_refinement(
        all_tracks, loc_err, ds, Fs, tr, frame_len=frame_len,
        device=device, dtype=dtype)
    save_gifs(all_tracks, mus, sigmas, gif_pathnames=gif_pathnames,
              nb_pix=nb_pix, fps=fps, max_tracks=max_tracks)


def full_extrack_2_matrix(all_tracks, params, dt, all_frames=None,
                          cell_dims=(1.0, None, None), nb_states: int = 2,
                          frame_len: int = 15, *, device=None, dtype=None):
    """Predict states, refine positions, and flatten everything into one
    DataFrame [x, y, frame, track_id, pred_0.., X_REFINED, Y_REFINED,
    SIGMA_REFINED] (full_extrack_2_matrix, refined_localization.py:
    536-549), on ``device`` (the card by default: K4, then K6).

    The posteriors take ``predict_Bs`` at ``min(frame_len, 8)``, the
    refinement ``position_refinement`` at ``frame_len // 2 + 3`` (10 at
    the default 15), as the JAX package does.  From 3 states on that
    window passes K6's 4096 slots (3^10 = 59049), and a CUDA bucket
    raises naming K6: pass a smaller ``frame_len``."""
    from extrack_tpu_torch import predict
    from extrack_tpu_torch.io import exporters
    preds = predict.predict_Bs(all_tracks, dt, params, cell_dims=cell_dims,
                               nb_states=nb_states,
                               frame_len=min(frame_len, 8), device=device,
                               dtype=dtype)
    loc_err, ds, Fs, tr = refinement_args(params, nb_states, dt)
    mus, sigmas = position_refinement(
        all_tracks, loc_err, ds, Fs, tr, frame_len=frame_len // 2 + 3,
        device=device, dtype=dtype)
    df = exporters.extrack_2_pandas(all_tracks, preds, frames=all_frames)
    df["X_REFINED"] = np.concatenate([mus[k][:, :, 0].reshape(-1)
                                      for k in all_tracks])
    df["Y_REFINED"] = np.concatenate([mus[k][:, :, 1].reshape(-1)
                                      for k in all_tracks])
    df["SIGMA_REFINED"] = np.concatenate(
        [np.asarray(sigmas[k]).reshape(-1) for k in all_tracks])
    return df


# ---------------------------------------------------------------------------
# Reference-named Gaussian-product helpers (extrack/refined_localization.py:
# 33-46): numpy in, numpy out, over core.gaussian on the CPU in float64.

def _f64(*arrays):
    return [torch.as_tensor(np.asarray(a, dtype=np.float64)) for a in arrays]


def prod_2GaussPDF(sigma1, sigma2, mu1, mu2):
    """Product of two Gaussian PDFs -> (sigma, mu, log_const); log_const is
    summed over the trailing spatial axis (refined_localization.py:33-37)."""
    return tuple(a.numpy() for a in gaussian_ops.product_2(
        *_f64(sigma1, sigma2, mu1, mu2)))


def prod_3GaussPDF(sigma1, sigma2, sigma3, mu1, mu2, mu3):
    """Product of three Gaussian PDFs (refined_localization.py:39-43)."""
    return tuple(a.numpy() for a in gaussian_ops.product_3(
        *_f64(sigma1, sigma2, sigma3, mu1, mu2, mu3)))


def gaussian(x, sig, mu):
    """Isotropic Gaussian density, product over the trailing spatial axis
    (refined_localization.py:45-46)."""
    x, sig, mu = np.asarray(x), np.asarray(sig), np.asarray(mu)
    return np.prod(np.exp(-(x - mu) ** 2 / (2 * sig ** 2))
                   / np.sqrt(2 * np.pi * sig ** 2), axis=-1)


def get_pos_PDF_fixedBs(Cs, LocErr, ds, Fs, TrMat, Bs, *, device="cuda",
                        dtype=None):
    """Refined (mu, sigma) per position for a known state sequence, on
    ``device`` in ``dtype``: the reference signature and its single-track
    return (get_pos_PDF_fixedBs, refined_localization.py:483-519), the
    first track's (T, D) means and (T, D) stds as numpy.  ``Fs`` and
    ``TrMat`` are accepted for compatibility (the fixed-sequence posterior
    does not depend on them); ``Bs`` may be (B, T) or the reference's
    (B, 1, T)."""
    del Fs, TrMat
    device, dtype = tdevice.resolve_device(device, dtype)
    Cs = np.asarray(Cs, dtype=np.float64)
    B, T, D = Cs.shape
    Bs = np.asarray(Bs)
    if Bs.ndim == 3:
        Bs = Bs[:, 0]
    mu, sigma = refine_positions_fixed_states(
        torch.as_tensor(Cs, dtype=dtype, device=device),
        torch.full((B,), T, device=device),
        _numpy_loc_err2(LocErr, device, dtype),
        torch.as_tensor(np.asarray(ds, dtype=np.float64) ** 2, dtype=dtype,
                        device=device),
        torch.as_tensor(Bs, device=device))
    return mu[0].cpu().numpy(), sigma[0].cpu().numpy()
