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
                 sharded: bool = False):
    """TrackBatch-native refinement: (mu (B,T,D), sigma (B,T,D)) on the
    batch's device.  ``LocErr`` may be a scalar or array, or anything
    dict-like to signal that ``batch.loc_err`` holds per-peak errors.
    ``TrMat`` is the (S, S) transition probability matrix, ``ds`` the
    per-state step stds sqrt(2*D*dt).  ``frame_len`` defaults to
    ``default_window(S, batch.max_len, batch.nb_dims)``.  A forbidden
    transition (a zero in ``TrMat``) gets the finite log floor of
    ``tables.cap_log``.  ``compute_engine``: 'auto' or 'pallas' run K6 on
    a CUDA batch, 'xla' raises there; a CPU batch runs the plain version
    whatever the value.  ``sharded=True`` (several devices) is not ported
    yet and raises."""
    from extrack_tpu_torch.ops import refine_kernel
    if sharded:
        raise NotImplementedError(
            "sharded refinement waits for the torch.distributed port "
            "(ROADMAP Queue 1)")
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
    return refine_kernel.refine(
        batch.positions, batch.lengths, loc_err2, log_trans, tensor(ds) ** 2,
        window=window, what=f"refinement bucket of {batch.batch_size} tracks "
                            "(pass frame_len to choose the window)")


def position_refinement(all_tracks: Dict[str, np.ndarray],
                        LocErr,
                        ds,
                        Fs,
                        TrMat,
                        frame_len: Optional[int] = None,
                        threshold: float = 0.1,
                        max_nb_states: int = 1000,
                        compute_engine: str = "auto",
                        sharded: bool = False,
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
        mu, sigma = refine_batch(b, LocErr, ds, TrMat, frame_len=frame_len,
                                 compute_engine=compute_engine,
                                 sharded=sharded)
        mus.update(tdata.to_dict(b, mu))
        sigmas.update(tdata.to_dict(b, sigma[..., 0]))
    return mus, sigmas
