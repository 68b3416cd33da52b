"""NumPy transcription of the reference's growing-register recursion.

The port's own copy of the JAX package's ``extrack_tpu/baselines.py``:
importing that module runs ``extrack_tpu/__init__.py``, which imports JAX,
and the port imports nothing of the JAX package.  Numpy and scipy only,
the same arithmetic in the same order, so both give the same numbers bit
for bit (tests/test_torch_baselines.py).

An lmfit-free, vectorized re-implementation of the algorithm of
``P_Cs_inter_bound_stats`` (reference extrack/tracking.py:109-318) — the
fixed-``frame_len`` fusion path.  It is the port's PARITY BASELINE: the
port's plain engine (``core.engine.forward``) is held to it in float64 at
<= 1e-9 in the pruned regime, frame_len < track length, which the
exact-enumeration oracle cannot cover (tests/test_torch_baselines.py).  It
is never on any production path.

Representation: the register holds all state sequences of the current
width ``w``; sequence index digits are least-significant = newest (the
reference's get_all_Bs convention, tracking.py:746-757).  Growing appends
new newest digits in the LSB (index k' = k_old * S**n + a, matching the
reference's ``cp.repeat``), and fixed-window fusion moment-matches over
the most-significant (oldest) digit axis (fuse_tracks_general with
fuse_pos = oldest, tracking.py:361-423).

``end_pattern`` selects the end-term survival indexing: "full" uses the
full pattern of new sub-states (consistent with the in-loop survival
term; what the port's engine and kernels implement); "reference"
reproduces the reference's literal indexing ``p_stay[cur_states[..., 0]]``
(tracking.py:303) which collapses to the newest digit only — identical
for nb_substeps=1, an upstream inconsistency for nb_substeps >= 2.
"""
import numpy as np
from scipy.stats import norm


def _codes_lsb(S, w):
    """(S**w, w) digit matrix, column j = j-th base-S digit (LSB first)."""
    k = np.arange(S ** w)
    return (k[:, None] // S ** np.arange(w)[None, :]) % S


def _logsumexp(a, axis):
    mx = np.max(a, axis=axis, keepdims=True)
    return (np.log(np.sum(np.exp(a - mx), axis=axis))
            + np.squeeze(mx, axis=axis))


def reference_log_likelihood(Cs, loc_err, ds, Fs, TrMat, pBL=0.1, isBL=1,
                             cell_dims=(0.5,), nb_substeps=1, frame_len=4,
                             min_len=3, end_pattern="full"):
    """Per-track log likelihood, reference algorithm (growing register).

    Cs (B, T, D); loc_err scalar or (B, T, D) per-peak stds; ds (S,) step
    stds sqrt(2 D dt); Fs (S,); TrMat (S, S) row-stochastic.
    """
    Cs = np.asarray(Cs, dtype=np.float64)
    B, T, D = Cs.shape
    S = TrMat.shape[0]
    n = nb_substeps
    A = S ** n
    ds2 = np.asarray(ds, dtype=np.float64) ** 2
    logT = np.log(np.asarray(TrMat, dtype=np.float64))
    if np.ndim(loc_err) == 0:
        le2 = np.full((B, T, D), float(loc_err) ** 2)
    else:
        le2 = np.asarray(loc_err, dtype=np.float64) ** 2

    def chain(dig):
        lt = np.zeros(len(dig))
        for j in range(dig.shape[1] - 1):
            lt = lt + logT[dig[:, j + 1], dig[:, j]]
        return lt

    def pair_var(dig):
        v = ds2[dig]
        return np.mean((v[:, 1:] + v[:, :-1]) / 2.0, axis=1)

    # survival per pattern of the n new sub-states (tracking.py:186-192)
    sub = _codes_lsb(S, n)
    sub_d = np.sqrt(np.mean(ds2[sub], axis=1))
    p_stay = np.ones(A)
    for L in cell_dims:
        if L is None:
            continue
        xs = np.linspace(L / 2000, L - L / 2000, 1000)
        p_stay = p_stay * np.mean(
            norm.cdf((L - xs[:, None]) / (sub_d + 1e-200))
            - norm.cdf(-xs[:, None] / (sub_d + 1e-200)), axis=0)
    lp_stay = np.log(p_stay * (1.0 - pBL))

    def pattern_index(dig_n):
        return dig_n @ (S ** np.arange(n))

    # ---- init: first position, width n+1 ----------------------------------
    dig = _codes_lsb(S, n + 1)
    LP = np.broadcast_to(chain(dig) + np.log(Fs)[dig[:, -1]],
                         (B, len(dig))).copy()
    d2 = pair_var(dig)
    m = np.broadcast_to(Cs[:, 0][:, None], (B, len(dig), D)).copy()
    s2 = np.broadcast_to(le2[:, 0][:, None] + d2[None, :, None],
                         (B, len(dig), D)).copy()

    def gauss_update(x, le2_t, m, s2, d2_new):
        tot = s2 + le2_t[:, None]
        lc = np.sum(-0.5 * np.log(2 * np.pi * tot)
                    - (x[:, None] - m) ** 2 / (2 * tot), axis=2)
        m_new = (m * le2_t[:, None] + x[:, None] * s2) / tot
        s2_new = d2_new[None, :, None] + le2_t[:, None] * s2 / tot
        return m_new, s2_new, lc

    def grow(dig, m, s2, LP):
        new = np.concatenate(
            [np.tile(_codes_lsb(S, n), (len(dig), 1)),
             np.repeat(dig, A, axis=0)], axis=1)
        return (new, np.repeat(m, A, axis=1), np.repeat(s2, A, axis=1),
                np.repeat(LP, A, axis=1))

    def fuse_oldest(dig, m, s2, LP):
        w = dig.shape[1]
        nrest = len(dig) // S
        LPv = LP.reshape(B, S, nrest)
        mx = LPv.max(axis=1, keepdims=True)
        wgt = np.exp(LPv - mx)
        sw = wgt.sum(axis=1, keepdims=True)
        wn = (wgt / sw)[..., None]
        m = np.sum(wn * m.reshape(B, S, nrest, D), axis=1)
        s2 = np.sum(wn * s2.reshape(B, S, nrest, D), axis=1)
        LP = np.log(sw[:, 0]) + mx[:, 0]
        return dig[:nrest, :w - 1], m, s2, LP

    # ---- main loop: positions 1 .. T-2 -------------------------------------
    for step in range(2, T):
        dig, m, s2, LP = grow(dig, m, s2, LP)
        head = dig[:, :n + 1]
        d2_new = pair_var(head)
        lt = chain(head)
        m, s2, lc = gauss_update(Cs[:, step - 1], le2[:, step - 1],
                                 m, s2, d2_new)
        ll = lp_stay[pattern_index(dig[:, :n])] if step >= min_len else 0.0
        LP = LP + lt[None] + lc + ll
        if step < T - 1:
            while len(dig) > S ** frame_len:
                dig, m, s2, LP = fuse_oldest(dig, m, s2, LP)

    # ---- end: bleach/leave term + last position ----------------------------
    if isBL:
        dig, m, s2, LP = grow(dig, m, s2, LP)
        lt = chain(dig[:, :n + 1])
        if end_pattern == "full":
            end_p = p_stay[pattern_index(dig[:, :n])]
        else:                      # reference literal: newest digit only
            end_p = p_stay[dig[:, 0]]
        ll_end = np.log(pBL + (1 - end_p) * (1 - pBL)) + lt
    else:
        ll_end = 0.0
    tot = s2 + le2[:, T - 1][:, None]
    lc = np.sum(-0.5 * np.log(2 * np.pi * tot)
                - (Cs[:, T - 1][:, None] - m) ** 2 / (2 * tot), axis=2)
    LP = LP + lc + ll_end
    return _logsumexp(LP, axis=1)


def reference_log_likelihood_th(Cs, loc_err, ds, Fs, TrMat, pBL=0.1, isBL=1,
                                cell_dims=(0.5,), nb_substeps=1,
                                frame_len=6, min_len=3, threshold=0.2,
                                max_nb_states=120):
    """Per-track log likelihood under the reference's DEFAULT pruning: the
    similarity-threshold greedy grouping of ``P_Cs_inter_bound_stats_th`` +
    ``fuse_tracks_th`` (extrack/tracking.py:427-650,652-743), transcribed
    for the window-vs-threshold accuracy comparison (DEVIATIONS.md 1).

    Faithful behaviors: grouping decided from the first 30 tracks of the
    chunk and applied chunk-wide; seeds group sequences that match the
    newest state AND are within ``threshold`` on mean |dm|/s and |dsig|/s
    (fractions > 0.8), OR share the newest ``frame_len`` argmax states;
    the threshold ratchets x1.2 whenever the register tops
    ``max_nb_states``; state histories are fused by unweighted member
    means (the do_preds=0 fitting path); end term uses the full new
    sub-state pattern.
    """
    Cs = np.asarray(Cs, dtype=np.float64)
    B, T, D = Cs.shape
    S = TrMat.shape[0]
    n = nb_substeps
    A = S ** n
    ds2 = np.asarray(ds, dtype=np.float64) ** 2
    logT = np.log(np.asarray(TrMat, dtype=np.float64))
    if np.ndim(loc_err) == 0:
        le2 = np.full((B, T, D), float(loc_err) ** 2)
    else:
        le2 = np.asarray(loc_err, dtype=np.float64) ** 2
    chunks = min(30, B)

    def chain(dig):
        lt = np.zeros(len(dig))
        for j in range(dig.shape[1] - 1):
            lt = lt + logT[dig[:, j + 1], dig[:, j]]
        return lt

    def pair_var(dig):
        v = ds2[dig]
        return np.mean((v[:, 1:] + v[:, :-1]) / 2.0, axis=1)

    sub = _codes_lsb(S, n)
    sub_d = np.sqrt(np.mean(ds2[sub], axis=1))
    p_stay = np.ones(A)
    for L in cell_dims:
        if L is None:
            continue
        xs = np.linspace(L / 2000, L - L / 2000, 1000)
        p_stay = p_stay * np.mean(
            norm.cdf((L - xs[:, None]) / (sub_d + 1e-200))
            - norm.cdf(-xs[:, None] / (sub_d + 1e-200)), axis=0)
    lp_stay = np.log(p_stay * (1.0 - pBL))

    def pattern_index(dig_n):
        return dig_n @ (S ** np.arange(n))

    def grow(dig, hist, m, s2, LP):
        new_dig = np.concatenate(
            [np.tile(_codes_lsb(S, n), (len(dig), 1)),
             np.repeat(dig, A, axis=0)], axis=1)
        # _codes_lsb is already newest-first (column 0 = newest sub-state,
        # matching chain()'s transition order and the new_dig layout)
        new_states = _codes_lsb(S, n)
        onehot = (new_states[:, :, None]
                  == np.arange(S)[None, None]).astype(np.float64)
        hist = np.concatenate(
            [np.tile(onehot, (len(dig), 1, 1)),
             np.repeat(hist, A, axis=0)], axis=1)
        return (new_dig, hist, np.repeat(m, A, axis=1),
                np.repeat(s2, A, axis=1), np.repeat(LP, A, axis=1))

    def fuse_threshold(dig, hist, m, s2, LP, th):
        """Greedy grouping of fuse_tracks_th (tracking.py:652-743)."""
        nb = len(dig)
        s_arr = np.sqrt(s2[:chunks])                   # (chunks, nb, D)
        m_c = m[:chunks]
        top = np.argmax(hist[:, 0], axis=1)            # newest state
        deep = hist.shape[1] > frame_len
        if deep:
            codes_fl = np.argmax(hist[:, :frame_len], axis=2)   # (nb, fl)
        grouped = np.zeros(nb, dtype=bool)
        groups = []
        for i in range(nb):
            if grouped[i]:
                continue
            dm = np.mean(np.abs(m_c - m_c[:, i:i + 1]), 2, keepdims=True)
            m_mask = np.mean(dm / s_arr < th, (0, 2)) > 0.8
            dsg = np.mean(np.abs(s_arr - s_arr[:, i:i + 1]), 2,
                          keepdims=True)
            s_mask = np.mean(dsg / s_arr < th, (0, 2)) > 0.8
            mask = m_mask & s_mask & (top == top[i])
            if deep:
                mask = mask | np.all(codes_fl == codes_fl[i], axis=1)
            args = np.where(mask & ~grouped)[0]
            grouped[args] = True
            groups.append(args)
        ng = len(groups)
        new_dig = np.stack([dig[g[0]] for g in groups])
        new_hist = np.stack([hist[g].mean(0) for g in groups])
        new_m = np.empty((B, ng, D))
        new_s2 = np.empty((B, ng, D))
        new_LP = np.empty((B, ng))
        for j, g in enumerate(groups):
            mx = LP[:, g].max(axis=1, keepdims=True)
            w = np.exp(LP[:, g] - mx)
            sw = w.sum(axis=1, keepdims=True)
            new_m[:, j] = np.sum(w[:, :, None] * m[:, g], 1) / sw
            new_s2[:, j] = np.sum(w[:, :, None] * s2[:, g], 1) / sw
            new_LP[:, j] = np.log(sw[:, 0]) + mx[:, 0]
        return new_dig, new_hist, new_m, new_s2, new_LP

    # ---- init --------------------------------------------------------------
    dig = _codes_lsb(S, n + 1)
    hist = (dig[:, :, None] == np.arange(S)[None, None]).astype(np.float64)
    LP = np.broadcast_to(chain(dig) + np.log(Fs)[dig[:, -1]],
                         (B, len(dig))).copy()
    d2 = pair_var(dig)
    m = np.broadcast_to(Cs[:, 0][:, None], (B, len(dig), D)).copy()
    s2 = np.broadcast_to(le2[:, 0][:, None] + d2[None, :, None],
                         (B, len(dig), D)).copy()

    def gauss_update(x, le2_t, m, s2, d2_new):
        tot = s2 + le2_t[:, None]
        lc = np.sum(-0.5 * np.log(2 * np.pi * tot)
                    - (x[:, None] - m) ** 2 / (2 * tot), axis=2)
        m_new = (m * le2_t[:, None] + x[:, None] * s2) / tot
        s2_new = d2_new[None, :, None] + le2_t[:, None] * s2 / tot
        return m_new, s2_new, lc

    th = float(threshold)
    for step in range(2, T):
        dig, hist, m, s2, LP = grow(dig, hist, m, s2, LP)
        head = dig[:, :n + 1]
        d2_new = pair_var(head)
        lt = chain(head)
        m, s2, lc = gauss_update(Cs[:, step - 1], le2[:, step - 1],
                                 m, s2, d2_new)
        ll = lp_stay[pattern_index(dig[:, :n])] if step >= min_len else 0.0
        LP = LP + lt[None] + lc + ll
        if len(dig) > max_nb_states:
            th = th * 1.2                              # tracking.py:581-583
        if step < T - 1:
            dig, hist, m, s2, LP = fuse_threshold(dig, hist, m, s2, LP, th)
            hist = hist[:, :frame_len]                 # do_preds=0 path

    if isBL:
        dig, hist, m, s2, LP = grow(dig, hist, m, s2, LP)
        lt = chain(dig[:, :n + 1])
        end_p = p_stay[pattern_index(dig[:, :n])]      # full new pattern
        ll_end = np.log(pBL + (1 - end_p) * (1 - pBL)) + lt
    else:
        ll_end = 0.0
    tot = s2 + le2[:, T - 1][:, None]
    lc = np.sum(-0.5 * np.log(2 * np.pi * tot)
                - (Cs[:, T - 1][:, None] - m) ** 2 / (2 * tot), axis=2)
    LP = LP + lc + ll_end
    return _logsumexp(LP, axis=1)
