"""Fixed-width sequence-register likelihood engine (plain PyTorch).

The reference computes per-track likelihoods with a per-frame recursion whose
working set of candidate state sequences grows and is then pruned by greedy
fusion (extrack/tracking.py:427-743).  This engine uses the fixed point of
that process: a register of K = S**W state windows (W = ``frame_len`` in the
reference), updated by one fused branch(xS^n) -> Gaussian update ->
moment-match(/S^n) step per frame.  Early steps, where the reference register
is still small, are reproduced exactly by starting the K slots as duplicated
copies carrying a ``-r*log(S)`` offset.  The reference skips the fusion at its
last loop step (tracking.py:255), so each track closes one step early, on the
pre-fusion children of step L-2; 2-frame tracks close on the register itself.

This module is the plain version of the forward kernel (ops/forward_kernel),
through autograd of the gradient and Hessian-vector-product kernels
(ops/grad_kernel, ops/hvp_kernel), and with ``return_preds=True`` of the
posterior kernel (ops/predict_kernel).  It runs on any device and dtype; the
kernels run float32 on CUDA.

Layout: working arrays keep the track axis last, (D, K, B) and (K, B), the
same layout as the JAX engine, so the two transcribe line by line.  Slot
``k = g*A + o`` holds group ``g`` (the W-n newest digits) and the n oldest
digits ``o``; the children of group g under new pattern a land at
``a*G + g``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from extrack_tpu_torch.core.tables import (ModelTables, branch_log_trans,
                                           init_log_prob, state_codes)


def _tiny(dtype) -> float:
    """Division/log guard that does not underflow in the working dtype
    (a literal 1e-300 is 0.0 in float32 and turns an all-floor fusion group
    into 0/0)."""
    return torch.finfo(dtype).tiny


class RegisterSpec(NamedTuple):
    """Static index constants of the sequence register."""
    S: int          # states
    W: int          # window width in sub-steps (frame_len)
    n: int          # sub-steps per frame
    K: int          # S**W register slots
    A: int          # S**n branch patterns
    G: int          # K // A surviving group count
    codes: np.ndarray       # (K, W) digits, newest first
    prev0_g: np.ndarray     # (G,) newest state of parent group g
    prev0_k: np.ndarray     # (K,) newest state of slot k
    init_pat: np.ndarray    # (K,) index of top n+1 digits (init pattern)
    dummy_digits: int       # W - n - 1


def make_register_spec(nb_states: int, window: int, nb_substeps: int = 1
                       ) -> RegisterSpec:
    S, W, n = nb_states, window, nb_substeps
    if W < n + 1:
        raise ValueError(f"window ({W}) must be >= nb_substeps+1 ({n + 1})")
    K = S ** W
    A = S ** n
    G = K // A
    codes = state_codes(S, W)
    top = S ** (W - n - 1)          # slots per pattern of the n+1 newest
    return RegisterSpec(S, W, n, K, A, G, codes, np.arange(G) // top,
                        codes[:, 0], np.arange(K) // top, W - n - 1)


def _masked_max(x: torch.Tensor, dim, keepdim: bool = True) -> torch.Tensor:
    """Max shift for a log-sum-exp: detached (the result does not depend
    on it) and 0 where the max is not finite."""
    mx = x.detach().amax(dim=dim, keepdim=keepdim)
    return torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))


def branch_fuse(lp, lc, new_m, tail, sig2_ag, gate, lt_b, lsurv_b, G, A):
    """Branch into the S^n children and fuse the oldest digits by weighted
    moment match.

    lp/lc: (K, B); new_m/tail: (D, K, B); sig2_ag: (A, G, 1|B);
    lt_b (A, G, 1, 1) and lsurv_b (A, 1, 1, 1).  Returns (lp_child
    (A,G,O,B), wn (A,G,O,B), lp_new (A,G,B), m_f/tail_f/s2_new (D,A,G,B)).
    """
    D = new_m.shape[0]
    B = lp.shape[-1]
    base = (lp + lc).reshape(G, A, B)                     # o = axis 1
    lp_child = base[None] + lt_b + gate * lsurv_b         # (A,G,O,B)
    safe = _masked_max(lp_child, 2)
    w = torch.exp(lp_child - safe)
    sw = w.sum(dim=2)
    tiny = _tiny(sw.dtype)
    wn = w / sw.clamp_min(tiny)[:, :, None]
    mx_fin = torch.isfinite(lp_child.detach().amax(dim=2))
    lp_new = (safe[:, :, 0] + torch.log(sw.clamp_min(tiny))
              + torch.where(mx_fin, 0.0, -math.inf))
    new_mv = new_m.reshape(D, G, A, B)
    tailv = tail.reshape(D, G, A, B)
    m_f = torch.einsum("agob,dgob->dagb", wn, new_mv)
    tail_f = torch.einsum("agob,dgob->dagb", wn, tailv)
    s2_new = sig2_ag[None] + tail_f
    return lp_child, wn, lp_new, m_f, tail_f, s2_new


def _moment_match(lp, values):
    """Fuse the trailing axis of ``lp`` (log weights) by logsumexp while
    moment-matching each array in ``values`` (weighted mean).

    Reference: fuse_tracks_general, extrack/tracking.py:361-423.
    """
    safe = _masked_max(lp, -1)
    w = torch.exp(lp - safe)
    sw = w.sum(dim=-1, keepdim=True)
    tiny = _tiny(sw.dtype)
    wn = w / sw.clamp_min(tiny)
    mx_fin = torch.isfinite(lp.detach().amax(dim=-1))
    lp_new = (safe[..., 0] + torch.log(sw[..., 0].clamp_min(tiny))
              + torch.where(mx_fin, 0.0, -math.inf))
    fused = [torch.einsum("...o,...od->...d", wn, v) for v in values]
    return lp_new, fused, wn


class Walk(NamedTuple):
    """Per-walk constants and the initial register, shared by the
    likelihood walk (``forward``) and the window histogram."""
    xs_pos: torch.Tensor        # (T, D, B) positions
    xs_l2: torch.Tensor         # (T, D, B) localization variances
    lt_b: torch.Tensor          # (A, G, 1, 1) branch transitions
    lsurv_b: torch.Tensor       # (A, 1, 1, 1) survival
    end_k: torch.Tensor         # (K, 1) end term per slot
    sig2_ag_at: object          # step -> (A, G, 1|B) displacement variance
    m: torch.Tensor             # (D, K, B) initial register
    s2: torch.Tensor            # (D, K, B)
    lp: torch.Tensor            # (K, B)


def walk_setup(positions: torch.Tensor, tables: ModelTables,
               spec: RegisterSpec) -> Walk:
    """Walk constants and initial register for ``positions`` (B, T, D), in
    its dtype and on its device."""
    B, T, D = positions.shape
    S, n, K, A, G = spec.S, spec.n, spec.K, spec.A, spec.G
    dtype, dev = positions.dtype, positions.device

    def idx(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    l2 = tables.loc_err2.to(dtype).expand(B, T, D)
    xs_pos = positions.permute(1, 2, 0)                               # (T,D,B)
    xs_l2 = l2.permute(1, 2, 0)
    lt_ag = branch_log_trans(tables.log_trans, n)[:, idx(spec.prev0_g)]
    lsurv = tables.log_survive.to(dtype)                              # (A,)
    end_k = tables.end_ll[idx(spec.prev0_k)].to(dtype)[:, None]       # (K,1)
    lp0 = init_log_prob(tables.log_trans, tables.log_frac, n)         # (P,)

    # displacement variance tables as (A, G, 1|B) per step
    sig2 = tables.sig2.to(dtype)
    R = sig2.shape[-2]
    ag_pat = idx((np.arange(A)[:, None] * S + spec.prev0_g[None, :]).ravel())

    def sig2_ag_at(t_idx):
        row = sig2[..., min(t_idx, R - 1), :]             # (P,)|(B,P)
        agg = row[..., ag_pat]
        if agg.ndim == 1:
            return agg.reshape(A, G, 1)
        return agg.T.reshape(A, G, B)

    sig2_init = sig2[..., 0, :][..., idx(spec.init_pat)]  # (K,)|(B,K)
    sig2_init = sig2_init[:, None] if sig2_init.ndim == 1 else sig2_init.T
    m = xs_pos[0][:, None, :].expand(D, K, B)
    s2 = (xs_l2[0][:, None, :] + sig2_init[None]).expand(D, K, B)
    lp_init = (lp0[idx(spec.init_pat)]
               - spec.dummy_digits * math.log(S)).to(dtype)
    return Walk(xs_pos, xs_l2, lt_ag[:, :, None, None].to(dtype),
                lsurv[:, None, None, None], end_k, sig2_ag_at, m, s2,
                lp_init[:, None].expand(K, B))


def forward(positions: torch.Tensor,
            lengths: torch.Tensor,
            is_bleached: torch.Tensor,
            tables: ModelTables,
            *,
            window: int = 6,
            nb_substeps: int = 1,
            min_len: int = 3,
            return_preds: bool = False):
    """Per-track log likelihood (B,), or ``(logl, preds (B, T, S))`` with
    ``return_preds=True``.

    positions: (B, T, D) padded tracks; lengths: (B,) valid frame counts
    (padded/empty tracks use length 0 and contribute exactly 0);
    is_bleached: (B,) 1.0 where the track ended inside the observation
    window.  Computes in ``positions.dtype`` on ``positions.device``.

    The posteriors are carried through the fusions like the reference's
    ``cur_Bs_cat`` (extrack/tracking.py:479,543-544,645-649): each slot keeps
    a history ``cat (K, T+W, S)`` over the states of the frames that left
    the window (row t+1 <-> frame t+1-W), mixed by the fusion weights every
    step; at a track's last frame the register's softmax reduces the
    histories and the register codes give the window's frames.  Padded
    frames get 0.  Requires nb_substeps == 1, as predict_Bs
    (extrack/tracking.py:839).
    """
    B, T, D = positions.shape
    spec = make_register_spec(tables.nb_states, window, nb_substeps)
    S, W, n, K, A, G = spec.S, spec.W, spec.n, spec.K, spec.A, spec.G
    if return_preds and n != 1:
        raise ValueError("posteriors require nb_substeps == 1")
    dtype, dev = positions.dtype, positions.device

    def idx(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    lengths = lengths.to(device=dev, dtype=torch.int64)
    isbl = is_bleached.to(dtype)[None, :]                             # (1,B)
    wk = walk_setup(positions, tables, spec)
    xs_pos, xs_l2, end_k, sig2_ag_at = (wk.xs_pos, wk.xs_l2, wk.end_k,
                                        wk.sig2_ag_at)
    lt_b, lsurv_b, m, s2, lp = wk.lt_b, wk.lsurv_b, wk.m, wk.s2, wk.lp
    end_a = tables.end_ll[idx(state_codes(S, n)[:, 0])].to(dtype)     # (A,)
    logl = torch.zeros(B, dtype=dtype, device=dev)

    if return_preds:
        cat = torch.zeros((K, T + W, S, B), dtype=dtype, device=dev)
        preds = torch.zeros((T, S, B), dtype=dtype, device=dev)
        onehot = idx((spec.codes[:, ::-1, None] == np.arange(S))
                     .astype(np.float64)).to(dtype)        # (K,W,S)

    zero = torch.zeros((), dtype=dtype, device=dev)
    for t in range(1, T):
        x_t, l2_t = xs_pos[t], xs_l2[t]                    # (D,B)
        tn = min(t + 1, T - 1)
        x_n, l2_n = xs_pos[tn], xs_l2[tn]
        sig2_ag = sig2_ag_at(t)
        is_final = t == lengths - 1
        is_interior = t < lengths - 1

        # closing for 2-frame tracks ending at this frame (longer tracks
        # close one step early on the pre-fusion children below)
        tot = l2_t[:, None, :] + s2                       # (D,K,B)
        quad = (-0.5 * torch.log(2 * math.pi * tot)
                - (x_t[:, None, :] - m) ** 2 / (2 * tot))
        lc = quad.sum(dim=0)                              # (K,B)
        fin = lp + isbl * end_k + lc
        logl = logl + torch.where(is_final & (lengths == 2),
                                  torch.logsumexp(fin, dim=0), zero)

        new_m = (m * l2_t[:, None, :] + x_t[:, None, :] * s2) / tot
        tail = l2_t[:, None, :] * s2 / tot                # (D,K,B)
        gate = float(t + 1 >= min_len)
        lp_child, wn, lp_new, m_f, _, s2_new = branch_fuse(
            lp, lc, new_m, tail, sig2_ag, gate, lt_b, lsurv_b, G, A)

        # look-ahead closing on the pre-fusion children for tracks ending
        # at frame t+1 (the reference's final, unfused register)
        new_mv4 = new_m.reshape(D, G, A, B)
        tailv4 = tail.reshape(D, G, A, B)
        totn = (sig2_ag[None, :, :, None] + tailv4[:, None]
                + l2_n[:, None, None, None, :])           # (D,A,G,O,B)
        lcn = (-0.5 * torch.log(2 * math.pi * totn)
               - (x_n[:, None, None, None, :] - new_mv4[:, None]) ** 2
               / (2 * totn)).sum(dim=0)
        fin_n = lp_child + isbl * end_a[:, None, None, None] + lcn
        logl = logl + torch.where(
            t == lengths - 2,
            torch.logsumexp(fin_n.reshape(K * A, B), dim=0), zero)

        keep = is_interior[None, :]
        m = torch.where(keep[None], m_f.reshape(D, K, B), m)
        s2 = torch.where(keep[None], s2_new.reshape(D, K, B), s2)
        lp = torch.where(keep, lp_new.reshape(K, B), lp)

        if return_preds:
            # mix the histories with the fusion weights, then record the
            # state distribution of the frame dropped from the window
            catv = cat.reshape(G, A, T + W, S, B)
            mixed = torch.einsum("agob,gotsb->agtsb", wn, catv)
            mixed = mixed.reshape(K, T + W, S, B)
            mixed[:, t + 1] = wn.reshape(K, S, B)
            cat = torch.where(keep[None, None], mixed, cat)

            pbar = torch.softmax(fin, dim=0)              # (K,B)
            hist = torch.einsum("kb,ktsb->tsb", pbar, cat)
            hist[t + 1:t + 1 + W] = torch.einsum("kb,kws->wsb", pbar, onehot)
            preds = preds + torch.where(is_final[None, None], hist[W:], zero)
    if return_preds:
        return logl, preds.permute(2, 0, 1)
    return logl



def batch_log_likelihood(batch, tables: ModelTables, **kw) -> torch.Tensor:
    """Sum of per-track log likelihoods for a TrackBatch: K1's on a CUDA
    batch, the plain ``forward``'s on the CPU
    (``ops.forward_kernel.forward``, imported here so that the plain
    engine does not import the kernels).  ``kw``: ``window``,
    ``nb_substeps``, ``min_len``."""
    from extrack_tpu_torch.ops import forward_kernel
    return forward_kernel.forward(batch.positions, batch.lengths,
                                  batch.is_bleached, tables, **kw).sum()
