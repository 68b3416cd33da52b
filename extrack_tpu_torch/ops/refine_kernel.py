"""K6: the position-refinement kernel (csrc/refine.cu) and its host side.

Replaces extrack_tpu/ops/pallas_refine.py:_kernel (driven by
refine_pallas).  ``refine`` returns ``(mu, sigma)`` (B, T, D), the
moment-matched mean and standard deviation of every localization's true
position:

* CUDA tensors (float32): one K6 launch on ``build_refine_tables``' slot
  tables: a thread a slot up to 1024 slots, a thread a fusion group up to
  16384 (``forward_kernel.mapping_warps``), the forms in global scratch
  where shared memory cannot hold them, and past 4096 slots the publish
  areas too where they pass what a block may opt in to
  (``refine_wide_global_kernel``).  Outside the envelope it raises.
* CPU tensors: ``refine_plain``, which is ``refine.refine_positions`` on
  the same inputs, in chunks that bound its S*(K/S)^2-component mixture.

``LAUNCHES`` counts K6 launches, ``PLAIN_CALLS`` calls of the plain version.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from extrack_tpu_torch import refine as trefine
from extrack_tpu_torch.core.tables import LOG_FLOOR
from extrack_tpu_torch.ops import cuda_lib, forward_kernel

LAUNCHES = 0
PLAIN_CALLS = 0


def build_refine_tables(log_trans: torch.Tensor, sig2_states: torch.Tensor,
                        W: int):
    """(lp0, lt, sig2) as (K,) tensors in the newest-high slot encoding.

    Refinement weights carry transition terms only: no fractions, survival
    or bleaching (the reference's get_LC_Km_Ks accumulates LT+LC only,
    refined_localization.py:93-96).  ``lt`` is the transition from the
    second-newest into the newest state, ``sig2`` the mean of those two
    states' displacement variances; log entries are floored at -1e15, so a
    forbidden transition stays finite."""
    S = log_trans.shape[0]
    k = np.arange(S ** W)
    d0 = torch.as_tensor((k // S ** (W - 1)) % S, device=log_trans.device)
    d1 = torch.as_tensor((k // S ** (W - 2)) % S, device=log_trans.device)
    lt = log_trans.clamp_min(LOG_FLOOR)[d1, d0]
    sig2 = 0.5 * (sig2_states[d1] + sig2_states[d0])
    return lt - (W - 2) * math.log(S), lt, sig2


def plan(T: int, D: int, K: int, S: int, smem_limit: int,
         mapping: str | None = None, layout=None):
    """(wide, threads, shared bytes, carry bytes) of a K6 launch:
    ``forward_kernel.mapping_warps``' mapping (``mapping`` forces it), wide
    0 a thread a slot, 1 the wide mapping, 2 the wide mapping with its
    publish areas in global scratch, exactly where the wide block's fixed
    shared bytes (publish areas and ring) pass ``smem_limit``.  ``layout``
    (T, D, K, S, wide) -> (threads, fixed, carry) is the kernel's own
    (``cuda_lib.layout``) unless given (tests)."""
    layout = layout or (lambda *dims: cuda_lib.layout("refine", *dims))
    w = int(forward_kernel.mapping_warps("K6", K, mapping)
            == forward_kernel.WIDE)
    threads, fixed, carry = layout(T, D, K, S, w)
    if w and fixed > smem_limit:
        w = 2       # the publish areas in global scratch after the forms
        threads, fixed, carry = layout(T, D, K, S, w)
    return w, threads, fixed, carry


def launch(positions, lengths, l2, tabs, S: int,
           mapping: str | None = None):
    """Launch K6 on the current stream: ``positions``, ``l2`` (B, T, D)
    float32, ``lengths`` (B,) int32, ``tabs`` the five (K,) float32 tables
    (lp0f, ltf, lp0r, ltr, sig2v).  Returns mu, sigma (B, T, D).
    ``mapping`` forces ``forward_kernel.mapping_warps``' choice (tests,
    tools)."""
    global LAUNCHES
    B, T, D = positions.shape
    dev = positions.device
    K = tabs[0].shape[0]
    want = [(positions, (B, T, D), torch.float32),
            (l2, (B, T, D), torch.float32), (lengths, (B,), torch.int32)]
    want += [(t, (K,), torch.float32) for t in tabs]
    cuda_lib.check_args(want, dev)
    lib = cuda_lib.library()
    f32 = dict(dtype=torch.float32, device=dev)
    mu = torch.empty((B, T, D), **f32)
    sigma = torch.empty((B, T, D), **f32)
    w, threads, fixed, stash = plan(
        T, D, K, S, cuda_lib.smem_bytes("extrack_refine_smem", dev.index),
        mapping)
    nblk, scratch = cuda_lib.grid("extrack_refine_smem", dev, B, fixed,
                                  stash, threads, in_scratch=w == 2)
    rc = lib.extrack_refine(
        *(t.data_ptr() for t in (positions, l2, lengths, *tabs, mu, sigma)),
        None if scratch is None else scratch.data_ptr(),
        B, T, D, K, S, nblk, w,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(rc, "refinement")
    LAUNCHES += 1
    return mu, sigma


def refine_plain(positions, lengths, loc_err2, log_trans, sig2_states, *,
                 window: int = 7):
    """The plain version of K6: ``refine.refine_positions``, in chunks of
    tracks that keep its (chunk, K/S, K/S, D) block of pairs at about 2^26
    floats."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    B, T, D = positions.shape
    S = log_trans.shape[0]
    chunk = max(1, (1 << 26) // (S ** (2 * window - 2) * D))
    l2 = loc_err2.expand(B, T, D)
    parts = [trefine.refine_positions(positions[i:i + chunk],
                                      lengths[i:i + chunk],
                                      l2[i:i + chunk], log_trans,
                                      sig2_states, window=window)
             for i in range(0, max(B, 1), chunk)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def refine(positions, lengths, loc_err2, log_trans, sig2_states, *,
           window: int = 7, what: str = "refinement batch"):
    """(mu, sigma) (B, T, D) refined positions.  ``loc_err2`` broadcasts
    to (B, T, D) (per-peak errors included), ``log_trans`` is the (S, S)
    log transition matrix, ``sig2_states`` (S,) the per-state displacement
    variances 2*D*dt.  CUDA inputs run K6 (float32 only; anything outside
    its envelope raises, naming ``what``); CPU inputs run the plain
    version."""
    if positions.device.type == "cpu":
        return refine_plain(positions, lengths, loc_err2, log_trans,
                            sig2_states, window=window)
    B, T, D = positions.shape
    S = log_trans.shape[0]
    dtype = next((t.dtype for t in (positions, loc_err2, log_trans,
                                    sig2_states)
                  if t.dtype != torch.float32), torch.float32)
    forward_kernel.check_envelope(T, D, S, window, 1, dtype=dtype,
                                  what=what, kernel="K6")
    lp0f, ltf, sig2v = build_refine_tables(log_trans, sig2_states, window)
    lp0r, ltr, _ = build_refine_tables(log_trans.T, sig2_states, window)
    tabs = [t.contiguous() for t in (lp0f, ltf, lp0r, ltr, sig2v)]
    return launch(positions.contiguous(), lengths.to(torch.int32).contiguous(),
                  loc_err2.expand(B, T, D).contiguous(), tabs, S)
