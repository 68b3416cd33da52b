"""K6: the position-refinement kernel (csrc/refine.cu) and its host side.

Replaces extrack_tpu/ops/pallas_refine.py:_kernel (driven by
refine_pallas).  ``refine`` returns ``(mu, sigma)`` (B, T, D), the
moment-matched mean and standard deviation of every localization's true
position:

* CUDA tensors (float32): one K6 launch on ``build_refine_tables``' slot
  tables: a thread a slot up to 1024 slots (the suffix stash in global
  scratch where shared memory cannot hold it); past that, up to 16384,
  the tiled wide mapping (``forward_kernel.mapping_warps``): a scan
  kernel a thread a fusion group that writes both sides' forms to global
  scratch (its publish areas there too where they pass what a block may
  opt in to), the pair kernel over (track, interior position, state
  block, row tile) with two prefix rows a thread (``pair_threads``) and
  the merge, on chunks of tracks whose carries fit
  ``cuda_lib.scratch_budget`` (``chunk_tracks``).  Outside the envelope
  it raises.
* CPU tensors: ``refine_plain``, which is ``refine.refine_positions`` on
  the same inputs, in chunks that bound its S*(K/S)^2-component mixture.

``LAUNCHES`` counts K6 launches, ``PLAIN_CALLS`` calls of the plain version.
"""
from __future__ import annotations

import math
from typing import NamedTuple

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


PAIR_THREADS = 256        # csrc/refine.cu kPairThreads
PAIR_ROWS = 2             # csrc/refine.cu kPairRows, prefix rows a thread


class Plan(NamedTuple):
    """A K6 launch: ``wide`` 0 a thread a slot, 1 the tiled wide mapping,
    2 the same with the scan's publish areas in global scratch; the
    (scan) block's threads, its shared bytes besides the carries, the
    carry bytes a track; on the wide mapping the pair kernel's threads
    ``pair_threads`` (PAIR_ROWS rows each)."""
    wide: int
    threads: int
    fixed: int
    carry: int
    pair_threads: int = 0


def pair_threads(KS: int) -> int:
    """The pair kernel's threads for a state block of KS rows: the fewest
    row tiles of at most PAIR_ROWS * PAIR_THREADS rows, each with the
    fewest threads, a multiple of 32, that cover KS."""
    nrt = -(-KS // (PAIR_ROWS * PAIR_THREADS))
    return -(-KS // (PAIR_ROWS * nrt * 32)) * 32


def plan(T: int, D: int, K: int, S: int, smem_limit: int,
         mapping: str | None = None, layout=None) -> Plan:
    """The ``Plan`` of a K6 launch: ``forward_kernel.mapping_warps``'
    mapping (``mapping`` forces it); on the wide mapping the pair kernel's
    ``pair_threads``, and the publish areas in global
    scratch (wide 2) exactly where the scan block's shared bytes pass
    ``smem_limit``.  ``layout`` (T, D, K, S, wide, rows) -> (threads,
    fixed, carry) is the kernel's own (``cuda_lib.layout``) unless given
    (tests)."""
    layout = layout or (lambda *dims: cuda_lib.layout("refine", *dims))
    if forward_kernel.mapping_warps("K6", K, mapping) != forward_kernel.WIDE:
        return Plan(0, *layout(T, D, K, S, 0, 0))
    nt = pair_threads(K // S)
    w = 1
    scan, fixed, carry = layout(T, D, K, S, w, PAIR_ROWS * nt)
    if fixed > smem_limit:
        w = 2
        scan, fixed, carry = layout(T, D, K, S, w, PAIR_ROWS * nt)
    return Plan(w, scan, fixed, carry, nt)


def chunk_tracks(B: int, carry: int, budget: int,
                 what: str = "refinement batch") -> int:
    """Tracks a chunk of the wide mapping takes: as many carries of
    ``carry`` bytes as ``budget`` holds, no more than the ``B`` tracks.
    Raises RuntimeError, naming the batch and the bytes, where one track's
    carry alone passes the budget."""
    if carry > budget:
        raise RuntimeError(
            f"one track's K6 scratch ({carry} bytes: both sides' forms of "
            f"every interior frame and the pair kernel's partials, {what} "
            f"of {B} tracks) passes the {budget} bytes the card can give "
            "it; split the longest tracks' bucket or free device memory")
    return max(1, min(B, budget // max(carry, 1)))


def launch(positions, lengths, l2, tabs, S: int,
           mapping: str | None = None, what: str = "refinement batch"):
    """Launch K6 on the current stream: ``positions``, ``l2`` (B, T, D)
    float32, ``lengths`` (B,) int32, ``tabs`` the five (K,) float32 tables
    (lp0f, ltf, lp0r, ltr, sig2v).  Returns mu, sigma (B, T, D).
    ``mapping`` forces ``forward_kernel.mapping_warps``' choice (tests,
    tools).  The wide
    mapping runs one launch of its three kernels a chunk of tracks
    (``chunk_tracks``); it counts as one K6 launch."""
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
    pl = plan(T, D, K, S,
              cuda_lib.smem_bytes("extrack_refine_smem", dev.index),
              mapping)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tab_ptrs = [t.data_ptr() for t in tabs]
    if pl.wide:
        n = chunk_tracks(B, pl.carry,
                         cuda_lib.scratch_budget(dev, K, wide=True), what)
        scratch = torch.empty(max(n * pl.carry // 4, 4), **f32)
        row = T * D * 4
        for i in range(0, max(B, 1), n):
            m = min(n, B - i)
            rc = lib.extrack_refine_wide(
                positions.data_ptr() + i * row, l2.data_ptr() + i * row,
                lengths.data_ptr() + i * 4, *tab_ptrs,
                mu.data_ptr() + i * row, sigma.data_ptr() + i * row,
                scratch.data_ptr(), m, T, D, K, S, pl.wide, pl.pair_threads,
                stream)
            cuda_lib.check(rc, "refinement")
    else:
        nblk, scratch = cuda_lib.grid("extrack_refine_smem", dev, B,
                                      pl.fixed, pl.carry, pl.threads)
        rc = lib.extrack_refine(
            positions.data_ptr(), l2.data_ptr(), lengths.data_ptr(),
            *tab_ptrs, mu.data_ptr(), sigma.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            B, T, D, K, S, nblk, stream)
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
                  loc_err2.expand(B, T, D).contiguous(), tabs, S, what=what)
