"""K7: the top-K duration-histogram kernel (csrc/topk.cu) and its host side.

Replaces extrack_tpu/ops/pallas_topk.py:_topk_kernel (driven by
segment_topk_pallas).  ``segment_topk`` returns the (T, S)
posterior-expected segment-length histogram of the top-K engine, summed
over a batch's tracks:

* CUDA tensors (float32, constant dt): one K7 launch walks each track's
  register of M sequences and writes its final weights and parent/state
  backpointers (``backpointers``); the shared decoder
  ``histograms.decode_backpointers`` turns them into the histogram, in
  plain torch on the card.  Outside the envelope it raises.
* CPU tensors: ``segment_topk_plain``, which is
  ``histograms.segment_histogram`` on the same inputs.

K7's selection is stable, as the plain version's sort is: an exact tie in
the look-ahead score keeps the lower child index.  The TPU kernel's
bitonic network is not stable (pallas_topk.py:22-26), so in the port
``engine="topk"`` and ``engine="topk_pallas"`` are one computation.

``LAUNCHES`` counts K7 launches, ``PLAIN_CALLS`` calls of the plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from extrack_tpu_torch import histograms
from extrack_tpu_torch.core import tables as ttables
from extrack_tpu_torch.core.tables import LOG_FLOOR, ModelTables
from extrack_tpu_torch.ops import cuda_lib, forward_kernel

LAUNCHES = 0
PLAIN_CALLS = 0
MAX_ROWS = 1024           # one thread per register row, one block per track


def smem_needed(M: int, D: int, A: int) -> int:
    """Dynamic shared memory of one K7 block: the (key, index) sort words
    of 8 bytes, one per child padded to a power of two, and the parents'
    fold, 2D+4 floats per row."""
    return 8 * (1 << (A * M - 1).bit_length()) + 4 * (2 * D + 4) * M


def check_envelope(T: int, D: int, S: int, M: int, nb_substeps: int = 1,
                   variable_dt: bool = False, dtype=torch.float32,
                   smem_limit: int | None = None):
    """Raise NotImplementedError when K7 cannot run this configuration.
    ``smem_limit`` is the dynamic shared memory one block may opt in to
    (``cuda_lib.smem_bytes("extrack_topk_smem", device)``); None skips
    that check.  The message names the largest M that fits."""
    A = S ** nb_substeps
    P = S * A
    reasons = []
    if dtype != torch.float32:
        reasons.append(f"dtype {dtype} (K7 computes in float32: pass "
                       "float32 tensors)")
    if D not in (1, 2, 3):
        reasons.append(f"D={D} (K7 takes 1..3 dimensions)")
    if variable_dt:
        reasons.append("per-step / per-track dt (the streamed "
                       "displacement-variance table is not ported yet)")
    if M < P:
        reasons.append(f"max_nb_states={M} < nb_states^(nb_substeps+1)"
                       f"={P}")
    else:
        fits = [m for m in range(P, MAX_ROWS + 1)
                if smem_limit is None or smem_needed(m, D, A) <= smem_limit]
        if M not in fits:
            reasons.append(
                f"max_nb_states={M}: K7 holds at most {MAX_ROWS} rows and "
                f"{smem_limit} bytes of shared memory per block (the "
                f"largest max_nb_states that fits is "
                f"{max(fits, default=0)})")
    if reasons:
        raise NotImplementedError(
            f"top-K histogram batch (T={T}, D={D}, S={S}, max_nb_states={M}, "
            f"nb_substeps={nb_substeps}) is outside K7's envelope: "
            + "; ".join(reasons))


def topk_tables(tb: ModelTables, M: int, n: int):
    """K7's tables, float32 on ``tb``'s device (pallas_topk.py:283-295):
    ``lp0`` (M,), the initial patterns' log-probabilities padded with
    -1e30; ``s20`` (M,), their displacement variances (unused slots take
    pattern 0's, as the plain version); ``nw0`` (M,) int32, their newest
    states; ``tab`` = lt (A, S) | lsurv (A,) | end (S,) | sig2 (A*S,)
    flattened, sig2 indexed by a*S + newest.  Log entries are floored at
    -1e15 so hand-built tables with -inf entries stay finite."""
    S = tb.nb_states
    P = S ** (n + 1)
    f32 = dict(dtype=torch.float32, device=tb.log_trans.device)
    log_trans = tb.log_trans.clamp_min(LOG_FLOOR)
    lp0 = torch.full((M,), histograms._NEG, **f32)
    lp0[:P] = ttables.init_log_prob(log_trans,
                                    tb.log_frac.clamp_min(LOG_FLOOR), n)
    sig2_row = tb.sig2.reshape(-1, tb.sig2.shape[-1])[0]
    s20 = sig2_row[np.pad(np.arange(P), (0, M - P))].to(**f32)
    nw0 = torch.zeros(M, dtype=torch.int32, device=lp0.device)
    nw0[:P] = torch.as_tensor(ttables.state_codes(S, n + 1)[:, 0],
                              device=lp0.device)
    tab = torch.cat([ttables.branch_log_trans(log_trans, n).reshape(-1),
                     tb.log_survive.clamp_min(LOG_FLOOR),
                     tb.end_ll.clamp_min(LOG_FLOOR), sig2_row])
    return lp0, s20.contiguous(), nw0, tab.to(**f32).contiguous()


def kernel_inputs(positions, lengths, is_bleached, tables: ModelTables,
                  M: int, nb_substeps: int):
    """K7's arguments: the track data (xs, l2 (B, T, D) float32, lengths
    (B,) int32, isBL (B,) float32), contiguous, and ``topk_tables``."""
    B, T, D = positions.shape
    f32 = torch.float32
    data = (positions.to(f32).contiguous(),
            tables.loc_err2.to(f32).expand(B, T, D).contiguous(),
            lengths.to(torch.int32).contiguous(),
            is_bleached.to(f32).contiguous())
    return data, topk_tables(tables, M, nb_substeps)


def buffers(B: int, T: int, M: int, device):
    """K7's outputs, every element of which it writes: w_final (B, M)
    float32, parents (B, T-1, M) int16, states (B, T-1, M) int8."""
    steps = (B, max(T - 1, 0), M)
    return (torch.empty((B, M), dtype=torch.float32, device=device),
            torch.empty(steps, dtype=torch.int16, device=device),
            torch.empty(steps, dtype=torch.int8, device=device))


def launch(data, tabs, outs, S: int, nb_substeps: int, min_len: int):
    """Launch K7 on the current stream into ``outs`` (``buffers``' three
    tensors, for the B tracks of ``data``)."""
    global LAUNCHES
    xs = data[0]
    B, T, D = xs.shape
    M = tabs[0].shape[0]
    A = S ** nb_substeps
    dev = xs.device
    f32, i32 = torch.float32, torch.int32
    steps = (B, max(T - 1, 0), M)
    cuda_lib.check_args(
        zip((*data, *tabs, *outs),
            [(B, T, D), (B, T, D), (B,), (B,), (M,), (M,), (M,),
             (2 * A * S + A + S,), (B, M), steps, steps],
            [f32, f32, i32, f32, f32, f32, i32, f32, f32, torch.int16,
             torch.int8]), dev)
    rc = cuda_lib.library().extrack_topk(
        *(t.data_ptr() for t in (*data, *tabs, *outs)),
        B, T, D, M, S, A, S ** (nb_substeps - 1), int(min_len),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(rc, "top-K histogram")
    LAUNCHES += 1


def backpointers(positions, lengths, is_bleached, tables: ModelTables, *,
                 max_nb_states: int = 512, min_len: int = 3,
                 nb_substeps: int = 1):
    """K7's raw outputs for CUDA inputs, in the plain version's layout:
    (parents (T-1, B, M) int16, states (T-1, B, M) int8, w_final (B, M)),
    the first two as views of K7's (B, T-1, M) buffers.  Raises outside
    the envelope."""
    B, T, D = positions.shape
    dev = positions.device
    S, M = tables.nb_states, max_nb_states
    check_envelope(T, D, S, M, nb_substeps,
                   forward_kernel.classify_sig2(tables.sig2, T),
                   forward_kernel.kernel_dtype(positions, tables),
                   cuda_lib.smem_bytes("extrack_topk_smem", dev.index))
    with torch.no_grad():
        data, tabs = kernel_inputs(positions, lengths, is_bleached, tables,
                                   M, nb_substeps)
    outs = buffers(B, T, M, dev)
    launch(data, tabs, outs, S, nb_substeps, min_len)
    w_final, parents, states = outs
    return parents.transpose(0, 1), states.transpose(0, 1), w_final


def segment_topk_plain(positions, lengths, is_bleached, tables: ModelTables,
                       *, max_nb_states: int = 512, min_len: int = 3,
                       nb_substeps: int = 1):
    """The plain version of K7 with the decode:
    ``histograms.segment_histogram``."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    return histograms.segment_histogram(
        positions, lengths, is_bleached, tables, max_nb_states=max_nb_states,
        min_len=min_len, nb_substeps=nb_substeps)


def segment_topk(positions, lengths, is_bleached, tables: ModelTables, *,
                 max_nb_states: int = 512, min_len: int = 3,
                 nb_substeps: int = 1):
    """(T, S) segment-length histogram of the top-K engine, summed over the
    tracks.  CUDA inputs run K7 (float32, constant dt; anything outside its
    envelope raises) and the decode; CPU inputs run the plain version."""
    if positions.device.type == "cpu":
        return segment_topk_plain(positions, lengths, is_bleached, tables,
                                  max_nb_states=max_nb_states,
                                  min_len=min_len, nb_substeps=nb_substeps)
    S = tables.nb_states
    parents, states, w_final = backpointers(
        positions, lengths, is_bleached, tables, max_nb_states=max_nb_states,
        min_len=min_len, nb_substeps=nb_substeps)
    return histograms.decode_backpointers(
        parents, states, w_final, lengths,
        ttables.state_codes(S, nb_substeps + 1), S, max_nb_states)
