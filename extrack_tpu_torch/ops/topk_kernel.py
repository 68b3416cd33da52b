"""K7: the top-K duration-histogram kernel (csrc/topk.cu) and its host side.

Replaces extrack_tpu/ops/pallas_topk.py:_topk_kernel (driven by
segment_topk_pallas).  ``segment_topk`` returns the (T, S)
posterior-expected segment-length histogram of the top-K engine, summed
over a batch's tracks:

* CUDA tensors (float32, constant dt): one K7 launch (``launch_fused``)
  walks each track's register of M sequences, backtracks its final
  sequences from backpointers it keeps in shared memory and writes the
  track's (T*S) histogram row; one float64 sum over the rows follows, in
  a fixed order, so the same input gives the same bits.  No (B, M, T)
  tensor and no per-frame loop on the host.  ``backpointers`` runs the
  same kernel in its raw mode, which writes the final weights and the
  parent/state backpointers instead (the plain version's layout).
  Outside the envelope it raises.
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
REGISTERS = 64            # a thread's registers under K7's launch bounds


def walk_bytes(M: int, D: int, A: int) -> int:
    """Shared memory of K7's walk (topk.cu's walk_bytes): the children's
    64-bit (score, index) words, A runs of M rounded up to a power of two,
    two merge buffers of as many words, and the parents' fold, 2D+4 floats
    per row."""
    return 8 * (A + 2) * (1 << (M - 1).bit_length()) + 4 * (2 * D + 4) * M


def layout(M: int, D: int, A: int, S: int, T: int, smem_limit: int):
    """Shared memory of one fused K7 block: (region bytes, decode bins per
    pass, backpointers in shared memory?).  The region holds the walk and
    then the decode's columns (one float per thread and bin): all T*S bins
    in one pass where they fit the share of an SM's shared memory that
    keeps as many blocks resident as its threads and registers allow, else
    as many bins a pass as do (at least the walk's region).  The
    backpointers ((T-1)*M int16 and int8) follow when they fit
    ``smem_limit`` (the opt-in limit of one block) with it, first with the
    decode's region, then with the walk's alone, else they go to global
    scratch."""
    threads = (M + 31) // 32 * 32
    walk = walk_bytes(M, D, A)
    bp = 3 * max(T - 1, 0) * M
    blocks = max(1, min(2048 // threads, 65536 // (REGISTERS * threads)))
    share = (smem_limit + 1024) // blocks - 2048    # less reserve, static
    full = max(walk, min(T * S * threads * 4, share - bp))
    for region in (full, walk):
        if region + bp <= smem_limit:
            break
    else:
        region = max(walk, min(full, smem_limit))
    return (region, max(1, min(T * S, region // (4 * threads))),
            region + bp <= smem_limit)


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
                if smem_limit is None or walk_bytes(m, D, A) <= smem_limit]
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
    pattern 0's, as the plain version); ``nw0`` (2, M) int32, their newest
    and their oldest states (0 in unused slots); ``tab`` = lt (A, S) |
    lsurv (A,) | end (S,) | sig2 (A*S,)
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
    codes = ttables.state_codes(S, n + 1)      # newest digit first
    nw0 = torch.zeros((2, M), dtype=torch.int32, device=lp0.device)
    nw0[:, :P] = torch.as_tensor(codes[:, [0, -1]].T, device=lp0.device)
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


def _launch(data, tabs, S: int, nb_substeps: int, min_len: int, w_final,
            bp, rows, region: int, chunk: int, bp_smem: bool):
    """One K7 launch on the current stream, raw (``rows`` None: w_final
    and the backpointers ``bp`` out) or fused (``rows`` out, ``bp`` the
    backpointers' global scratch unless ``bp_smem``)."""
    global LAUNCHES
    xs = data[0]
    B, T, D = xs.shape
    M = tabs[0].shape[0]
    A = S ** nb_substeps
    dev = xs.device
    f32, i32 = torch.float32, torch.int32
    steps = (B, max(T - 1, 0), M)
    want = list(zip((*data, *tabs),
                    [(B, T, D), (B, T, D), (B,), (B,), (M,), (M,), (2, M),
                     (2 * A * S + A + S,)],
                    [f32, f32, i32, f32, f32, f32, i32, f32]))
    if rows is None:
        want.append((w_final, (B, M), f32))
    else:
        want.append((rows, (B, T * S), f32))
    if bp is not None:
        want += [(bp[0], steps, torch.int16), (bp[1], steps, torch.int8)]
    cuda_lib.check_args(want, dev)

    def ptr(t):
        return None if t is None else t.data_ptr()
    rc = cuda_lib.library().extrack_topk(
        *(t.data_ptr() for t in (*data, *tabs)), ptr(w_final),
        *((None, None) if bp is None else map(ptr, bp)), ptr(rows),
        B, T, D, M, S, A, S ** (nb_substeps - 1), int(min_len),
        int(rows is None), int(bp_smem), region, chunk,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(rc, "top-K histogram")
    LAUNCHES += 1


def launch(data, tabs, outs, S: int, nb_substeps: int, min_len: int):
    """Launch K7 raw on the current stream into ``outs`` (``buffers``'
    three tensors, for the B tracks of ``data``)."""
    _, _, D = data[0].shape
    region = walk_bytes(tabs[0].shape[0], D, S ** nb_substeps)
    _launch(data, tabs, S, nb_substeps, min_len, outs[0], outs[1:], None,
            region, 1, False)


def fused_layout(B: int, T: int, D: int, M: int, S: int, nb_substeps: int,
                 device):
    """``layout`` of a fused launch on ``device``, and the backpointers'
    global scratch where they do not fit in shared memory (else None)."""
    lay = layout(M, D, S ** nb_substeps, S, T,
                 cuda_lib.smem_bytes("extrack_topk_smem", device.index))
    return lay, (None if lay[2] else buffers(B, T, M, device)[1:])


def launch_fused(data, tabs, rows, S: int, nb_substeps: int, min_len: int,
                 plan=None):
    """Launch K7 fused on the current stream: each track's (T*S)
    histogram row into ``rows`` (B, T*S).  ``plan`` is ``fused_layout``'s
    output for these shapes (made here when None)."""
    B, T, D = data[0].shape
    M = tabs[0].shape[0]
    (region, chunk, bp_smem), bp = plan or fused_layout(
        B, T, D, M, S, nb_substeps, data[0].device)
    _launch(data, tabs, S, nb_substeps, min_len, None, bp, rows, region,
            chunk, bp_smem)


def _prepare(positions, lengths, is_bleached, tables, M, nb_substeps):
    """``check_envelope`` on the card, then ``kernel_inputs``."""
    _, T, D = positions.shape
    check_envelope(T, D, tables.nb_states, M, nb_substeps,
                   forward_kernel.classify_sig2(tables.sig2, T),
                   forward_kernel.kernel_dtype(positions, tables),
                   cuda_lib.smem_bytes("extrack_topk_smem",
                                       positions.device.index))
    with torch.no_grad():
        return kernel_inputs(positions, lengths, is_bleached, tables, M,
                             nb_substeps)


def backpointers(positions, lengths, is_bleached, tables: ModelTables, *,
                 max_nb_states: int = 512, min_len: int = 3,
                 nb_substeps: int = 1):
    """K7's raw outputs for CUDA inputs, in the plain version's layout:
    (parents (T-1, B, M) int16, states (T-1, B, M) int8, w_final (B, M)),
    the first two as views of K7's (B, T-1, M) buffers.  Raises outside
    the envelope."""
    B, T, _ = positions.shape
    S, M = tables.nb_states, max_nb_states
    data, tabs = _prepare(positions, lengths, is_bleached, tables, M,
                          nb_substeps)
    outs = buffers(B, T, M, positions.device)
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
    tracks.  CUDA inputs run K7 with its decode fused in (float32, constant
    dt; anything outside its envelope raises) and one float64 sum of the
    tracks' rows; CPU inputs run the plain version."""
    if positions.device.type == "cpu":
        return segment_topk_plain(positions, lengths, is_bleached, tables,
                                  max_nb_states=max_nb_states,
                                  min_len=min_len, nb_substeps=nb_substeps)
    B, T, _ = positions.shape
    S = tables.nb_states
    data, tabs = _prepare(positions, lengths, is_bleached, tables,
                          max_nb_states, nb_substeps)
    rows = torch.empty((B, T * S), dtype=torch.float32,
                       device=positions.device)
    launch_fused(data, tabs, rows, S, nb_substeps, min_len)
    return rows.sum(0, dtype=torch.float64).to(torch.float32).reshape(T, S)
