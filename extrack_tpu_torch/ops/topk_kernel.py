"""K7: the top-K duration-histogram kernel (csrc/topk.cu) and its host side.

Replaces extrack_tpu/ops/pallas_topk.py:_topk_kernel (driven by
segment_topk_pallas).  ``segment_topk`` returns the (T, S)
posterior-expected segment-length histogram of the top-K engine, summed
over a batch's tracks:

* CUDA tensors (float32; constant dt, or with variable dt the streamed
  (B, T-1, P) displacement variances of K1..K5,
  ``forward_kernel.sig2_stream``): one K7 launch (``launch_fused``)
  walks each track's register of M sequences, backtracks its final
  sequences from backpointers it keeps in shared memory and writes the
  track's (T*S) histogram row; one float64 sum over the rows follows, in
  a fixed order, so the same input gives the same bits.  Up to 1024
  register rows a thread owns one row, a block one track; past them (up
  to MAX_ROWS = 4096), or where that walk's words pass a block's shared
  memory, persistent blocks of the wide kernel give a thread several rows,
  with the walk and the backpointers in shared memory where they fit and
  in each block's slice of global scratch where not (``wide_layout``,
  ``wide_grid``).  No (B, M, T)
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

from typing import NamedTuple

import numpy as np
import torch

from extrack_tpu_torch import histograms
from extrack_tpu_torch.core import tables as ttables
from extrack_tpu_torch.core.tables import LOG_FLOOR, ModelTables
from extrack_tpu_torch.ops import cuda_lib, forward_kernel

LAUNCHES = 0
PLAIN_CALLS = 0
THREAD_ROWS = 1024        # one thread per register row, one block per track
MAX_ROWS = 4096           # the wide kernel: up to four rows a thread
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
                   variable_dt: bool = False, dtype=torch.float32):
    """Raise NotImplementedError when K7 cannot run this configuration,
    naming the largest M that fits past MAX_ROWS.  Variable dt
    (``variable_dt``, per step or per track) is in the envelope: K7 reads
    the stream (``kernel_inputs``).  Any M from nb_states^(nb_substeps+1)
    to MAX_ROWS runs: where a one-row-a-thread walk does not fit a block's
    shared memory, the wide kernel takes it (``wide``)."""
    A = S ** nb_substeps
    P = S * A
    reasons = []
    if dtype != torch.float32:
        reasons.append(f"dtype {dtype} (K7 computes in float32: pass "
                       "float32 tensors)")
    if D not in (1, 2, 3):
        reasons.append(f"D={D} (K7 takes 1..3 dimensions)")
    if M < P:
        reasons.append(f"max_nb_states={M} < nb_states^(nb_substeps+1)"
                       f"={P}")
    elif M > MAX_ROWS:
        reasons.append(
            f"max_nb_states={M}: K7 holds at most {MAX_ROWS} rows (a thread "
            f"up to {MAX_ROWS // THREAD_ROWS} of them; the largest "
            f"max_nb_states that fits is {MAX_ROWS})")
    if reasons:
        raise NotImplementedError(
            f"top-K histogram batch (T={T}, D={D}, S={S}, max_nb_states={M}, "
            f"nb_substeps={nb_substeps}) is outside K7's envelope: "
            + "; ".join(reasons))


def wide(M: int, D: int, A: int, smem_limit: int) -> bool:
    """Whether K7 runs its wide kernel: past THREAD_ROWS rows, or where
    the one-row-a-thread walk (``walk_bytes``) passes ``smem_limit``."""
    return M > THREAD_ROWS or walk_bytes(M, D, A) > smem_limit


class WideLayout(NamedTuple):
    """One block of K7's wide kernel (csrc/topk.cu topk_wide_walk)."""
    threads: int
    region: int           # bytes of the walk: rows, words, fold
    chunk: int            # decode bins a pass (fused)
    walk_smem: bool       # the walk in shared memory, else in scratch
    bp_smem: bool         # the fused backpointers in shared memory
    smem: int             # dynamic shared bytes
    slice: int            # global scratch bytes a block


def wide_walk_bytes(M: int, D: int, A: int) -> int:
    """The wide kernel's walk region (topk.cu's wide_walk_bytes): the
    rows, 2D+4 floats each (mean and variance per dimension, lp, ll, the
    final weight, the newest state), then ``walk_bytes``' words and
    fold."""
    return 4 * (2 * D + 4) * M + walk_bytes(M, D, A)


def wide_layout(M: int, D: int, A: int, S: int, T: int, smem_limit: int,
                raw: bool = False) -> WideLayout:
    """The wide kernel's block: up to THREAD_ROWS threads, a thread rows
    r, r + threads, ...; the walk region in shared memory where it fits
    ``smem_limit``, else at the front of the block's slice of global
    scratch; the fused backpointers ((T-1)*M int16 and int8) in shared
    memory where they fit beside what is there, else in the slice; the
    decode's columns (a float a thread and bin) over the words and fold,
    as many bins a pass as fit, up to T*S.  The slice is rounded up to 16
    bytes."""
    threads = min(THREAD_ROWS, -(-M // 32) * 32)
    region = wide_walk_bytes(M, D, A)
    bp = 0 if raw else 3 * max(T - 1, 0) * M
    walk_smem = region <= smem_limit
    used = region if walk_smem else 0
    bp_smem = bp > 0 and used + bp <= smem_limit
    words = region - 4 * (2 * D + 4) * M
    scratch = (0 if walk_smem else region) + (0 if bp_smem else bp)
    return WideLayout(threads, region,
                      max(1, min(T * S, words // (4 * threads))), walk_smem,
                      bp_smem, used + (bp if bp_smem else 0),
                      -(-scratch // 16) * 16)


def wide_grid(B: int, lay: WideLayout, sms: int, budget: int) -> int:
    """Persistent blocks of a wide launch: as many as ``sms`` SMs keep
    resident by threads and registers (2048 and 65536 an SM, REGISTERS a
    thread), no more than the ``B`` tracks, and no more slices of scratch
    than ``budget`` bytes hold; RuntimeError where one slice alone passes
    it."""
    resident = min(2048 // lay.threads, 65536 // (REGISTERS * lay.threads))
    nblk = max(1, min(B, sms * max(1, resident)))
    if lay.slice > budget:
        raise RuntimeError(
            f"one K7 block's global scratch ({lay.slice} bytes) passes the "
            f"{budget} bytes the card can give it; free device memory")
    return max(1, min(nblk, budget // lay.slice)) if lay.slice else nblk


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
    (B,) int32, isBL (B,) float32, and with variable dt at T >= 2
    (``forward_kernel.classify_sig2``) the (B, T-1, P) stream,
    ``forward_kernel.sig2_stream``), contiguous, and ``topk_tables``.
    The stream is per track, so it travels with the data: a slice of the
    tracks slices it too.  Under it K7 reads each track's row 0 in place
    of ``s20`` (pattern r for row r < P, else pattern 0) and step t's row
    in place of ``tab``'s sig2 block: the rows ``histograms.
    segment_backpointers`` reads."""
    B, T, D = positions.shape
    f32 = torch.float32
    data = (positions.to(f32).contiguous(),
            tables.loc_err2.to(f32).expand(B, T, D).contiguous(),
            lengths.to(torch.int32).contiguous(),
            is_bleached.to(f32).contiguous())
    if T >= 2 and forward_kernel.classify_sig2(tables.sig2, T):
        data += (forward_kernel.sig2_stream(tables.sig2, B, T),)
    return data, topk_tables(tables, M, nb_substeps)


def buffers(B: int, T: int, M: int, device):
    """K7's outputs, every element of which it writes: w_final (B, M)
    float32, parents (B, T-1, M) int16, states (B, T-1, M) int8."""
    steps = (B, max(T - 1, 0), M)
    return (torch.empty((B, M), dtype=torch.float32, device=device),
            torch.empty(steps, dtype=torch.int16, device=device),
            torch.empty(steps, dtype=torch.int8, device=device))


def _check_inputs(data, tabs, S, nb_substeps, w_final, bp, rows):
    """The checks before raw pointers go to K7: the track data (and the
    stream of variable dt), the tables and the outputs."""
    xs = data[0]
    B, T, D = xs.shape
    M = tabs[0].shape[0]
    A = S ** nb_substeps
    f32, i32 = torch.float32, torch.int32
    steps = (B, max(T - 1, 0), M)
    stream = data[4] if len(data) > 4 else None
    want = list(zip((*data[:4], *tabs),
                    [(B, T, D), (B, T, D), (B,), (B,), (M,), (M,), (2, M),
                     (2 * A * S + A + S,)],
                    [f32, f32, i32, f32, f32, f32, i32, f32]))
    if stream is not None:
        if T < 2:
            raise ValueError(f"a stream of displacement variances needs "
                             f"T >= 2, got T={T}")
        want.append((stream, (B, T - 1, A * S), f32))
    if rows is None:
        want.append((w_final, (B, M), f32))
    else:
        want.append((rows, (B, T * S), f32))
    if bp is not None:
        want += [(bp[0], steps, torch.int16), (bp[1], steps, torch.int8)]
    cuda_lib.check_args(want, xs.device)
    return stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(data, tabs, S: int, nb_substeps: int, min_len: int, w_final,
            bp, rows, region: int, chunk: int, bp_smem: bool):
    """One K7 launch on the current stream, raw (``rows`` None: w_final
    and the backpointers ``bp`` out) or fused (``rows`` out, ``bp`` the
    backpointers' global scratch unless ``bp_smem``); a fifth entry of
    ``data`` is the stream of variable dt."""
    global LAUNCHES
    xs = data[0]
    B, T, D = xs.shape
    M = tabs[0].shape[0]
    stream = _check_inputs(data, tabs, S, nb_substeps, w_final, bp, rows)
    rc = cuda_lib.library().extrack_topk(
        *(t.data_ptr() for t in (*data[:4], *tabs)), _ptr(stream),
        _ptr(w_final),
        *((None, None) if bp is None else map(_ptr, bp)), _ptr(rows),
        B, T, D, M, S, S ** nb_substeps, S ** (nb_substeps - 1),
        int(min_len), int(rows is None), int(bp_smem), region, chunk,
        torch.cuda.current_stream(xs.device).cuda_stream)
    cuda_lib.check(rc, "top-K histogram")
    LAUNCHES += 1


def _launch_wide(data, tabs, S: int, nb_substeps: int, min_len: int,
                 w_final, bp, rows, lay: WideLayout):
    """One launch of K7's wide kernel on the current stream, raw (``rows``
    None: w_final and the backpointers ``bp`` out) or fused (``rows``
    out), on ``wide_grid``'s blocks, each with its slice of scratch."""
    global LAUNCHES
    xs = data[0]
    B, T, D = xs.shape
    M = tabs[0].shape[0]
    dev = xs.device
    stream = _check_inputs(data, tabs, S, nb_substeps, w_final, bp, rows)
    nblk = wide_grid(B, lay, forward_kernel._sms(dev.index),
                     cuda_lib.scratch_budget(dev))
    scratch = (torch.empty(nblk * lay.slice, dtype=torch.uint8, device=dev)
               if lay.slice else None)
    rc = cuda_lib.library().extrack_topk_wide(
        *(t.data_ptr() for t in (*data[:4], *tabs)), _ptr(stream),
        _ptr(w_final), *((None, None) if bp is None else map(_ptr, bp)),
        _ptr(rows), _ptr(scratch), B, T, D, M, S, S ** nb_substeps,
        S ** (nb_substeps - 1), int(min_len), int(rows is None),
        int(lay.walk_smem), int(lay.bp_smem), lay.region, lay.chunk, nblk,
        lay.slice, torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(rc, "top-K histogram (wide)")
    LAUNCHES += 1


def _smem_limit(device) -> int:
    return cuda_lib.smem_bytes("extrack_topk_smem", device.index)


def launch(data, tabs, outs, S: int, nb_substeps: int, min_len: int):
    """Launch K7 raw on the current stream into ``outs`` (``buffers``'
    three tensors, for the B tracks of ``data``): the one-row-a-thread
    kernel, or the wide one (``wide``)."""
    _, T, D = data[0].shape
    M, A = tabs[0].shape[0], S ** nb_substeps
    limit = _smem_limit(data[0].device)
    if wide(M, D, A, limit):
        _launch_wide(data, tabs, S, nb_substeps, min_len, outs[0], outs[1:],
                     None, wide_layout(M, D, A, S, T, limit, raw=True))
        return
    _launch(data, tabs, S, nb_substeps, min_len, outs[0], outs[1:], None,
            walk_bytes(M, D, A), 1, False)


def fused_layout(B: int, T: int, D: int, M: int, S: int, nb_substeps: int,
                 device):
    """The plan of a fused launch on ``device``: ``layout`` and the
    backpointers' global scratch where they do not fit in shared memory
    (else None); for the wide kernel, its ``wide_layout`` and None (each
    launch takes its blocks' slices of scratch)."""
    A = S ** nb_substeps
    limit = _smem_limit(device)
    if wide(M, D, A, limit):
        return wide_layout(M, D, A, S, T, limit), None
    lay = layout(M, D, A, S, T, limit)
    return lay, (None if lay[2] else buffers(B, T, M, device)[1:])


def launch_fused(data, tabs, rows, S: int, nb_substeps: int, min_len: int,
                 plan=None):
    """Launch K7 fused on the current stream: each track's (T*S)
    histogram row into ``rows`` (B, T*S).  ``plan`` is ``fused_layout``'s
    output for these shapes (made here when None)."""
    B, T, D = data[0].shape
    M = tabs[0].shape[0]
    lay, bp = plan or fused_layout(B, T, D, M, S, nb_substeps,
                                   data[0].device)
    if isinstance(lay, WideLayout):
        _launch_wide(data, tabs, S, nb_substeps, min_len, None, None, rows,
                     lay)
        return
    region, chunk, bp_smem = lay
    _launch(data, tabs, S, nb_substeps, min_len, None, bp, rows, region,
            chunk, bp_smem)


def _prepare(positions, lengths, is_bleached, tables, M, nb_substeps):
    """``check_envelope`` on the card, then ``kernel_inputs``."""
    _, T, D = positions.shape
    check_envelope(T, D, tables.nb_states, M, nb_substeps,
                   forward_kernel.classify_sig2(tables.sig2, T),
                   forward_kernel.kernel_dtype(positions, tables))
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
    or variable dt; anything outside its envelope raises) and one float64
    sum of the tracks' rows; CPU inputs run the plain version."""
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
