"""K5: the duration-histogram kernel (csrc/hist.cu) and its host side.

Replaces extrack_tpu/ops/pallas_hist.py:_kernel (driven by hist_pallas),
and JAX's XLA window engine where that kernel stops (more than one
sub-step a frame).  ``hist`` returns the (T, S) posterior-expected
segment-length histogram of a batch, summed over its tracks:

* CUDA tensors (float32): one K5 launch on the K1 per-slot tables
  (``forward_kernel.kernel_inputs``; with variable dt also the streamed
  (B, T-1, P) displacement variances) and the window's static segment
  tables (``segment_tables``): a thread a slot up to 1024 slots, a thread
  a fusion group up to 16384 (``forward_kernel.mapping_warps``), with the
  publish areas and member weights in global scratch beside the rows
  where a block's shared memory cannot hold them.  Outside the envelope
  it raises.
* CPU tensors: ``hist_plain``, which is
  ``histograms.window_segment_histogram`` on the same inputs.

``LAUNCHES`` counts K5 launches, ``PLAIN_CALLS`` calls of the plain version.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from extrack_tpu_torch import histograms
from extrack_tpu_torch.core import engine
from extrack_tpu_torch.core.tables import ModelTables
from extrack_tpu_torch.ops import cuda_lib, forward_kernel

LAUNCHES = 0
PLAIN_CALLS = 0


def window_frames(W: int, n: int) -> int:
    """Frames Wf = (W-1)/n + 1 that a window of W sub-steps covers at n
    sub-steps a frame; ValueError unless the frames align with it, as the
    plain version requires."""
    if (W - 1) % n:
        raise ValueError(f"window-1 ({W - 1}) must be a multiple of "
                         f"nb_substeps ({n}) so frames align")
    return (W - 1) // n + 1


@functools.lru_cache(maxsize=16)
def segment_tables(S: int, W: int, T: int, n: int = 1):
    """K5's static tables as numpy: ``seg`` (Wf+2, S*T, K) float32 and
    ``ext`` (K,) int32, for a window of W sub-steps at n a frame (Wf
    frames, ``window_frames``).  ``seg[v]`` for v <= Wf counts the runs
    among the newest v frames of each slot's window (``seg_all``),
    ``seg[Wf+1]`` the runs completed inside the window (``seg_int``); bin
    j = s*T + m is a length-(m+1) segment in state s, and the slot axis is
    last so that a warp reads consecutive slots.  ``ext`` is the length in
    frames of the run at each window's oldest end."""
    Wf = window_frames(W, n)
    spec = engine.make_register_spec(S, W, n)
    seg_int, seg_all, ext = histograms._segment_tables(spec.codes, W, T, S,
                                                       stride=n)
    seg = np.concatenate([seg_all, seg_int[None]])        # (Wf+2, K, T, S)
    seg = seg.transpose(0, 3, 2, 1).reshape(Wf + 2, S * T, S ** W)
    return (np.ascontiguousarray(seg, dtype=np.float32),
            ext.astype(np.int32))


@functools.lru_cache(maxsize=16)
def device_segment_tables(S: int, W: int, T: int, n: int,
                          device: torch.device):
    """``segment_tables`` as tensors on ``device``, built once per shape."""
    seg_np, ext_np = segment_tables(S, W, T, n)
    return (torch.tensor(seg_np, device=device),
            torch.tensor(ext_np, device=device))


def launch(data, tabs, min_len: int, S: int, W: int, n: int = 1,
           mapping: str | None = None) -> torch.Tensor:
    """Launch K5 on the current stream with the tables of
    ``forward_kernel.kernel_inputs`` (W sub-steps, n a frame; with variable
    dt the eleventh, the stream, is read in place of s20 and sig2v);
    returns the (T, S) histogram, float32 (the per-track rows are summed
    in float64 by one reduction without atomics, so the same input gives
    the same bits).  ``mapping`` forces ``forward_kernel.mapping_warps``'
    choice (tests, tools)."""
    global LAUNCHES
    xs = data[0]
    B, T, D = xs.shape
    K, A = S ** W, S ** n
    forward_kernel.validate(data, tabs, K, A)
    P = forward_kernel.stream_patterns(tabs)
    lib = cuda_lib.library()
    dev = xs.device
    seg, ext = device_segment_tables(S, W, T, n, dev)
    rows = torch.empty((B, S * T), dtype=torch.float32, device=dev)
    w = int(forward_kernel.mapping_warps("K5", K, mapping)
            == forward_kernel.WIDE)
    threads, fixed, rows_bytes = cuda_lib.layout("hist", T, D, K, S, A, w)
    if w and fixed > cuda_lib.smem_bytes("extrack_hist_smem", dev.index):
        w = 2       # the wide publish areas and weights in global scratch
        threads, fixed, rows_bytes = cuda_lib.layout("hist", T, D, K, S, A,
                                                     w)
    nblk, scratch = cuda_lib.grid("extrack_hist_smem", dev, B, fixed,
                                  rows_bytes, threads)
    rc = lib.extrack_hist(
        *(t.data_ptr() for t in (*data, *tabs[:6])),
        tabs[10].data_ptr() if P else None,
        *(t.data_ptr() for t in (seg, ext, rows)),
        None if scratch is None else scratch.data_ptr(),
        B, T, D, K, A, P, int(min_len), S, window_frames(W, n), nblk, w,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(rc, "histogram")
    LAUNCHES += 1
    out = rows.sum(dim=0, dtype=torch.float64).to(torch.float32)
    return out.reshape(S, T).T


def hist_plain(positions, lengths, is_bleached, tables: ModelTables, *,
               window: int = 7, min_len: int = 3, nb_substeps: int = 1):
    """The plain version of K5: ``histograms.window_segment_histogram``."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    return histograms.window_segment_histogram(
        positions, lengths, is_bleached, tables, window=window,
        min_len=min_len, nb_substeps=nb_substeps)


def hist(positions, lengths, is_bleached, tables: ModelTables, *,
         window: int = 7, min_len: int = 3, nb_substeps: int = 1):
    """(T, S) segment-length histogram summed over the tracks.  CUDA
    inputs run K5 (float32, constant or variable dt, any number of
    sub-steps a frame; anything outside its envelope raises); CPU inputs
    run the plain version."""
    if positions.device.type == "cpu":
        return hist_plain(positions, lengths, is_bleached, tables,
                          window=window, min_len=min_len,
                          nb_substeps=nb_substeps)
    _, T, D = positions.shape
    S = tables.nb_states
    window_frames(window, nb_substeps)    # raises unless frames align
    forward_kernel.check_envelope(
        T, D, S, window, nb_substeps,
        forward_kernel.classify_sig2(tables.sig2, T),
        forward_kernel.kernel_dtype(positions, tables),
        what="histogram batch", kernel="K5")
    with torch.no_grad():
        data, tabs = forward_kernel.kernel_inputs(
            positions, lengths, is_bleached, tables, window, nb_substeps)
    return launch(data, tabs, min_len, S, window, nb_substeps)
