"""K5: the duration-histogram kernel (csrc/hist.cu, hist_wide.cu) and its
host side.

Replaces extrack_tpu/ops/pallas_hist.py:_kernel (driven by hist_pallas),
and JAX's XLA window engine where that kernel stops (more than one
sub-step a frame, past its VMEM budget).  ``hist`` returns the (T, S)
posterior-expected segment-length histogram of a batch, summed over its
tracks:

* CUDA tensors (float32): one K5 launch on the K1 per-slot tables
  (``forward_kernel.kernel_inputs``; with variable dt also the streamed
  (B, T-1, P) displacement variances): a thread a slot up to 1024 slots,
  a thread a fusion group up to 2^19 (``forward_kernel.mapping_warps``),
  with the publish areas and member weights in global scratch beside the
  rows where a block's shared memory cannot hold them.  Up to 16384 slots
  the harvest reads the window's static segment tables
  (``device_segment_tables``, built on the card); past them it takes each
  slot's runs from its digits (``histograms.slot_runs`` is its plain
  version) and no table is built, on a persistent grid bounded by
  ``cuda_lib.scratch_budget`` past 16384 slots (``runs_grid``).  Outside the envelope it raises.
* CPU tensors: ``hist_plain``, which is
  ``histograms.window_segment_histogram`` on the same inputs.

``LAUNCHES`` counts K5 launches, ``PLAIN_CALLS`` calls of the plain version.
"""
from __future__ import annotations

import functools

import torch

from extrack_tpu_torch import histograms
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


RUNS = 3                  # the C interface's ``wide`` of the digits' harvest


@functools.lru_cache(maxsize=16)
def device_segment_tables(S: int, W: int, T: int, n: int,
                          device: torch.device):
    """K5's static tables on ``device``, built there once per shape from
    ``histograms.segment_tables`` (vectorized over the slots): ``seg``
    (Wf+2, S*T, K) float32, the slot axis last so that a warp reads
    consecutive slots, and ``ext`` (K,) int32 (``window_frames`` gives
    Wf).  Up to SCRATCH_MAX_K slots only: past them the kernel takes
    each slot's runs from its digits (``harvest_tables``)."""
    seg, ext = histograms.segment_tables(S, W, T, n, device=device,
                                         dtype=torch.float32)
    return (seg.transpose(1, 2).contiguous(),
            ext.to(torch.int32).contiguous())


def segment_tables(S: int, W: int, T: int, n: int = 1):
    """``device_segment_tables`` on the host, as numpy (tests, tools)."""
    seg, ext = device_segment_tables(S, W, T, n, torch.device("cpu"))
    return seg.numpy(), ext.numpy()


def harvest_tables(S: int, W: int, T: int, n: int, device):
    """What a K5 launch's harvest reads besides its rows: the static
    segment tables (``device_segment_tables``) up to SCRATCH_MAX_K slots;
    past them (None, None), no table built."""
    if S ** W > forward_kernel.SCRATCH_MAX_K:
        return None, None
    return device_segment_tables(S, W, T, n, device)


def runs_grid(B: int, T: int, K: int, block_bytes: int, sms: int,
              threads: int, budget: int):
    """(blocks, scratch floats) of a K5 launch past 16384 slots: as many
    persistent blocks as ``sms`` SMs keep resident (1024 threads an SM at
    the wide kernels' 64 registers), no more than the ``B`` tracks, and no
    more than ``budget`` bytes of ``block_bytes`` each (the rows, publish
    areas and member weights of one track of T frames).  Raises
    RuntimeError, naming the batch and the bytes, where one block alone
    passes the budget."""
    if block_bytes > budget:
        raise RuntimeError(
            f"one K5 block's global scratch ({block_bytes} bytes: the rows, "
            f"publish areas and member weights of a track of {T} frames at "
            f"K={K}, batch of {B} tracks) passes the {budget} bytes the card "
            "can give it; split the longest tracks' bucket or free device "
            "memory")
    nblk = max(1, min(B, sms * max(1, 1024 // threads),
                      budget // block_bytes))
    return nblk, nblk * block_bytes // 4


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
    seg, ext = harvest_tables(S, W, T, n, dev)
    rows = torch.empty((B, S * T), dtype=torch.float32, device=dev)
    w = int(forward_kernel.mapping_warps("K5", K, mapping)
            == forward_kernel.WIDE)
    if seg is None:
        # past 16384 slots: the harvest from the slots' digits
        threads, _, block_bytes = cuda_lib.layout("hist", T, D, K, S, A,
                                                  RUNS)
        nblk, floats = runs_grid(
            B, T, K, block_bytes,
            torch.cuda.get_device_properties(dev).multi_processor_count,
            threads, cuda_lib.scratch_budget(dev, K))
        w, scratch = RUNS, torch.empty(floats, dtype=torch.float32,
                                       device=dev)
    else:
        threads, fixed, rows_bytes = cuda_lib.layout("hist", T, D, K, S, A,
                                                     w)
        if w and fixed > cuda_lib.smem_bytes("extrack_hist_smem",
                                             dev.index):
            w = 2   # the wide publish areas and weights in global scratch
            threads, fixed, rows_bytes = cuda_lib.layout("hist", T, D, K, S,
                                                         A, w)
        nblk, scratch = cuda_lib.grid("extrack_hist_smem", dev, B, fixed,
                                      rows_bytes, threads)
    rc = lib.extrack_hist(
        *(t.data_ptr() for t in (*data, *tabs[:6])),
        tabs[10].data_ptr() if P else None,
        *(None if t is None else t.data_ptr() for t in (seg, ext, rows)),
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
