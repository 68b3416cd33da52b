"""K4: the posterior kernel (csrc/predict.cu) and its host side.

Replaces extrack_tpu/ops/pallas_predict.py:_kernel (driven by
predict_pallas).  ``predict`` returns ``(logL (B,), preds (B, T, S))``, the
per-track log likelihood and per-frame state posteriors, for one sub-step
per frame:

* CUDA tensors (float32): one K4 launch on ``forward_kernel.kernel_inputs``
  (the K1 tables, and with variable dt the streamed displacement
  variances), mapped as K1 (``forward_kernel.plan``: up to 65536 slots,
  past what a block's shared memory holds with the wide mapping's carries
  in global scratch), with its stash of fusion weights in shared memory or
  global scratch; the persistent grid takes no more scratch than the
  card's free memory allows (``cuda_lib.scratch_budget``).  Outside the
  envelope it raises.
* CPU tensors: ``predict_plain``, which is ``core.engine.forward(...,
  return_preds=True)`` on the same inputs.

``LAUNCHES`` counts K4 launches, ``PLAIN_CALLS`` calls of the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from extrack_tpu_torch.core import engine
from extrack_tpu_torch.core.tables import ModelTables
from extrack_tpu_torch.ops import cuda_lib, forward_kernel

LAUNCHES = 0
PLAIN_CALLS = 0


@functools.cache
def layout(T: int, D: int, K: int, S: int, W: int, warps: int, P: int = 0):
    """(shared bytes of one team besides its stash, the stash's bytes) of
    a K4 launch (``P`` > 0: variable dt), as the kernel's source defines
    its team (``extrack_predict_layout``; ``warps`` from
    ``forward_kernel.mapping_warps``: a warp, or a block for the block and
    wide mappings; at ``forward_kernel.WIDE_GLOBAL`` the partials' bytes
    and the block's global scratch: carries and stash)."""
    out = (ctypes.c_longlong * 3)()
    cuda_lib.check(cuda_lib.library().extrack_predict_layout(
        T, D, K, S, W, warps, P, ctypes.addressof(out)), "K4 layout")
    return out[1], out[2]


def setup(B: int, T: int, D: int, K: int, S: int, W: int, dev,
          mapping: str | None = None, stash: str | None = None, P: int = 0):
    """The plan, blocks and bytes of global stash scratch of one K4 launch
    on ``dev`` (``P`` > 0: variable dt), from the kernel's own layout and
    occupancy queries."""
    def occ(warps, smem):
        return forward_kernel._occupancy("extrack_predict_occupancy", D, K,
                                         S, T, W, warps, int(smem), P)

    fixed, stash_bytes = layout(
        T, D, K, S, W, forward_kernel.mapping_warps("K4", K, mapping), P)
    pl = forward_kernel.plan(
        "K4", K, fixed, stash_bytes,
        cuda_lib.smem_bytes("extrack_predict_smem", dev.index), occ,
        mapping, stash)
    if pl.warps == forward_kernel.WIDE_GLOBAL:
        _, stash_bytes = layout(T, D, K, S, W, pl.warps, P)
    budget = (cuda_lib.scratch_budget(dev)
              if stash_bytes and not pl.stash_smem else None)
    nblk, scratch = forward_kernel.grid(B, pl, forward_kernel._sms(dev.index),
                                        occ(pl.warps, pl.stash_smem),
                                        stash_bytes, budget)
    return pl, nblk, scratch


def launch(data, tabs, min_len: int, S: int, W: int,
           mapping: str | None = None, stash: str | None = None):
    """Launch K4 on the current stream; returns logL (B,) and preds
    (B, T, S), float32.  ``mapping`` ("warp"/"block"/"wide") and
    ``stash`` (the fusion weights' stash in "smem" or "global" memory)
    force ``forward_kernel.plan``'s choices (tests, tools)."""
    global LAUNCHES
    xs = data[0]
    B, T, D = xs.shape
    K, A = tabs[6].shape
    if A != S or K != S ** W:
        raise ValueError(f"K4 takes one sub-step per frame: K={K}, A={A} "
                         f"for S={S}, W={W}")
    forward_kernel.validate(data, tabs, K, A)
    P = forward_kernel.stream_patterns(tabs)
    lib = cuda_lib.library()
    dev = xs.device
    pl, nblk, nscratch = setup(B, T, D, K, S, W, dev, mapping, stash, P)
    f32 = dict(dtype=torch.float32, device=dev)
    logl = torch.empty(B, **f32)
    preds = torch.empty((B, T, S), **f32)
    scratch = torch.empty(nscratch // 4, **f32) if nscratch else None
    rc = lib.extrack_predict(
        *(t.data_ptr() for t in (*data, *tabs[:10])),
        *(None if t is None else t.data_ptr()
          for t in (tabs[10] if P else None, logl, preds, scratch)),
        B, T, D, K, A, int(min_len), S, W, nblk, pl.warps,
        int(pl.stash_smem), P, torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(rc, "posterior")
    LAUNCHES += 1
    return logl, preds


def predict_plain(positions, lengths, is_bleached, tables: ModelTables, *,
                  window: int = 5, min_len: int = 3):
    """The plain version of K4: ``core.engine.forward(...,
    return_preds=True)``."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    return engine.forward(positions, lengths, is_bleached, tables,
                          window=window, nb_substeps=1, min_len=min_len,
                          return_preds=True)


def predict(positions, lengths, is_bleached, tables: ModelTables, *,
            window: int = 5, min_len: int = 3):
    """(logL (B,), preds (B, T, S)).  CUDA inputs run K4 (float32 only,
    constant or variable dt; anything outside its envelope raises); CPU
    inputs run the plain version."""
    if positions.device.type == "cpu":
        return predict_plain(positions, lengths, is_bleached, tables,
                             window=window, min_len=min_len)
    _, T, D = positions.shape
    forward_kernel.check_envelope(T, D, tables.nb_states, window, 1,
                                  forward_kernel.classify_sig2(tables.sig2, T),
                                  forward_kernel.kernel_dtype(positions,
                                                              tables),
                                  kernel="K4")
    with torch.no_grad():
        data, tabs = forward_kernel.kernel_inputs(
            positions, lengths, is_bleached, tables, window, 1)
    return launch(data, tabs, min_len, tables.nb_states, window)
