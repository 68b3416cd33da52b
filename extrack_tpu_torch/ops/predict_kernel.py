"""K4: the posterior kernel (csrc/predict.cu) and its host side.

Replaces extrack_tpu/ops/pallas_predict.py:_kernel (driven by
predict_pallas).  ``predict`` returns ``(logL (B,), preds (B, T, S))``, the
per-track log likelihood and per-frame state posteriors, for one sub-step
per frame:

* CUDA tensors (float32): one K4 launch on ``forward_kernel.kernel_inputs``
  (the K1 tables).  Outside the envelope it raises.
* CPU tensors: ``predict_plain``, which is ``core.engine.forward(...,
  return_preds=True)`` on the same inputs.

``LAUNCHES`` counts K4 launches, ``PLAIN_CALLS`` calls of the plain version.
"""
from __future__ import annotations

import torch

from extrack_tpu_torch.core import engine
from extrack_tpu_torch.core.tables import ModelTables
from extrack_tpu_torch.ops import cuda_lib, forward_kernel

LAUNCHES = 0
PLAIN_CALLS = 0


def history_floats(T: int, W: int, S: int) -> int:
    """Posterior history per slot: the states of the frames that can leave
    the window before a track ends (frames 0 .. T-W-1)."""
    return max(T - W, 0) * S


def launch(data, tabs, min_len: int, S: int, W: int):
    """Launch K4 on the current stream; returns logL (B,) and preds
    (B, T, S), float32."""
    global LAUNCHES
    xs = data[0]
    B, T, D = xs.shape
    K, A = tabs[6].shape
    if A != S or K != S ** W:
        raise ValueError(f"K4 takes one sub-step per frame: K={K}, A={A} "
                         f"for S={S}, W={W}")
    forward_kernel.validate(data, tabs, K, A)
    lib = cuda_lib.library()
    dev = xs.device
    f32 = dict(dtype=torch.float32, device=dev)
    logl = torch.empty(B, **f32)
    preds = torch.empty((B, T, S), **f32)
    nblk, scratch = cuda_lib.grid("extrack_predict_smem", dev, B, K,
                                  (3 + 2 * D) * K * 4,
                                  2 * K * history_floats(T, W, S) * 4)
    rc = lib.extrack_predict(
        *(t.data_ptr() for t in (*data, *tabs, logl, preds)),
        None if scratch is None else scratch.data_ptr(),
        B, T, D, K, A, int(min_len), S, W, nblk,
        torch.cuda.current_stream(dev).cuda_stream)
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
    """(logL (B,), preds (B, T, S)).  CUDA inputs run K4 (float32 only;
    anything outside its envelope raises); CPU inputs run the plain
    version."""
    if positions.device.type == "cpu":
        return predict_plain(positions, lengths, is_bleached, tables,
                             window=window, min_len=min_len)
    _, T, D = positions.shape
    forward_kernel.check_envelope(T, D, tables.nb_states, window, 1,
                                  forward_kernel.classify_sig2(tables.sig2, T),
                                  forward_kernel.kernel_dtype(positions,
                                                              tables))
    with torch.no_grad():
        data, tabs = forward_kernel.kernel_inputs(
            positions, lengths, is_bleached, tables, window, 1)
    return launch(data, tabs, min_len, tables.nb_states, window)
