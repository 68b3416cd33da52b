"""K2: the likelihood-gradient kernel (csrc/grad.cu) as a
``torch.autograd.Function``.

Replaces extrack_tpu/ops/pallas_grad.py:_grad_kernel and the custom-VJP
trio around it.  ``neg_log_likelihood`` returns -sum logL, differentiable
w.r.t. the model tables (hence the physical parameters upstream) and the
localization-error variances:

* CUDA tensors (float32 only), gradient wanted: one K2 launch computes the value and every
  table cotangent; ``backward`` only scales them.
* CUDA tensors, no gradient wanted (``torch.no_grad`` or no input requires
  grad): the cheaper forward kernel K1.
* CPU tensors: the plain version, torch autograd of ``core.engine.forward``.

Positions get no gradient on the kernel path (the fit differentiates
parameters, never data).  The kernel path is once differentiable: a second
derivative through it raises (exact second order is K3, ops/hvp_kernel).
``LAUNCHES`` counts K2 launches, ``PLAIN_CALLS`` calls of the plain
version.
"""
from __future__ import annotations

import torch

from extrack_tpu_torch.core import engine
from extrack_tpu_torch.core.tables import ModelTables
from extrack_tpu_torch.ops import cuda_lib, forward_kernel

LAUNCHES = 0
PLAIN_CALLS = 0
# bytes of per-step carry history the persistent blocks may hold
STASH_BUDGET = 1 << 30


def grid_size(B: int, T: int, D: int, K: int, device,
              itemsize: int = 4) -> int:
    """Persistent grid: enough blocks to fill the card, capped so the
    carry history (T-1)*(2D+1)*K scalars of ``itemsize`` bytes per block
    fits STASH_BUDGET."""
    threads = (K + 31) // 32 * 32
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_block = max(1, (T - 1) * (2 * D + 1) * K * itemsize)
    return max(1, min(B, sms * max(1, 2048 // threads),
                      STASH_BUDGET // per_block))


def launch(data, tabs, min_len: int):
    """Launch K2 on the current stream.  Returns logL (B,), d(sum logL)/d l2
    (B, T, D) and the ten table cotangents, shaped like ``tabs``."""
    global LAUNCHES
    xs = data[0]
    B, T, D = xs.shape
    K, A = tabs[6].shape
    forward_kernel.validate(data, tabs, K, A)
    lib = cuda_lib.library()
    dev = xs.device
    nblk = grid_size(B, T, D, K, dev)
    ncols = 6 * K + 4 * K * A
    logl = torch.empty(B, dtype=torch.float32, device=dev)
    ct_l2 = torch.zeros((B, T, D), dtype=torch.float32, device=dev)
    ct_tab = torch.empty(ncols, dtype=torch.float32, device=dev)
    stash = torch.empty(max(1, nblk * (T - 1) * (2 * D + 1) * K),
                        dtype=torch.float32, device=dev)
    partial = torch.empty(nblk * ncols, dtype=torch.float32, device=dev)
    rc = lib.extrack_grad(
        *(t.data_ptr() for t in (*data, *tabs, logl, ct_l2, ct_tab, stash,
                                 partial)),
        B, T, D, K, A, int(min_len), nblk,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(rc, "gradient")
    LAUNCHES += 1
    vecs = ct_tab[:6 * K].view(6, K).unbind(0)
    mats = ct_tab[6 * K:].view(4, K, A).unbind(0)
    return logl, ct_l2, list(vecs) + list(mats)


class NegLogLikelihood(torch.autograd.Function):
    """-sum logL with the K2 kernel's cotangents as its gradient."""

    @staticmethod
    def forward(ctx, xs, lengths, isbl, min_len, l2, *tabs):
        logl, ct_l2, cts = launch((xs, l2, lengths, isbl), list(tabs),
                                  min_len)
        ctx.save_for_backward(ct_l2, *cts)
        return -logl.sum()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        ct_l2, *cts = ctx.saved_tensors
        s = -g
        return (None, None, None, None, s * ct_l2) + tuple(s * c for c in cts)


def neg_log_likelihood_plain(positions, lengths, is_bleached,
                             tables: ModelTables, *, window: int = 6,
                             nb_substeps: int = 1,
                             min_len: int = 3) -> torch.Tensor:
    """The plain version of K2's value: -sum of ``core.engine.forward``
    (differentiable with torch autograd)."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    return -engine.forward(positions, lengths, is_bleached, tables,
                           window=window, nb_substeps=nb_substeps,
                           min_len=min_len).sum()


def neg_log_likelihood(positions, lengths, is_bleached, tables: ModelTables,
                       *, window: int = 6, nb_substeps: int = 1,
                       min_len: int = 3) -> torch.Tensor:
    """-sum logL of a batch; see the module docstring for the paths."""
    if positions.device.type == "cpu":
        return neg_log_likelihood_plain(positions, lengths, is_bleached,
                                        tables, window=window,
                                        nb_substeps=nb_substeps,
                                        min_len=min_len)
    B, T, D = positions.shape
    forward_kernel.check_envelope(
        T, D, tables.nb_states, window, nb_substeps,
        forward_kernel.classify_sig2(tables.sig2, T),
        forward_kernel.kernel_dtype(positions, tables))
    (xs, l2, lens, isbl), tabs = forward_kernel.kernel_inputs(
        positions, lengths, is_bleached, tables, window, nb_substeps)
    if torch.is_grad_enabled() and (
            l2.requires_grad or any(t.requires_grad for t in tabs)):
        return NegLogLikelihood.apply(xs, lens, isbl, min_len, l2, *tabs)
    return -forward_kernel.launch((xs, l2, lens, isbl),
                                  [t.detach() for t in tabs], min_len).sum()


def _table_grads(fn, positions, lengths, is_bleached, tables, **kw):
    leaves = ModelTables(*(f.detach().requires_grad_(True) for f in tables))
    value = fn(positions, lengths, is_bleached, leaves, **kw)
    grads = torch.autograd.grad(value, list(leaves), allow_unused=True)
    return value.detach(), {
        name: torch.zeros_like(f) if g is None else g
        for name, f, g in zip(ModelTables._fields, leaves, grads)}


def value_and_table_grads(positions, lengths, is_bleached,
                          tables: ModelTables, **kw):
    """(-sum logL, {ModelTables field: gradient}) through the kernels (or
    the plain version for CPU tensors)."""
    return _table_grads(neg_log_likelihood, positions, lengths, is_bleached,
                        tables, **kw)


def value_and_table_grads_plain(positions, lengths, is_bleached,
                                tables: ModelTables, **kw):
    """The same through torch autograd of ``core.engine.forward``."""
    return _table_grads(neg_log_likelihood_plain, positions, lengths,
                        is_bleached, tables, **kw)
