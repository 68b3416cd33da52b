"""K2: the likelihood-gradient kernel (csrc/grad.cu) as a
``torch.autograd.Function``.

Replaces extrack_tpu/ops/pallas_grad.py:_grad_kernel and the custom-VJP
trio around it.  ``neg_log_likelihood`` returns -sum logL, differentiable
w.r.t. the model tables (hence the physical parameters upstream) and the
localization-error variances:

* CUDA tensors (float32 only), gradient wanted: one K2 launch computes the value and every
  table cotangent; ``backward`` only scales them.  ``plan`` picks K2's
  mapping: one warp per track for K <= 64 (its carry history in shared
  memory when it fits), one block per track above.
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

from typing import NamedTuple

import torch

from extrack_tpu_torch.core import engine
from extrack_tpu_torch.core.tables import ModelTables
from extrack_tpu_torch.ops import cuda_lib, forward_kernel

LAUNCHES = 0
PLAIN_CALLS = 0
# bytes of per-step carry history the persistent blocks may hold in global
# scratch
STASH_BUDGET = 1 << 30
WARP_MAX_K = 64           # the warp mapping's largest register (2 per lane)
WARPS = (4, 2, 1)         # warps per block the warp mapping may launch


class Plan(NamedTuple):
    """How one K2 / K3 launch maps tracks onto the card."""
    warps: int            # warps per block of the warp mapping; 0: block
    stash_smem: bool      # the warp mapping's carry history in shared memory


def history_floats(T: int, D: int, K: int) -> int:
    """Scalars of one track's carry history: (T-1)(2D+1)K."""
    return max(T - 1, 0) * (2 * D + 1) * K


def warp_slice_bytes(K: int, A: int, D: int, T: int, stash_smem: bool,
                     itemsize: int = 4) -> int:
    """Shared memory of one warp of the warp mapping (grad.cuh's
    warp_slice): the publish area, the cotangent accumulators of the (K,)
    and (K, A) tables, two buffers of a track's positions, variances,
    length and flag and, when ``stash_smem``, the carry history."""
    return itemsize * ((9 + 4 * D) * K + 4 * K * A + 4 * T * D + 4
                       + (history_floats(T, D, K) if stash_smem else 0))


def plan(K: int, A: int, D: int, T: int, smem_limit: int, occupancy,
         itemsize: int = 4, mapping: str | None = None,
         stash: str | None = None) -> Plan:
    """K2's mapping for one launch: the warp mapping for K <= WARP_MAX_K,
    else the block mapping (``mapping`` "warp"/"block" forces one).  The
    warp mapping keeps the carry history in shared memory where it fits:
    where one warp's slice with it fits ``smem_limit`` (the opt-in limit a
    block may ask for) and, with the warps per block of WARPS that keep the
    most warps resident on an SM (``occupancy(warps, stash_smem)`` gives
    the blocks), as many warps stay resident as with the history in global
    scratch; else in global scratch, 4 warps per block (``stash``
    "smem"/"global" forces where)."""
    mapping = mapping or ("warp" if K <= WARP_MAX_K else "block")
    if mapping == "block":
        if stash == "smem":
            raise ValueError("the block mapping keeps its carry history in "
                             "global scratch")
        return Plan(0, False)
    if K > WARP_MAX_K:
        raise ValueError(f"the warp mapping takes K <= {WARP_MAX_K}, got {K}")
    if stash != "global":
        fits = [w for w in WARPS
                if w * warp_slice_bytes(K, A, D, T, True, itemsize)
                <= smem_limit]
        if fits:
            best = max(fits, key=lambda w: w * occupancy(w, True))
            if (stash == "smem" or best * occupancy(best, True)
                    >= WARPS[0] * occupancy(WARPS[0], False)):
                return Plan(best, True)
        elif stash == "smem":
            raise ValueError(f"one warp's carry history ({K=}, {T=}) does "
                             f"not fit {smem_limit} bytes of shared memory")
    return Plan(WARPS[0], False)


def grid(B: int, T: int, D: int, K: int, pl: Plan, sms: int, occupancy: int,
         itemsize: int = 4):
    """(blocks, scratch floats) of a persistent launch on ``sms`` SMs: as
    many blocks as the card keeps resident (``occupancy`` blocks per SM),
    no more than the tracks need, and no more than STASH_BUDGET of carry
    history in global scratch (one history per block, or per warp)."""
    per_block = max(1, pl.warps) * history_floats(T, D, K)
    nblk = min(-(-B // max(1, pl.warps)), sms * max(1, occupancy))
    if pl.stash_smem:
        return max(1, nblk), 0
    nblk = max(1, min(nblk, STASH_BUDGET // max(1, per_block * itemsize)))
    return nblk, nblk * per_block * itemsize // 4


def setup(lib, occupancy_fn, B: int, T: int, D: int, K: int, A: int, dev,
          itemsize: int, mapping=None, stash=None):
    """The plan and grid of one K2 (``occupancy_fn`` extrack_grad_occupancy)
    or K3 launch on ``dev``: (Plan, blocks, global scratch floats)."""
    def occ(warps, smem):
        n = occupancy_fn(D, K, A, T, warps, int(smem))
        if n < 0:
            cuda_lib.check(-n, "occupancy query")
        return n
    pl = plan(K, A, D, T, cuda_lib.smem_bytes("extrack_grad_smem", dev.index),
              occ, itemsize, mapping, stash)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nblk, scratch = grid(B, T, D, K, pl, sms, occ(pl.warps, pl.stash_smem),
                         itemsize)
    return pl, nblk, scratch


def launch(data, tabs, min_len: int, mapping: str | None = None,
           stash: str | None = None):
    """Launch K2 on the current stream.  Returns logL (B,), d(sum logL)/d l2
    (B, T, D) and the ten table cotangents, shaped like ``tabs``.
    ``mapping`` and ``stash`` force ``plan``'s choices (tests, tools)."""
    global LAUNCHES
    xs = data[0]
    B, T, D = xs.shape
    K, A = tabs[6].shape
    forward_kernel.validate(data, tabs, K, A)
    lib = cuda_lib.library()
    dev = xs.device
    pl, nblk, nscratch = setup(lib, lib.extrack_grad_occupancy, B, T, D, K,
                               A, dev, 4, mapping, stash)
    ncols = 6 * K + 4 * K * A
    logl = torch.empty(B, dtype=torch.float32, device=dev)
    ct_l2 = torch.zeros((B, T, D), dtype=torch.float32, device=dev)
    ct_tab = torch.empty(ncols, dtype=torch.float32, device=dev)
    scratch = torch.empty(max(1, nscratch), dtype=torch.float32, device=dev)
    partial = torch.empty(nblk * ncols, dtype=torch.float32, device=dev)
    rc = lib.extrack_grad(
        *(t.data_ptr() for t in (*data, *tabs, logl, ct_l2, ct_tab, scratch,
                                 partial)),
        B, T, D, K, A, int(min_len), nblk, pl.warps, int(pl.stash_smem),
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
