"""K2: the likelihood-gradient kernel (csrc/grad.cu) as a
``torch.autograd.Function``.

Replaces extrack_tpu/ops/pallas_grad.py:_grad_kernel and the custom-VJP
trio around it.  ``neg_log_likelihood`` returns -sum logL, differentiable
w.r.t. the model tables (hence the physical parameters upstream) and the
localization-error variances:

* CUDA tensors (float32 only), gradient wanted: one K2 launch computes the value and every
  table cotangent; ``backward`` only scales them.  ``plan`` picks one of
  K2's three mappings: one warp per track for K <= 64 (its carry history
  in shared memory when it fits), one block per track with a thread a
  slot up to 1024 slots, and a cluster of 1 to 16 blocks per track with a
  thread one or two fusion groups (the wide mapping) up to 65536 slots
  and 16384 groups, its exchange of carry cotangents split over the
  cluster's shared memory where a block's slice fits
  (``cluster_size``), else in global scratch.  The persistent grid
  takes no more global scratch (history, exchange, partial rows) than
  the card's free memory allows, up to ``cuda_lib.scratch_budget(dev,
  K)``'s cap: past 16384 slots a cluster takes tens of MB, and the common
  cap would leave most SMs idle.
  With variable dt the
  kernel reads the streamed displacement variances (``kernel_inputs``'
  eleventh tensor) and returns their cotangent, which autograd carries
  through the stream's expand and ``tables.build_tables`` to the
  parameters.
* CUDA tensors, no gradient wanted (``torch.no_grad`` or no input requires
  grad): the cheaper forward kernel K1, whose envelope (65536 slots,
  16384 fusion groups) is K2's.
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
WARP_MAX_K = 64           # the warp mapping's largest register (2 per lane)
# the block mapping's largest register (a thread a slot); 0 moves every
# register past WARP_MAX_K to the wide mapping (tests, chip_smoke.py)
BLOCK_MAX_K = forward_kernel.BLOCK_MAX_K
WARPS = (4, 2, 1)         # warps per block the warp mapping may launch
WIDE = -1                 # the C interface's warps of the wide mapping
WIDE_GLOBAL = -2          # the wide mapping, its exchange in global scratch
WIDE_THREADS = 1024       # csrc/grad.cuh kGradWideThreads
WIDE_GROUPS = 2           # fusion groups a thread owns, at most
RED_SCALARS = 64          # a block's reductions' shared scratch
CLUSTER_SIZES = (1, 2, 4, 8, 16)   # blocks a cluster (kGradClusterMax 16;
                                   # past 8 a size is not portable)


class Plan(NamedTuple):
    """How one K2 / K3 launch maps tracks onto the card."""
    warps: int            # warps per block of the warp mapping; 0: block;
                          # WIDE / WIDE_GLOBAL: the wide mapping
    stash_smem: bool      # the warp mapping's carry history in shared memory
    cluster: int = 1      # blocks a cluster (the wide mapping)


class WideLayout(NamedTuple):
    """One block of the wide mapping (csrc/grad.cuh grad_wide_layout)."""
    threads: int
    smem: int             # dynamic shared bytes
    scratch: int          # global scratch bytes: history, exchange if global


def history_floats(T: int, D: int, K: int) -> int:
    """Scalars of one track's carry history: (T-1)(2D+1)K."""
    return max(T - 1, 0) * (2 * D + 1) * K


def warp_slice_bytes(K: int, A: int, D: int, T: int, stash_smem: bool,
                     itemsize: int = 4, P: int = 0) -> int:
    """Shared memory of one warp of the warp mapping (grad.cuh's
    warp_slice): the publish area, the cotangent accumulators of the (K,)
    and (K, A) tables, two buffers of a track's positions, variances,
    (T-1, P) displacement variances (variable dt, ``P`` > 0), length and
    flag and, when ``stash_smem``, the carry history."""
    return itemsize * ((9 + 4 * D) * K + 4 * K * A + 4 * T * D
                       + 2 * max(T - 1, 0) * P + 4
                       + (history_floats(T, D, K) if stash_smem else 0))


def wide_history_floats(K: int, A: int, D: int, T: int) -> int:
    """Scalars of one track's history on the wide mapping: the fused
    groups of steps 1 .. T-3, (T-3)(2D+1)K/A."""
    return max(T - 3, 0) * (2 * D + 1) * (K // A)


def wide_layout(K: int, A: int, D: int, T: int, C: int,
                exchange_global: bool, itemsize: int = 4) -> WideLayout:
    """The host twin of csrc/grad.cuh's grad_wide_layout: one block of a
    cluster of ``C`` that walks a track, rank r owning the Gc = ceil(G/C)
    fusion groups from r*Gc, a thread up to two of them (at most
    WIDE_THREADS threads); shared memory holds the block reductions'
    scratch and, unless ``exchange_global``, the rank's slice of the
    exchange, its members' (2D+1)*Gc*A carry cotangents; the cluster's
    global scratch (``scratch``) holds the history
    (``wide_history_floats``) and, with ``exchange_global``, the C
    slices."""
    Gc = -(-(K // A) // C)
    xch = (2 * D + 1) * Gc * A
    return WideLayout(min(WIDE_THREADS, -(-Gc // 32) * 32),
                      (RED_SCALARS + (0 if exchange_global else xch))
                      * itemsize,
                      (wide_history_floats(K, A, D, T)
                       + (C * xch if exchange_global else 0)) * itemsize)


def cluster_size(K: int, A: int, D: int, T: int, smem_limit: int,
                 itemsize: int = 4) -> tuple[int, bool]:
    """The wide mapping's blocks a cluster and whether its exchange sits
    in global scratch: the smallest of CLUSTER_SIZES at which a thread
    owns at most WIDE_GROUPS groups and a block's slice of the exchange
    fits ``smem_limit``; where none fits, the smallest at which the
    groups do, with the exchange in global scratch."""
    G = K // A
    sizes = [C for C in CLUSTER_SIZES
             if -(-G // C) <= WIDE_GROUPS * WIDE_THREADS]
    if not sizes:
        raise ValueError(f"{G} fusion groups pass {CLUSTER_SIZES[-1]} "
                         f"blocks of {WIDE_THREADS} threads")
    for C in sizes:
        if wide_layout(K, A, D, T, C, False, itemsize).smem <= smem_limit:
            return C, False
    return sizes[0], True


def plan(K: int, A: int, D: int, T: int, smem_limit: int, occupancy,
         itemsize: int = 4, mapping: str | None = None,
         stash: str | None = None, P: int = 0,
         cluster: int | None = None) -> Plan:
    """K2's mapping for one launch: the warp mapping for K <= WARP_MAX_K,
    the block mapping up to BLOCK_MAX_K, the wide mapping above, up to
    ``forward_kernel.MAX_SLOTS["K2"]`` slots and ``MAX_GROUPS["K2"]``
    fusion groups (``mapping`` "warp"/"block"/"wide" forces one).  The
    wide mapping takes ``cluster_size``'s blocks a cluster (``cluster``
    forces it) and keeps its exchange in shared memory where a block's
    slice fits ``smem_limit`` (Plan WIDE), else in global scratch
    (WIDE_GLOBAL; ``stash`` "smem"/"global" forces where).  The warp
    mapping keeps the carry history in shared memory where it fits:
    where one warp's slice with it fits ``smem_limit`` (the opt-in limit a
    block may ask for) and, with the warps per block of WARPS that keep the
    most warps resident on an SM (``occupancy(warps, stash_smem)`` gives
    the blocks), as many warps stay resident as with the history in global
    scratch; else in global scratch, 4 warps per block (``stash``
    "smem"/"global" forces where).  ``P`` > 0: variable dt, whose
    streamed rows take a warp's slice too."""
    mapping = mapping or ("warp" if K <= WARP_MAX_K else "block"
                          if K <= BLOCK_MAX_K else "wide")
    if mapping == "wide":
        limit = forward_kernel.MAX_SLOTS["K2"]
        groups = forward_kernel.MAX_GROUPS["K2"]
        if K > limit or K // A > groups:
            raise ValueError(f"the wide mapping takes K <= {limit} and at "
                             f"most {groups} fusion groups, got K={K}, "
                             f"A={A}")
        if cluster is None:
            C, glob = cluster_size(K, A, D, T, smem_limit, itemsize)
        elif cluster in CLUSTER_SIZES and (
                -(-(K // A) // cluster) <= WIDE_GROUPS * WIDE_THREADS):
            C = cluster
            glob = wide_layout(K, A, D, T, C, False,
                               itemsize).smem > smem_limit
        else:
            raise ValueError(f"{cluster} blocks a cluster do not take "
                             f"{K // A} fusion groups")
        if stash == "smem" and glob:
            raise ValueError(f"the wide mapping's exchange ({K=}, {D=}, "
                             f"{C} blocks a cluster) does not fit "
                             f"{smem_limit} bytes of shared memory")
        return Plan(WIDE_GLOBAL if glob or stash == "global" else WIDE,
                    False, C)
    if mapping == "block":
        if K > forward_kernel.BLOCK_MAX_K:
            raise ValueError(f"the block mapping takes K <= "
                             f"{forward_kernel.BLOCK_MAX_K}, got {K}")
        if stash == "smem":
            raise ValueError("the block mapping keeps its carry history in "
                             "global scratch")
        return Plan(0, False)
    if K > WARP_MAX_K:
        raise ValueError(f"the warp mapping takes K <= {WARP_MAX_K}, got {K}")
    if stash != "global":
        fits = [w for w in WARPS
                if w * warp_slice_bytes(K, A, D, T, True, itemsize, P)
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


def partial_bytes(K: int, A: int, itemsize: int = 4) -> int:
    """Bytes of one block's row of table-cotangent partials, 6K + 4KA
    scalars."""
    return (6 * K + 4 * K * A) * itemsize


def grid(B: int, T: int, D: int, K: int, pl: Plan, sms: int, occupancy: int,
         itemsize: int = 4, A: int = 0, budget: int | None = None):
    """(blocks, scratch floats) of a persistent launch on ``sms`` SMs: as
    many blocks as the card keeps resident (``occupancy`` blocks per SM;
    the wide mapping: clusters of ``pl.cluster`` blocks on the card), no
    more than the tracks need, and no more than ``budget`` bytes (None:
    cuda_lib.SCRATCH_BUDGET; ``setup`` passes ``cuda_lib.scratch_budget``,
    which the card's free memory bounds too) of the buffers a block (a
    cluster) takes in global memory: its row of partials
    (``partial_bytes``) and its global scratch (the carry history of the
    block, or of each warp; the wide mapping's ``wide_layout`` scratch:
    history and, at WIDE_GLOBAL, the exchange).  Raises RuntimeError,
    naming the bytes, where one block (cluster) alone passes the
    budget."""
    budget = cuda_lib.SCRATCH_BUDGET if budget is None else budget
    if pl.warps < 0:
        scratch = wide_layout(K, A, D, T, pl.cluster,
                              pl.warps == WIDE_GLOBAL, itemsize).scratch
        nblk = min(B, max(1, occupancy))
    else:
        scratch = (0 if pl.stash_smem else
                   max(1, pl.warps) * history_floats(T, D, K) * itemsize)
        nblk = min(-(-B // max(1, pl.warps)), sms * max(1, occupancy))
    per_block = scratch + partial_bytes(K, A, itemsize)
    if per_block > budget:
        raise RuntimeError(
            f"one block's global memory ({per_block} bytes: {scratch} of "
            f"scratch, {per_block - scratch} of partials, for tracks of "
            f"{T} frames at K={K}, D={D}) passes the {budget} bytes the "
            "card can give it; split the longest tracks' bucket or free "
            "device memory")
    nblk = max(1, min(nblk, budget // per_block))
    return nblk * pl.cluster, nblk * scratch // 4


def setup(lib, kernel: str, B: int, T: int, D: int, K: int, A: int, dev,
          itemsize: int, mapping=None, stash=None, P: int = 0,
          cluster: int | None = None):
    """The plan and grid of one K2 (``kernel`` "grad") or K3 ("hvp")
    launch on ``dev`` (``P`` > 0: variable dt): (Plan, blocks, global
    scratch floats); the grid's budget is ``cuda_lib.scratch_budget(dev,
    K)``, and a block (a cluster) that alone passes it raises, naming the
    batch's shape, as does a plan the card cannot keep one block (cluster)
    of resident."""
    def occ(warps, arg):
        # the warp and block mappings: blocks an SM (arg: stash_smem); the
        # wide mapping: clusters of ``arg`` blocks on the card
        query = "cluster_occupancy" if warps < 0 else "occupancy"
        n = getattr(lib, f"extrack_{kernel}_{query}")(D, K, A, T, warps,
                                                      int(arg), P)
        if n < 0:
            cuda_lib.check(-n, "occupancy query")
        return n
    pl = plan(K, A, D, T, cuda_lib.smem_bytes("extrack_grad_smem", dev.index),
              occ, itemsize, mapping, stash, P, cluster)
    resident = occ(pl.warps, pl.cluster if pl.warps < 0 else pl.stash_smem)
    if resident == 0:
        raise RuntimeError(
            f"the card keeps no block of K2's plan {pl} resident (K={K}, "
            f"A={A}, D={D}, T={T}, {itemsize}-byte scalars)")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    try:
        nblk, scratch = grid(B, T, D, K, pl, sms, resident, itemsize, A,
                             cuda_lib.scratch_budget(dev, K))
    except RuntimeError as e:
        raise RuntimeError(f"the batch of {B} tracks of {T} frames "
                           f"(D={D}, K={K}, A={A}): {e}") from None
    return pl, nblk, scratch


def launch(data, tabs, min_len: int, mapping: str | None = None,
           stash: str | None = None, cluster: int | None = None):
    """Launch K2 on the current stream.  Returns logL (B,), d(sum logL)/d l2
    (B, T, D) and the table cotangents, shaped like ``tabs`` (with
    variable dt the stream's last, its rows past each track's length 0).
    ``mapping``, ``stash`` and ``cluster`` force ``plan``'s choices (tests,
    tools)."""
    global LAUNCHES
    xs = data[0]
    B, T, D = xs.shape
    K, A = tabs[6].shape
    forward_kernel.validate(data, tabs, K, A)
    P = forward_kernel.stream_patterns(tabs)
    lib = cuda_lib.library()
    dev = xs.device
    pl, nblk, nscratch = setup(lib, "grad", B, T, D, K, A, dev, 4, mapping,
                               stash, P, cluster)
    ncols = 6 * K + 4 * K * A
    logl = torch.empty(B, dtype=torch.float32, device=dev)
    ct_l2 = torch.zeros((B, T, D), dtype=torch.float32, device=dev)
    ct_tab = torch.empty(ncols, dtype=torch.float32, device=dev)
    ct_s2 = torch.zeros_like(tabs[10]) if P else None
    scratch = torch.empty(max(1, nscratch), dtype=torch.float32, device=dev)
    partial = torch.empty(nblk // pl.cluster * ncols, dtype=torch.float32,
                          device=dev)
    rc = lib.extrack_grad(
        *(t.data_ptr() for t in (*data, *tabs[:10])),
        *(None if t is None else t.data_ptr()
          for t in (tabs[10] if P else None, logl, ct_l2, ct_tab, ct_s2,
                    scratch, partial)),
        B, T, D, K, A, P, int(min_len), nblk, pl.warps, int(pl.stash_smem),
        pl.cluster, torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(rc, "gradient")
    LAUNCHES += 1
    vecs = ct_tab[:6 * K].view(6, K).unbind(0)
    mats = ct_tab[6 * K:].view(4, K, A).unbind(0)
    return logl, ct_l2, list(vecs) + list(mats) + ([ct_s2] if P else [])


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
    """-sum logL of a batch; see the module docstring for the paths.  On
    the card a call that takes a gradient needs K2's envelope, a value
    alone K1's."""
    if positions.device.type == "cpu":
        return neg_log_likelihood_plain(positions, lengths, is_bleached,
                                        tables, window=window,
                                        nb_substeps=nb_substeps,
                                        min_len=min_len)
    B, T, D = positions.shape
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in tables)
    forward_kernel.check_envelope(
        T, D, tables.nb_states, window, nb_substeps,
        forward_kernel.classify_sig2(tables.sig2, T),
        forward_kernel.kernel_dtype(positions, tables),
        kernel="K2" if grad else "K1")
    (xs, l2, lens, isbl), tabs = forward_kernel.kernel_inputs(
        positions, lengths, is_bleached, tables, window, nb_substeps)
    if grad:
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
