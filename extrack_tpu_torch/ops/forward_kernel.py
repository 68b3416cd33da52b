"""K1: the forward likelihood kernel (csrc/forward.cu) and its host side.

Replaces extrack_tpu/ops/pallas_engine.py:_kernel.  The host side builds
the per-slot tables the kernel reads (``build_slot_tables``,
``build_next_tables``), folds the per-step 2*pi normalizer constants into
the transition table, and lays the track data out as (B, T, D) float32.
With variable dt (per-track or per-step intervals) it also streams the
displacement-variance table, (B, T-1, P) float32 (``sig2_stream``), which
K1, K2, K3, K4 and K5 read in place of the s20, sig2v and s2n tables
(``stream_index`` says which entry each slot reads), and K7 in place of
its own (``topk_kernel.kernel_inputs``).

``forward`` is the entry point: CUDA tensors launch the kernel (or raise,
outside its envelope); CPU tensors run ``forward_plain``, which is
``core.engine.forward`` on the same inputs.  ``mapping_warps`` chooses
each kernel's mapping of a register onto the card (csrc/walk.cuh,
hist.cu, refine.cu; K2 and K3: grad.cuh, ``grad_kernel.plan``): one warp
per track up to 64 slots, a block per track with a thread a slot up to
1024 (K2, K3, K4, K5, K6) and a thread a fusion group past that (the wide
mapping: K1 above 64 slots, the others above 1024; up to 16384 slots for
K6, 65536 for K1, K2, K3 (at most 16384 fusion groups) and K4, and 2^19
for K5; K1's, K4's, K5's and
K6's carries go to global scratch where they pass a block's shared
memory, K2's and K3's exchange where a block's slice of it does (their
wide mapping walks a track with a cluster of blocks); K5 past 16384
slots harvests from each
slot's digits); ``plan`` and ``grid`` lay a K1 or K4 launch out as
persistent blocks.  ``MAX_SLOTS`` is each kernel's envelope.
``LAUNCHES`` counts kernel launches, ``PLAIN_CALLS`` calls of the plain
version.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from extrack_tpu_torch.core import engine
from extrack_tpu_torch.core.tables import LOG_FLOOR, ModelTables
from extrack_tpu_torch.ops import cuda_lib

LAUNCHES = 0
PLAIN_CALLS = 0
WARP_MAX_K = 64           # the warp mapping's largest register (2 per lane)
BLOCK_MAX_K = 1024        # the block mapping: one thread per register slot
WIDE_MAX_K = 4096         # the wide mapping: one thread per fusion group
SCRATCH_MAX_K = 16384     # K6's wide mapping, past shared memory with
                          # global scratch; K5's with the static segment
                          # tables
FIT_MAX_K = 65536         # K1's, K2's and K3's: the GUI's Model Fitting
                          # at 6 states (6^6 = 46,656) and 4^8
FIT_MAX_GROUPS = 16384    # and their fusion groups (K/A): K1 takes up to
                          # sixteen a thread of 1024, K2 and K3 up to two a
                          # thread of a cluster of sixteen such blocks
PREDICT_MAX_K = 65536     # K4's: the GUI's labeling window at 3 states
                          # (3^10 = 59049) and predict_Bs at 7 states
                          # (7^5) and 6 states (6^6) need more than 16384
HIST_MAX_K = 1 << 19      # K5's, harvesting from the slots' digits past
                          # 16384: len_hist's default window 7 at 5 and 6
                          # states (78,125, 279,936), window 8 at 5 states
HIST_MAX_BINS = 64        # S * frames: K5's (state, run length) bins a
                          # thread keeps past 16384 slots (kRunsMaxBins)
# each kernel's largest register: every kernel maps past 1024 slots
# (csrc/walk.cuh, grad.cuh, hist.cu, hist_wide.cu, refine.cu); K6 stops at
# 16384, K1, K2, K3 and K4 at 65536 and K5 at 2^19, each going on with its
# carries (K2, K3: the exchange of carry cotangents) in global scratch
MAX_SLOTS = {"K1": FIT_MAX_K, "K2": FIT_MAX_K, "K3": FIT_MAX_K,
             "K4": PREDICT_MAX_K, "K5": HIST_MAX_K, "K6": SCRATCH_MAX_K}
# the kernels that also stop at a count of fusion groups
MAX_GROUPS = {"K1": FIT_MAX_GROUPS, "K2": FIT_MAX_GROUPS,
              "K3": FIT_MAX_GROUPS}
# the mappings of K1, K4, K5 and K6, narrowest first.  K1 skips the block
# mapping: the wide one ran it 1.14-1.75x faster at every register of
# 81..1024 slots measured; K4, K5 and K6 keep a thread a slot up to 1024
# (K2 and K3, warp, block and wide: grad_kernel.plan)
MAPPINGS = {"K1": ("warp", "wide"), "K4": ("warp", "block", "wide"),
            "K5": ("block", "wide"), "K6": ("block", "wide")}
WARPS = (4, 2, 1)         # warps a block the warp mapping may launch
WIDE = -1                 # the C interface's warps of the wide mapping
WIDE_GLOBAL = -2          # K1's and K4's wide mapping with its carries in
                          # global scratch (csrc/walk.cuh
                          # forward_wide_global_kernel and
                          # walk_wide_global_kernel)
# the kernels that take the streamed displacement-variance table
STREAMED = ("K1", "K2", "K3", "K4", "K5")


class Plan(NamedTuple):
    """How one K1 / K4 launch maps tracks onto the card."""
    warps: int            # warps a block of the warp mapping; 0: block;
                          # WIDE: the wide mapping; WIDE_GLOBAL: the wide
                          # mapping, carries in global scratch
    stash_smem: bool      # K4's stash of fusion weights in shared memory


def mapping_warps(kernel: str, K: int, mapping: str | None = None) -> int:
    """The C interface's ``warps`` of ``kernel``'s mapping of a register
    of K slots: 1 the warp mapping (one warp), 0 the block mapping, WIDE
    the wide one.  The narrowest of MAPPINGS[kernel] that holds K, or
    ``mapping`` ("warp"/"block"/"wide") where it forces one (tests,
    tools); ValueError where that is not the kernel's or cannot hold K."""
    limit = {"warp": WARP_MAX_K, "block": BLOCK_MAX_K,
             "wide": MAX_SLOTS[kernel]}
    names = MAPPINGS[kernel]
    if mapping is None:
        mapping = next((m for m in names if K <= limit[m]), names[-1])
    if mapping not in names:
        raise ValueError(f"{kernel} has the mappings {names}, got "
                         f"{mapping!r}")
    if K > limit[mapping]:
        raise ValueError(f"the {mapping} mapping takes K <= "
                         f"{limit[mapping]}, got {K}")
    return {"warp": 1, "block": 0, "wide": WIDE}[mapping]


def plan(kernel: str, K: int, fixed: int, stash_bytes: int, smem_limit: int,
         occupancy, mapping: str | None = None,
         stash: str | None = None) -> Plan:
    """The mapping of a K1 (``stash_bytes`` 0) or K4 launch (``kernel``):
    ``mapping_warps``' (``mapping`` "warp"/"block"/"wide" forces one;
    the wide mapping takes any K up to MAX_SLOTS[kernel]).  ``fixed`` and
    ``stash_bytes`` are one team's (a warp's, or a block's for the block
    and wide mappings) shared bytes besides K4's stash of fusion weights
    and the stash's bytes; ``occupancy(warps, stash_smem)`` gives the
    blocks an SM keeps resident.  The stash goes to shared memory where a
    block's share fits ``smem_limit`` and, with the block size of WARPS
    that keeps the most tracks resident, as many tracks stay resident as
    with the stash in global scratch (``stash`` "smem"/"global" forces
    it).  A wide team whose ``fixed`` bytes pass ``smem_limit`` runs
    WIDE_GLOBAL: its carries (and K4's stash) in global scratch, at the
    bytes of its own layout."""
    w = mapping_warps(kernel, K, mapping)
    sizes = WARPS if w == 1 else (w,)
    if w == WIDE and fixed > smem_limit:
        if stash == "smem":
            raise ValueError(f"{kernel}'s wide team ({fixed} bytes besides "
                             f"its stash) does not fit {smem_limit} bytes "
                             "of shared memory")
        return Plan(WIDE_GLOBAL, False)
    if stash_bytes == 0:
        return Plan(sizes[0], False)

    def resident(w, smem):
        return max(w, 1) * occupancy(w, smem)

    if stash != "global":
        fits = [w for w in sizes
                if max(w, 1) * (fixed + stash_bytes) <= smem_limit]
        if fits:
            best = max(fits, key=lambda w: resident(w, True))
            if stash == "smem" or (resident(best, True)
                                   >= resident(sizes[0], False)):
                return Plan(best, True)
        elif stash == "smem":
            raise ValueError(f"one team's stash ({stash_bytes} bytes) does "
                             f"not fit {smem_limit} bytes of shared memory")
    return Plan(sizes[0], False)


def grid(B: int, pl: Plan, sms: int, occupancy: int, stash_bytes: int = 0,
         budget: int | None = None):
    """(blocks, bytes of global scratch) of a persistent launch on ``sms``
    SMs: as many blocks as the card keeps resident (``occupancy`` an SM),
    no more than the tracks need, and no more than ``budget`` bytes (None:
    cuda_lib.SCRATCH_BUDGET; the wrappers pass ``cuda_lib.scratch_budget``,
    which the card's free memory bounds too) of global scratch
    (``stash_bytes`` a team: K4's stash, and at WIDE_GLOBAL K1's or K4's
    carries).  Raises RuntimeError where one team's scratch alone passes
    the budget."""
    team = max(1, pl.warps)
    nblk = max(1, min(-(-B // team), sms * max(1, occupancy)))
    if pl.stash_smem or stash_bytes == 0:
        return nblk, 0
    budget = cuda_lib.SCRATCH_BUDGET if budget is None else budget
    if team * stash_bytes > budget:
        raise RuntimeError(
            f"one team's global scratch ({team * stash_bytes} bytes: the "
            f"carries and stash of its tracks' longest length) passes the "
            f"{budget} bytes the card can give it; split the longest "
            "tracks' bucket or free device memory")
    nblk = max(1, min(nblk, budget // (team * stash_bytes)))
    return nblk, nblk * team * stash_bytes


@functools.cache
def layout(T: int, D: int, K: int, A: int, warps: int, P: int = 0):
    """(shared bytes of one team, its global scratch bytes) of a K1
    launch (``P`` > 0: variable dt), as the kernel's source defines its
    team (``extrack_forward_layout``; ``warps`` a warp of the warp
    mapping, WIDE a block of the wide one, WIDE_GLOBAL the wide one with
    its publish areas in global scratch)."""
    out = (ctypes.c_longlong * 3)()
    cuda_lib.check(cuda_lib.library().extrack_forward_layout(
        T, D, K, A, warps, P, ctypes.addressof(out)), "K1 layout")
    return out[1], out[2]


@functools.cache
def _occupancy(query: str, *args) -> int:
    """Blocks an SM keeps resident, from a kernel's occupancy query."""
    n = getattr(cuda_lib.library(), query)(*args)
    if n < 0:
        cuda_lib.check(-n, f"{query} (occupancy query)")
    return n


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _dig(k, i, S, W):
    """i-th newest window digit of slot k (digit 0 = newest)."""
    return (k // S ** (W - 1 - i)) % S


def stream_index(S: int, W: int, n: int):
    """Where the kernels read the streamed displacement variances: (pat
    (K,), nxt (K, A)) column indices into a step's row of P = S^(n+1)
    patterns.  Slot k's initial register and a fusion's child k read
    pattern k // S^(W-n-1) (its n+1 newest digits); the look-ahead child
    of slot k under new sub-state pattern a reads a*S + (k's newest
    digit)."""
    K, A = S ** W, S ** n
    k = np.arange(K)
    pat = k // S ** (W - n - 1)
    nxt = np.arange(A)[None, :] * S + (k // S ** (W - 1))[:, None]
    return pat, nxt


def sig2_stream(sig2: torch.Tensor, B: int, T: int,
                dtype=torch.float32) -> torch.Tensor:
    """The kernels' streamed displacement-variance table: (B, T-1, P)
    float32, contiguous, row t of track b holding step t -> t+1, from a
    per-step (T-1, P), per-track (B, T-1, P) or constant (1, P) table
    (a per-track T=2 table is (B, 1, P)).  Differentiable w.r.t.
    ``sig2``: a shared table is expanded over the tracks (and a one-row
    table over the steps).  The JAX package's counterpart is
    ``pallas_engine._sig2_stream``, which also moves the tracks onto the
    TPU's lanes.  ``dtype``: as ``kernel_inputs``'."""
    s = sig2.to(dtype)
    if s.ndim == 2:
        s = s[None]
    return s.expand(B, T - 1, s.shape[-1]).contiguous()


def build_slot_tables(tables: ModelTables, window: int, nb_substeps: int):
    """(lp0, s20, lt, lsurv, end, sig2v) as (K,) tensors in the engine's
    slot encoding (newest digit highest).  ``lt``, ``lsurv`` and ``sig2v``
    describe the child a slot becomes after a fusion step; ``s20`` and
    ``sig2v`` are the same tensor.  Log tables are re-floored at -1e15 so
    hand-built tables with -inf entries stay finite."""
    S = tables.nb_states
    W, n = window, nb_substeps
    if W < n + 1:
        raise ValueError(f"window ({W}) must be >= nb_substeps+1 ({n + 1})")
    K = S ** W
    k = np.arange(K)
    log_T = tables.log_trans.clamp_min(LOG_FLOOR)
    # transition chain of the n newest digits: digit n -> ... -> digit 0
    lt = sum(log_T[_dig(k, j + 1, S, W), _dig(k, j, S, W)] for j in range(n))
    lsurv = tables.log_survive.clamp_min(LOG_FLOOR)[k // S ** (W - n)]
    end = tables.end_ll.clamp_min(LOG_FLOOR)[_dig(k, 0, S, W)]
    sig2_row = tables.sig2.reshape(-1, tables.sig2.shape[-1])[0]
    sig2 = sig2_row[stream_index(S, W, n)[0]]         # n+1 newest digits
    lp0 = tables.log_frac.clamp_min(LOG_FLOOR)[_dig(k, n, S, W)]
    for j in range(n):
        lp0 = lp0 + log_T[_dig(k, j + 1, S, W), _dig(k, j, S, W)]
    lp0 = lp0 - (W - n - 1) * math.log(S)
    return lp0, sig2, lt, lsurv, end, sig2


def build_next_tables(tables: ModelTables, window: int, nb_substeps: int):
    """(ltn, s2n, lsn, endn) as (K, A) tensors for the look-ahead closing:
    column a describes the pre-fusion child of slot k under new sub-state
    pattern a (chain transitions, displacement variance, survival, folded
    end term)."""
    S = tables.nb_states
    W, n = window, nb_substeps
    K, A = S ** W, S ** n
    k = np.arange(K)[:, None]
    a = np.arange(A)[None, :]
    newest_k = k // S ** (W - 1)

    def dig_a(i):
        return (a // S ** (n - 1 - i)) % S

    log_T = tables.log_trans.clamp_min(LOG_FLOOR)
    ltn = log_T[newest_k, dig_a(n - 1)]
    for j in range(n - 1):
        ltn = ltn + log_T[dig_a(j + 1), dig_a(j)]
    ltn = ltn.expand(K, A)
    sig2_row = tables.sig2.reshape(-1, tables.sig2.shape[-1])[0]
    s2n = sig2_row[stream_index(S, W, n)[1]]
    lsn = tables.log_survive.clamp_min(LOG_FLOOR)[None, :].expand(K, A)
    endn = tables.end_ll.clamp_min(LOG_FLOOR)[a // S ** (n - 1)].expand(K, A)
    return ltn, s2n, lsn, endn


def classify_sig2(sig2: torch.Tensor, T: int) -> bool:
    """True when the displacement-variance table varies per step or per
    track (variable dt).  Classified by the batch dimension too: a per-track
    (B, 1, P) table at T=2 has one step row yet differs across tracks.
    Also validates the step-row count."""
    batch = sig2.shape[0] if sig2.ndim == 3 else 1
    step_rows = sig2.reshape(-1, sig2.shape[-1]).shape[0] // batch
    if step_rows not in (1, T - 1):
        raise NotImplementedError(
            f"per-step sig2 must have T-1={T - 1} rows, got {step_rows}")
    return step_rows != 1 or batch != 1


def kernel_dtype(positions, tables: ModelTables) -> torch.dtype:
    """float32 when the positions and every table are float32; otherwise
    the first other dtype among them."""
    return next((t.dtype for t in (positions, *tables)
                 if t.dtype != torch.float32), torch.float32)


def check_envelope(T: int, D: int, S: int, window: int, nb_substeps: int,
                   variable_dt: bool = False, dtype=torch.float32,
                   what: str = "batch", kernel: str = "K1"):
    """Raise NotImplementedError, naming ``what``, when ``kernel`` ("K1"
    .. "K6") cannot run this configuration: past its register of
    ``MAX_SLOTS[kernel]`` slots or (K1, K2, K3) ``MAX_GROUPS[kernel]``
    fusion groups (naming that limit and the largest window that fits),
    in another dtype than float32 or D outside 1..3.  Variable
    dt is in the envelope of the kernels in STREAMED only (K6 reads no dt
    table; K7 checks its own envelope, ``topk_kernel.check_envelope``,
    and reads the stream too)."""
    K, A = S ** window, S ** nb_substeps
    reasons = []
    if dtype != torch.float32:
        reasons.append(f"dtype {dtype} (the kernels compute in float32: "
                       "pass float32 tensors)")
    if D not in (1, 2, 3):
        reasons.append(f"D={D} (kernels take 1..3 dimensions)")
    limit = MAX_SLOTS[kernel]
    groups = MAX_GROUPS.get(kernel, K)
    fits = max((w for w in range(1, window)
                if S ** w <= limit and S ** w // A <= groups), default=0)
    if K > limit:
        how = ("a thread per fusion group past 1024 slots"
               + (", the carries in global scratch past shared memory"
                  if limit > WIDE_MAX_K else "")
               + (", the harvest from the slots' digits past 16384"
                  if limit > PREDICT_MAX_K else ""))
        reasons.append(f"K=S**window={K} > {limit} register slots "
                       f"({kernel} maps at most {limit}, {how}; the "
                       f"largest window that fits is {fits})")
    elif K // A > groups:
        reasons.append(f"K/A={K // A} > {groups} fusion groups ({kernel} "
                       f"maps at most {groups}, up to "
                       f"{groups // 1024} a thread of 1024; the largest "
                       f"window that fits is {fits})")
    if window < nb_substeps + 1:
        reasons.append(f"window {window} < nb_substeps+1")
    elif (kernel == "K5" and SCRATCH_MAX_K < K <= limit
          and S * ((window - 1) // nb_substeps + 1) > HIST_MAX_BINS):
        reasons.append(f"{S} states x {(window - 1) // nb_substeps + 1} "
                       f"frames > {HIST_MAX_BINS} (state, run length) bins "
                       "(K5's harvest past 16384 slots keeps them a "
                       "thread)")
    if variable_dt and kernel not in STREAMED:
        reasons.append(f"per-step / per-track dt ({kernel} takes constant "
                       "dt only: it does not read the streamed "
                       "displacement-variance table; device='cpu' runs "
                       "the plain version, which takes variable dt)")
    if reasons:
        raise NotImplementedError(
            f"{what} (T={T}, D={D}, S={S}, window={window}, "
            f"nb_substeps={nb_substeps}) is outside the CUDA kernels' "
            "envelope: " + "; ".join(reasons))


def kernel_inputs(positions, lengths, is_bleached, tables: ModelTables,
                  window: int, nb_substeps: int, dtype=torch.float32):
    """Kernel arguments: (xs, l2, lengths, isbl) as contiguous (B, T, D) /
    (B,) tensors, and the ten table tensors in ``dtype`` (the kernels'
    float32; float64 for a model of a kernel) (lp0, s20, lt, lsurv,
    end, sig2v, ltn, s2n, lsn, endn), differentiable w.r.t. ``tables``;
    with variable dt (``classify_sig2``) an eleventh, the streamed
    displacement variances (``sig2_stream``), which the kernels read in
    place of s20, sig2v and s2n (built from the first row, unread).
    The kernels drop the per-step 2*pi constants of the Gaussian
    normalizers; every fusion adds lt, so the constant folds into lt
    (exact, and lt's cotangent is unchanged)."""
    B, T, D = positions.shape
    f32 = dtype
    lp0, sig2v, lt, lsurv, end, _ = (
        v.to(f32) for v in build_slot_tables(tables, window, nb_substeps))
    lt = lt - 0.5 * D * math.log(2 * math.pi)
    nxt = [v.to(f32).contiguous()
           for v in build_next_tables(tables, window, nb_substeps)]
    xs = positions.to(f32).contiguous()
    l2 = tables.loc_err2.to(f32).expand(B, T, D).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    isbl = is_bleached.to(f32).contiguous()
    sig2v = sig2v.contiguous()
    # s20 and sig2v are one table passed twice: autograd sums both
    # cotangents into it
    tabs = [lp0.contiguous(), sig2v, lt.contiguous(), lsurv.contiguous(),
            end.contiguous(), sig2v] + nxt
    if T >= 2 and classify_sig2(tables.sig2, T):
        tabs.append(sig2_stream(tables.sig2, B, T, dtype))
    return (xs, l2, lens, isbl), tabs


def stream_patterns(tabs) -> int:
    """P of the streamed displacement variances among a kernel's tables
    (the eleventh, variable dt), else 0 (constant dt)."""
    return tabs[10].shape[-1] if len(tabs) > 10 else 0


def validate(data, tabs, K: int, A: int):
    """Device, dtype, shape and contiguity checks before handing raw
    pointers to a kernel; a stream (variable dt) must be (B, T-1, P) with
    P a multiple of A dividing K."""
    xs, l2, lens, isbl = data
    B, T, D = xs.shape
    want = [(xs, (B, T, D), torch.float32), (l2, (B, T, D), torch.float32),
            (lens, (B,), torch.int32), (isbl, (B,), torch.float32)]
    want += [(t, (K,), torch.float32) for t in tabs[:6]]
    want += [(t, (K, A), torch.float32) for t in tabs[6:10]]
    P = stream_patterns(tabs)
    if P:
        if len(tabs) != 11 or T < 2 or P % A or K % P:
            raise ValueError(f"a stream of {P} patterns does not fit K={K}, "
                             f"A={A}, T={T}")
        want.append((tabs[10], (B, T - 1, P), torch.float32))
    cuda_lib.check_args(want, xs.device)


def launch(data, tabs, min_len: int,
           mapping: str | None = None) -> torch.Tensor:
    """Launch K1 on the current stream; returns logL (B,) float32.
    ``mapping`` ("warp"/"block"/"wide") forces ``plan``'s choice (tests,
    tools)."""
    global LAUNCHES
    xs = data[0]
    B, T, D = xs.shape
    K, A = tabs[6].shape
    validate(data, tabs, K, A)
    P = stream_patterns(tabs)
    lib = cuda_lib.library()
    dev = xs.device
    w = mapping_warps("K1", K, mapping)
    fixed = layout(T, D, K, A, w, P)[0] if w == WIDE else 0
    pl = plan("K1", K, fixed, 0,
              cuda_lib.smem_bytes("extrack_predict_smem", dev.index), None,
              mapping)
    # WIDE_GLOBAL: the publish areas in each block's global scratch
    team = layout(T, D, K, A, pl.warps, P)[1] if pl.warps == WIDE_GLOBAL \
        else 0
    nblk, nbytes = grid(B, pl, _sms(dev.index), _occupancy(
        "extrack_forward_occupancy", D, K, A, T, pl.warps, P), team,
        cuda_lib.scratch_budget(dev, K) if team else None)
    logl = torch.empty(B, dtype=torch.float32, device=dev)
    scratch = (torch.empty(nbytes // 4, dtype=torch.float32, device=dev)
               if nbytes else None)
    rc = lib.extrack_forward(
        *(t.data_ptr() for t in (*data, *tabs[:10])),
        *(None if t is None else t.data_ptr()
          for t in (tabs[10] if P else None, logl, scratch)),
        B, T, D, K, A, P, int(min_len), nblk, pl.warps,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(rc, "forward")
    LAUNCHES += 1
    return logl


def forward_plain(positions, lengths, is_bleached, tables: ModelTables, *,
                  window: int = 6, nb_substeps: int = 1,
                  min_len: int = 3) -> torch.Tensor:
    """The plain version of K1: ``core.engine.forward``."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    return engine.forward(positions, lengths, is_bleached, tables,
                          window=window, nb_substeps=nb_substeps,
                          min_len=min_len)


def forward(positions, lengths, is_bleached, tables: ModelTables, *,
            window: int = 6, nb_substeps: int = 1,
            min_len: int = 3) -> torch.Tensor:
    """Per-track log likelihood (B,).  CUDA inputs run K1 (float32 only,
    constant or variable dt; anything outside its envelope raises); CPU
    inputs run the plain version."""
    if positions.device.type == "cpu":
        return forward_plain(positions, lengths, is_bleached, tables,
                             window=window, nb_substeps=nb_substeps,
                             min_len=min_len)
    B, T, D = positions.shape
    check_envelope(T, D, tables.nb_states, window, nb_substeps,
                   classify_sig2(tables.sig2, T),
                   kernel_dtype(positions, tables))
    data, tabs = kernel_inputs(positions, lengths, is_bleached, tables,
                               window, nb_substeps)
    return launch(data, [t.detach() for t in tabs], min_len)
