#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # every phase, one card

Phases (each prints its lines; a failed check exits non-zero):

0. toolchain: torch / CUDA versions, nvcc, the card's name and power limit,
   the kernel build time (one nvcc per source, in parallel) and nvcc's
   register / spill report;
1. K1 (csrc/forward.cu) against its plain version ``forward_plain`` in f32
   on the card, three register configurations, ~3000 tracks each;
2. K2 (csrc/grad.cu): value and every table gradient against
   ``value_and_table_grads_plain`` (torch autograd of the engine), at the
   same configurations, then on both of its mappings (the warp mapping
   at K = 8, 16, 32, 64 and the block mapping at the same K and at
   K = 243);
3. the fit main path on 10^5 simulated tracks: first the kernels against
   the plain version at the fit's own bucket shapes (each table cotangent
   per bucket, then the objective's value and each z-gradient component);
   then ``fit.param_fitting(compute_errors=True)`` (2 states, window 6,
   4 length buckets) with the K2 and K3 launch counts over it, and one
   value-only objective call (K1);
4. times at the fit benchmark shape (2 states, T=10, W=6, D=2, 2^20 tracks,
   lengths 3..10, length-bucketed, f32): K1 and K2 launched on prepared
   inputs and through their wrappers, against their plain versions,
   CUDA events, median of several reps after warm-up; K2 also on its
   block mapping and with its carry history in global scratch, for
   reading;
5. K3 (csrc/hvp.cu): every Hessian column of ``hessian_hvp_columns``
   against the same assembly on the plain double backward, at four
   register configurations with a forbidden transition; then the main
   path's Hessian and standard errors against ``hessian_chunked`` (plain
   second-order autograd) at the fitted parameters; K3's time for one
   tangent direction over the 2^20 bench tracks, launched on prepared
   inputs and through ``table_hvp``, and on the block mapping for reading;
6. K4 (csrc/predict.cu): logL and posteriors against ``predict_plain`` at
   five configurations (T=2 rows, 0/1-frame rows, per-peak LocErr, a
   history in global scratch); then the annotation main path,
   ``predict.predict_Bs`` on the 10^5 tracks with the fitted parameters,
   with its K4 launch count, each bucket against the plain version, and
   the share of frames whose most probable state is the simulated one;
   K4's time at 2^20 tracks (T=10, W=5, S=2), launched on prepared inputs
   and through ``predict_kernel.predict``;
7. K5 (csrc/hist.cu): the histogram against ``hist_plain`` at seven
   configurations with a forbidden transition (3 states, per-peak LocErr,
   T=2 and 0/1-frame rows, D = 1 and 3, rows in global scratch), twice
   for repeatability; then the histogram main path,
   ``histograms.len_hist`` on the 10^5 tracks with the fitted parameters
   (window 7, 4 length buckets), with its K5 launch count, each bucket
   against the plain version, frame conservation, and the simulated
   states' histogram beside it; K5's time at 2^20 tracks (T=10, W=7,
   S=2), launched on prepared inputs and through ``hist_kernel.hist``;
8. K6 (csrc/refine.cu): refined positions against ``refine_plain`` at
   eight configurations with a zero in the transition matrix (odd K,
   4 states, per-peak LocErr, T=2 and 0/1-frame rows, D = 1 and 3, a
   stash in global scratch); then the refinement main path,
   ``refine.position_refinement`` on the 10^5 tracks with the fitted
   parameters (window 7, 4 length buckets), with its K6 launch count and
   each bucket's first 4096 tracks against the plain version; the
   refined and raw positions' RMS error on random walks with known true
   positions; K6's time at 2^20 tracks (T=10, W=7, S=2), launched on
   prepared inputs and through ``refine_kernel.refine``, and the plain
   version's time on the same 2^20 tracks (in the chunks ``refine_plain``
   makes, about 40 s on an H100);
9. K7 (csrc/topk.cu): the top-K histogram (K7 with its decode fused in)
   against ``segment_topk_plain`` at twelve configurations with a
   forbidden transition (M = 512 at 2 and 4 states, 3 states, two
   sub-steps, per-peak LocErr, D = 1 and 3, T = 2 and 3 with 0/1-frame
   rows, a saturated register, a register that keeps every sequence but
   at the last step, whose raw parents and states are held slot by slot
   on the live slots, and one that never fills, held slot by slot on
   every slot), each twice for repeatability; then the top-K main
   path, ``histograms.len_hist(engine="topk")`` on the 10^5 tracks with
   the fitted parameters (M = 512, one K7 launch per 32768 tracks of a
   bucket), each bucket against the plain version, frame conservation,
   and the window engine's histogram beside it; ``len_hist(engine="topk")``
   on 3-state tracks, where the window engine's default raises; K7's time
   at 2^20 tracks (T=10 with M=512, T=30 with M=128), launched on prepared
   inputs and through ``topk_kernel.segment_topk``, both with the decode
   fused in, the plain version's time on the 2^20 tracks at T=10, M=512,
   and, for reading, ``torch.topk`` on one step's (2^20, 1024) scores;
   K7's bound as the live register needs it (``topk_ops``) beside the
   count of all M rows.

Every kernel's ``bound_ms`` is the larger of the bytes it must move (each
input read once, each output written once) over 3.35 TB/s and the
operations its walk does on this run's lengths (``walk_ops``) over
67 TFLOP/s f32 (one H100 SXM's published peaks at 700 W).

The line before the last is a JSON object describing each kernel: ``ms``
is the bare launches' time, ``wrapper_ms`` the same work through the
wrapper a caller uses (``forward``, ``value_and_table_grads``,
``table_hvp``, ``predict``, ``hist``, ``refine``, ``segment_topk``), host
work included;
the last
line is ``{"ok": true, "device": {...}}``.  Exits non-zero without output of
a result when no CUDA device is present.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

TOL_K1 = dict(rtol=2e-5, atol=2e-4)     # per-track logL, f32 vs f32 plain
TOL_K2_VALUE = dict(rtol=2e-5, atol=0.0)
TOL_K2_GRAD = dict(rtol=2e-3, atol=2e-3)
# objective z-gradient at ~10^5 tracks, each component against its own
# size; the fixed atol is the f32 rounding of a sum over 10^5 tracks
TOL_Z_GRAD = dict(rtol=2e-3, atol=0.5)
# Hessian columns (tests/test_hvp.py): rtol, atol and symmetry as
# fractions of max|H|
TOL_H = dict(rtol=5e-3, atol=1e-3, sym=2e-3)
# standard errors: f32 sums over 10^5 tracks go through an inverse
TOL_STD_ERR = 1e-2
TOL_K4_LOGL = dict(rtol=2e-4, atol=2e-4)   # tests/test_pallas_predict.py
TOL_K4_PREDS = dict(rtol=2e-3, atol=2e-4)
# (S, W, nb_substeps, D, B, T): the three fit configurations at ~3000
# tracks, then D = 1 and 3, a small ragged batch and a T = 2 batch
PARITY_CASES = [(2, 6, 1, 2, 3001, 10), (3, 5, 1, 2, 3001, 10),
                (2, 4, 2, 2, 3001, 10), (2, 5, 1, 1, 257, 6),
                (3, 3, 2, 3, 37, 12), (2, 3, 1, 2, 5, 2)]
# (S, W): K2 on each of its mappings, K = 8, 16, 32, 64 (warp and block)
# and K = 243 (block)
K2_MAPPING_CASES = [(2, 3), (2, 4), (2, 5), (2, 6), (3, 5)]
# K3: (S, W, nb_substeps, per-peak LocErr), 1500 tracks of T <= 10 in two
# buckets, p01 fixed at 0 (a forbidden transition) in every case
HVP_CASES = [(2, 6, 1, False), (2, 4, 2, False), (3, 5, 1, True),
             (4, 4, 1, False)]
HVP_TRACKS = 1500
# K4: (S, W, D, B, T, per-peak LocErr); the last one's history does not fit
# in shared memory and goes to global scratch
PREDICT_CASES = [(2, 5, 2, 3001, 10, False), (3, 4, 2, 3001, 10, True),
                 (2, 3, 2, 257, 2, True), (2, 3, 3, 301, 12, False),
                 (2, 9, 1, 64, 60, True)]
TOL_K5 = dict(rtol=2e-3, atol=2e-4)       # tests/test_pallas_hist.py
TOL_FRAMES = 2e-3                          # frame conservation, relative
TOL_K6_MU = dict(rtol=2e-4, atol=2e-5)     # tests/test_pallas_refine.py
TOL_K6_SIGMA = dict(rtol=2e-3, atol=2e-5)
# K5: (S, W, D, B, T, per-peak LocErr); the last one's rows do not fit in
# shared memory and go to global scratch
HIST_CASES = [(2, 7, 2, 3001, 10, False), (3, 5, 2, 3001, 10, False),
              (2, 5, 2, 3001, 10, True), (2, 4, 2, 257, 2, True),
              (2, 5, 1, 301, 12, False), (2, 4, 3, 301, 12, False),
              (2, 9, 2, 64, 60, True)]
# K6: the same fields; odd K (S=3), 4 states, and a stash in global scratch
# last
REFINE_CASES = [(2, 7, 2, 1001, 10, False), (3, 5, 2, 1001, 10, False),
                (4, 4, 2, 1001, 10, False), (2, 5, 2, 3001, 10, True),
                (2, 4, 2, 257, 2, True), (2, 5, 1, 301, 12, False),
                (2, 4, 3, 301, 12, False), (2, 8, 2, 32, 60, True)]
REFINE_CHECK = 4096           # main-path tracks per bucket held to plain
REFINE_PLAIN_WARMUP = 1 << 10  # tracks per bucket of the plain K6 warm-up
TOL_TOPK_UNPRUNED = dict(rtol=1e-4, atol=1e-5)   # tests/test_pallas_topk.py
TOL_TOPK_PRUNED = dict(rtol=2e-3, atol=2e-2)
# larger pruned cases, rtol and a fraction of max|hist| as atol: a near-tie
# in f32 re-ranks only a marginal sequence; the kernel has agreed with the
# plain version within 8e-8 of max|hist| (the f32 rounding of the sums)
TOL_TOPK_LARGE = 1e-5
# K7: (S, n, M, D, B, T, per-peak LocErr, kind): M = 512 is len_hist's
# register (2048 children at 4 states); the saturated register and the one
# that keeps every sequence but at the last step run a few dozen tracks;
# "prefix" never fills (held slot by slot on every slot, live or unused)
TOPK_CASES = [(2, 1, 512, 2, 3001, 10, False, "large"),
              (3, 1, 128, 2, 3001, 10, False, "large"),
              (2, 2, 64, 2, 3001, 10, False, "large"),
              (4, 1, 512, 2, 3001, 10, False, "large"),
              (2, 1, 128, 2, 3001, 10, True, "large"),
              (2, 1, 128, 1, 301, 12, False, "large"),
              (2, 1, 128, 3, 301, 12, False, "large"),
              (2, 1, 128, 2, 257, 2, True, "large"),
              (3, 1, 64, 2, 300, 3, False, "large"),
              (2, 1, 8, 2, 40, 8, False, "pruned"),
              (3, 1, 88, 2, 24, 5, False, "unpruned"),
              (2, 1, 512, 2, 300, 8, False, "prefix")]
SIM = dict(nb_tracks=100_000, max_track_len=20, min_track_len=3,
           Ds=(0.0, 0.08), LocErr=0.02, dt=0.02, pBL=0.1, cell_dims=(0.5,),
           seed=0)
FIT_ITERS = 200
BENCH_TRACKS = 1 << 20
PLAIN_CHUNK = 1 << 17         # tracks per plain autograd call (memory)
PLAIN_HVP_CHUNK = 1 << 15     # double backward keeps ~3x more per track
PLAIN_HIST_CHUNK = 1 << 16    # the plain histogram carries ~4K*(1+S)*T
HESS_CHUNK = 1 << 14          # hessian_chunked on the main path
PEAK_FLOPS = 67e12            # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def parity_case(S, W, n, seed, dev, B=3001, T=10, D=2, per_peak=False):
    """Random tracks (lengths 2..T, isBL on) and f32 tables with one
    forbidden transition, built on ``dev``."""
    from extrack_tpu_torch.core import tables
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, T + 1, B)
    lengths[:5] = (2, T, min(3, T), 0, 1)            # 0/1: padding rows
    xs = rng.normal(0, 0.05, (B, T, D)).cumsum(1)
    isbl = (lengths < T).astype(np.float32)
    f32 = dict(dtype=torch.float32, device=dev)
    Ds = torch.tensor(np.linspace(0.0, 0.15, S), **f32)
    rates = torch.tensor(rng.uniform(0.02, 0.2, (S, S)), **f32)
    rates[0, 1] = 0.0                                  # forbidden: log floor
    Fs = torch.full((S,), 1.0 / S, **f32)
    tb = tables.build_tables(Ds, torch.tensor(0.02, **f32), Fs, rates,
                             torch.tensor(0.1, **f32), 0.02,
                             cell_dims=(0.5,), nb_substeps=n)
    if per_peak:
        tb = tb._replace(loc_err2=torch.tensor(
            rng.uniform(2e-4, 8e-4, (B, T, D)), **f32))
    return (torch.tensor(xs, **f32),
            torch.tensor(lengths, dtype=torch.int32, device=dev),
            torch.tensor(isbl, **f32), tb)


def cuda_ms(fn, reps: int, warmup: int = 1):
    """Median wall time of fn() on the card in ms, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def bench_buckets(dev, T=10, seed=0):
    """BENCH_TRACKS 2-state random walks, lengths 3..T, length-bucketed on
    ``dev``."""
    from extrack_tpu_torch import data
    rng = np.random.default_rng(seed)
    lengths = rng.integers(3, T + 1, BENCH_TRACKS)
    tracks = {}
    for L in range(3, T + 1):
        nb = int((lengths == L).sum())
        state = rng.integers(0, 2, (nb, 1, 1))
        sig = np.where(state == 1, math.sqrt(2 * 0.08 * 0.02), 1e-4)
        steps = rng.normal(0, 1, (nb, L, 2)) * sig
        tracks[str(L)] = (steps.cumsum(1)
                          + rng.normal(0, 0.02, (nb, L, 2))).astype(np.float32)
    return data.from_dict_bucketed(tracks, max_buckets=4, device=dev,
                                   dtype=torch.float32)


def topk_bare(buckets, tb, M: int, dev):
    """A function that launches K7 on prepared inputs over the 2-state
    ``buckets`` (min_len 3), in the chunks hist_batch cuts, reusing one set
    of output buffers per bucket across its chunks: fused (histogram rows
    out), or raw (backpointers out) where the package predates the fused
    decode (tools/kernel_ab.py runs this against a parent checkout)."""
    from extrack_tpu_torch.histograms import TOPK_CHUNK
    from extrack_tpu_torch.ops import topk_kernel
    fused = hasattr(topk_kernel, "launch_fused")
    prep = []
    for b in buckets:
        d, t = topk_kernel.kernel_inputs(b.positions, b.lengths,
                                         b.is_bleached, tb, M, 1)
        n, T = min(TOPK_CHUNK, b.batch_size), b.max_len
        if fused:
            out = (torch.empty((n, T * 2), device=dev),
                   topk_kernel.fused_layout(n, T, 2, M, 2, 1, dev))
        else:
            out = topk_kernel.buffers(n, T, M, dev)
        prep.append((d, t, out))

    def run():
        for d, t, o in prep:
            for i in range(0, d[0].shape[0], TOPK_CHUNK):
                n = min(TOPK_CHUNK, d[0].shape[0] - i)
                chunk = [x[i:i + n] for x in d]
                if fused:
                    plan = (o[1][0], None if o[1][1] is None
                            else [x[:n] for x in o[1][1]])
                    topk_kernel.launch_fused(chunk, t, o[0][:n], 2, 1, 3,
                                             plan)
                else:
                    topk_kernel.launch(chunk, t, [x[:n] for x in o], 2, 1,
                                       3)
    return run


def topk_wrapped(buckets, tb, M: int):
    """A function that runs ``topk_kernel.segment_topk`` (K7 and the
    decode) over ``buckets`` in the chunks hist_batch cuts."""
    from extrack_tpu_torch.ops import topk_kernel

    def run():
        for b in buckets:
            topk_chunks(b, M, topk_kernel.segment_topk, tb)
    return run


def walk_ops(lengths, K, A, D, kind, T=0, W=0, S=0) -> float:
    """Operations (flops, with each exp / log / rsqrt / division counted as
    one) that a kernel's walk needs on tracks of these lengths, without
    the kernels' A-fold redundant fusion work.  Per slot and step the
    Gaussian update is 14 per dimension; a fusion group's moment match is
    A*(5+4D) + 3D + 3 (weights, exp-sum, means, tails, log); each child's
    variance and log weight D + 3; a look-ahead closing adds A*(9D+8) per
    slot.  K2 counts its backward walk at twice the forward's (each
    operation's pullback costs about two); K3 counts three per K2
    operation (value and product rule); K4 adds the live fusion at L-2,
    the update at L-1, its history mix and the harvest.  K5 runs L-2
    fusions, each child mixing A members' (1+S)*min(t+1, T) run/hist
    bins at step t (a weight of 4 and 2 per bin and member), and a
    harvest of 4 per slot and bin.  K6 runs 2(L-2) transition-only
    fusions (the suffix and the prefix scan), two one-sided ends of
    9D+5 per slot, and at each of the L-2 interior positions the two
    sides' precision forms (13D+6 per slot) and S*(K/S)^2 pairs of
    11D+8 each (P, N, 1/P, the mean, the exponent and the product of P
    per dimension; the weight's exp, rsqrt and products; the 1+2D
    accumulations)."""
    L = np.asarray(lengths, dtype=np.int64)
    L = L[L >= 2]
    G = K // A
    step = K * (14 * D + 2) + G * (A * (5 + 4 * D) + 3 * D + 3) \
        + K * (D + 3)
    if kind == "K5":
        ops = 0.0
        for t in range(1, int(L.max(initial=2)) - 1):
            bins = (1 + S) * min(t + 1, T)
            ops += float((L - 2 >= t).sum()) * (step + K * A * (4 + 2 * bins))
        return ops + float(L.size) * K * (14 * D + 7 + 4 * S * T)
    if kind == "K6":
        pairs = S * (K // S) ** 2 * (11 * D + 8) + K * (13 * D + 6)
        return float((2 * (L - 2) * step + 2 * K * (9 * D + 5)
                      + (L - 2) * pairs).sum())
    if kind == "K7":
        # K = M register rows: steps 1..L-1 fold the observation into the
        # rows (14D each), the last one closes (softmax, 4 per row); each
        # interior step 1..L-2 scores A*M children (9D+6), keeps the top M
        # in order and rebuilds each survivor's payload (2D+4).  Keeping
        # the top M needs no more than one compare and one tie compare per
        # child against the M-th key, then a sort of the M survivors:
        # M*log2(M) compare-exchanges of (key, index) pairs, each a
        # compare, a tie compare and four selects.  The kernel's bitonic
        # network over all 2^ceil(log2 A*M) children does 8 to 10 times
        # that work at M = 128 to 512
        interior = (A * K * (9 * D + 6) + 2 * A * K
                    + 6 * K * int(np.log2(K)) + K * (2 * D + 4))
        return float(((L - 1) * K * 14 * D + K * 4
                      + (L - 2) * interior).sum())
    close = K * (14 * D + 4) + K * A * (9 * D + 8)
    close2 = K * (14 * D + 8)
    fwd = float(np.where(L == 2, close2,
                         np.maximum(L - 3, 0) * step + close).sum())
    if kind == "K1":
        return fwd
    if kind == "K2":
        return 3.0 * fwd
    if kind == "K3":
        return 9.0 * fwd
    # K4: one more fusion and update per track, the mix of the filled
    # history frames (2*A flops per float per group) and the harvest
    mix = 0.0
    for t in range(1, int(L.max(initial=2)) - 1):
        fd = max(0, t + 1 - W)
        mix += G * A * 2.0 * fd * S * float((L - 2 >= t).sum())
    harvest = float((K * (3 + 2 * S * np.minimum(L, T))).sum())
    return fwd + float((L >= 3).sum()) * (step + K * 14 * D) + mix + harvest


def live_rows(L: int, P: int, A: int, M: int):
    """The live register rows of a top-K walk entering each step t = 1 ..
    L-1 of a track of L frames: P, then min(M, A * previous)."""
    live = [P]
    for _ in range(L - 2):
        live.append(min(M, A * live[-1]))
    return live


def topk_ops(lengths, M: int, A: int, D: int, P: int) -> float:
    """Operations K7's function needs on tracks of these lengths, counting
    only the live rows (``live_rows``): each step folds the observation
    into the live rows (14D), the last one closes (softmax, 4 per row);
    each interior step scores the A * live children (9D+6), keeps the top
    M of them in order and rebuilds each survivor's payload (2D+4).
    Keeping them in order needs N*log2(N) compare-exchanges of (key,
    index) pairs at 6 operations when all N children survive, else a
    compare and a tie compare per child against the M-th key and
    M*log2(M) compare-exchanges.  The decode walks each final live row
    back over the L frames (a parent and a state read, a compare and an
    add: 4 per row and frame)."""
    L = np.asarray(lengths, dtype=np.int64)
    counts = np.bincount(L[L >= 2])
    ops = 0.0
    for n_len, ntr in enumerate(counts):
        if not ntr:
            continue
        live = live_rows(n_len, P, A, M)
        per = sum(14 * D * v for v in live) + 4 * live[-1]
        for v in live[:-1]:
            N = A * v
            keep = min(N, M)
            sel = (6 * N * np.log2(max(N, 2)) if N <= M
                   else 2 * N + 6 * M * np.log2(M))
            per += N * (9 * D + 6) + sel + keep * (2 * D + 4)
        per += 4 * live[-1] * n_len
        ops += ntr * per
    return float(ops)


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over the card's memory
    rate and operations over its f32 rate."""
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def check_forward(tag, pos, lens, isbl, tb, **kw) -> float:
    """K1's per-track logL against ``forward_plain``'s at TOL_K1; prints one
    line, exits on a disagreement, returns the largest absolute error."""
    from extrack_tpu_torch.ops import forward_kernel
    got = forward_kernel.forward(pos, lens, isbl, tb, **kw)
    want = forward_kernel.forward_plain(pos, lens, isbl, tb, **kw)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
    ok = torch.allclose(got, want, **TOL_K1) and bool(
        torch.isfinite(got).all())
    log(f"{tag}: max_abs_err {err:.3e} max_rel_err {rel:.3e} "
        f"(tol {TOL_K1}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"K1 disagrees with forward_plain at {tag}")
    return err


def check_table_grads(tag, pos, lens, isbl, tb, **kw) -> float:
    """K2's value and every table cotangent against the plain version's at
    TOL_K2_VALUE / TOL_K2_GRAD; prints one line per table, exits on a
    disagreement, returns the largest absolute error."""
    from extrack_tpu_torch.ops import grad_kernel
    v, g = grad_kernel.value_and_table_grads(pos, lens, isbl, tb, **kw)
    v0, g0 = grad_kernel.value_and_table_grads_plain(pos, lens, isbl, tb,
                                                     **kw)
    torch.cuda.synchronize()
    ok = torch.allclose(v, v0, **TOL_K2_VALUE)
    worst = abs(float(v - v0))
    for name in g:
        good = torch.allclose(g[name], g0[name], **TOL_K2_GRAD)
        e = float((g[name] - g0[name]).abs().max())
        worst = max(worst, e)
        log(f"{tag}: d/d{name} {tuple(g[name].shape)} max_abs_err {e:.3e} "
            f"(|ref|max {float(g0[name].abs().max()):.3e}) "
            f"{'ok' if good else 'FAIL'}")
        ok &= good
    log(f"{tag}: value {float(v):.6f} vs plain {float(v0):.6f} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"K2 disagrees with value_and_table_grads_plain at {tag}")
    return worst


def check_hist(tag, got, want, frames: float, tol=TOL_K5,
               kernel="K5") -> float:
    """A kernel's (T, S) histogram against the plain one at ``tol``, and
    frame conservation: sum over l and s of l * hist[l-1, s] equals
    ``frames`` (the frames of the tracks of 2 frames or more) within
    TOL_FRAMES.  Prints one line, exits on a failure, returns the largest
    absolute error."""
    T = got.shape[0]
    err = float((got - want).abs().max())
    counted = float((got.double().cpu()
                     * torch.arange(1, T + 1, dtype=torch.float64)[:, None]
                     ).sum())
    rel = abs(counted - frames) / max(frames, 1.0)
    ok = (torch.allclose(got, want, **tol) and rel <= TOL_FRAMES
          and bool(torch.isfinite(got).all()))
    log(f"{tag}: max_abs_err {err:.3e} (max|hist| "
        f"{float(want.abs().max()):.4e}, tol rtol {tol['rtol']:.0e} atol "
        f"{tol['atol']:.3e}), frames {counted:.1f} of {frames:.0f} (rel "
        f"{rel:.2e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{kernel} disagrees with its plain version or loses frames at "
             f"{tag}")
    return err


def topk_tol(kind: str, want) -> dict:
    """K7's tolerance for one TOPK_CASES kind against the plain histogram
    ``want``."""
    if kind == "large":
        return dict(rtol=TOL_TOPK_LARGE,
                    atol=TOL_TOPK_LARGE * float(want.abs().max()))
    return (TOL_TOPK_UNPRUNED if kind in ("unpruned", "prefix")
            else TOL_TOPK_PRUNED)


def live_backpointers_equal(got, want, P: int):
    """(equal, live slots): K7's parents and states against the plain
    version's on every live slot (one that descends from a real initial
    pattern, as the plain version's parents trace it)."""
    par, st, _ = got
    par0, st0, _ = want
    Tm1, B, M = par0.shape
    live = torch.arange(M, device=par0.device).expand(B, M) < P
    same, count = True, 0
    for i in range(Tm1):
        live = live.gather(1, par0[i])
        same &= bool(torch.equal(par[i].long()[live], par0[i][live])
                     and torch.equal(st[i][live], st0[i][live]))
        count += int(live.sum())
    return same, count


def topk_chunks(b, M, fn, tb, min_len=3):
    """Sum of ``fn`` (segment_topk or its plain version) over the chunks of
    bucket ``b`` that hist_batch cuts for K7."""
    from extrack_tpu_torch.histograms import TOPK_CHUNK
    out = None
    for i in range(0, b.batch_size, TOPK_CHUNK):
        sl = slice(i, i + TOPK_CHUNK)
        h = fn(b.positions[sl], b.lengths[sl], b.is_bleached[sl], tb,
               max_nb_states=M, min_len=min_len)
        out = h if out is None else out + h
    return out


def refine_case(S, W, D, B, T, per_peak, seed, dev):
    """Random walks (lengths 2..T, with 0/1-frame rows) and K6's inputs on
    ``dev``: positions, lengths, l2, the floored log of a transition
    matrix with a zero, per-state displacement variances."""
    from extrack_tpu_torch.core import tables
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, T + 1, B)
    lengths[:5] = (2, T, min(3, T), 0, 1)
    xs = rng.normal(0, 0.05, (B, T, D)).cumsum(1)
    tr = rng.uniform(0.05, 0.3, (S, S)) / S
    tr[0, 1] = 0.0                                     # forbidden
    np.fill_diagonal(tr, 0.0)
    np.fill_diagonal(tr, 1.0 - tr.sum(1))
    f32 = dict(dtype=torch.float32, device=dev)
    l2 = (rng.uniform(1e-4, 9e-4, (B, T, D)) if per_peak
          else np.full((1, 1, 1), 4e-4))
    return (torch.tensor(xs, **f32),
            torch.tensor(lengths, dtype=torch.int32, device=dev),
            torch.tensor(l2, **f32), tables.cap_log(torch.tensor(tr, **f32)),
            torch.tensor((0.08 * (1 + np.arange(S))) ** 2, **f32))


def check_refine(tag, mu, sig, mu0, sig0, pos, lens, l2) -> float:
    """K6's (mu, sigma) against the plain version's at TOL_K6_MU /
    TOL_K6_SIGMA; padded frames exact zeros, 1-frame rows the observation
    and its localization error.  Prints one line, exits on a failure,
    returns the largest absolute error."""
    B, T, D = pos.shape
    L = lens.cpu().numpy()
    e_mu = float((mu - mu0).abs().max())
    e_sig = float((sig - sig0).abs().max())
    pad = torch.tensor(np.arange(T)[None, :] >= L[:, None], device=mu.device)
    lone = torch.tensor(L == 1, device=mu.device)
    l2 = l2.expand(B, T, D)
    ok = (torch.allclose(mu, mu0, **TOL_K6_MU)
          and torch.allclose(sig, sig0, **TOL_K6_SIGMA)
          and bool(torch.isfinite(mu).all() and torch.isfinite(sig).all())
          and bool((mu[pad] == 0).all() and (sig[pad] == 0).all())
          and torch.equal(mu[lone, 0], pos[lone, 0])
          and torch.equal(sig[lone, 0], l2[lone, 0].sqrt()))
    log(f"{tag}: mu max_abs_err {e_mu:.3e}, sigma max_abs_err {e_sig:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"K6 disagrees with refine_plain at {tag}")
    return max(e_mu, e_sig)


def plain_hessian_columns(*args, **kw):
    """``fit.hessian_hvp_columns`` with the plain double backward in place
    of K3."""
    from extrack_tpu_torch import fit
    from extrack_tpu_torch.ops import hvp_kernel
    saved = hvp_kernel.table_hvp
    hvp_kernel.table_hvp = hvp_kernel.table_hvp_plain
    try:
        return fit.hessian_hvp_columns(*args, **kw)
    finally:
        hvp_kernel.table_hvp = saved


def check_hessian(tag, H, H0) -> float:
    """Kernel Hessian columns against the plain ones at TOL_H, and the
    kernel's symmetry; prints one line, exits on a disagreement, returns
    the largest absolute error."""
    scale = float(np.abs(H0).max())
    err = float(np.abs(H - H0).max())
    asym = float(np.abs(H - H.T).max())
    ok = (np.allclose(H, H0, rtol=TOL_H["rtol"], atol=TOL_H["atol"] * scale)
          and asym <= TOL_H["sym"] * scale and bool(np.isfinite(H).all()))
    log(f"{tag}: {H.shape[0]} columns, max|H| {scale:.4e}, max_abs_err "
        f"{err:.3e} ({err / scale:.2e} of max|H|), |H - H^T| max "
        f"{asym:.3e} ({asym / scale:.2e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"K3 Hessian disagrees with the plain version at {tag}")
    return err


def hvp_case(S, W, n, per_peak, dev, seed, T=10):
    """Length-bucketed random tracks and a spec with p01 fixed at 0 (and
    an affine per-peak LocErr when ``per_peak``) for a K3 parity case."""
    from extrack_tpu_torch import data, params
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, T + 1, HVP_TRACKS)
    lengths[:2] = (T, 2)
    tracks, errs = {}, {}
    for L in range(1, T + 1):
        nb = int((lengths == L).sum())
        if nb:
            tracks[str(L)] = rng.normal(0, 0.05, (nb, L, 2)).cumsum(1)
            errs[str(L)] = rng.uniform(0.01, 0.03, (nb, L, 2))
    buckets = data.from_dict_bucketed(
        tracks, max_buckets=2, input_loc_err=errs if per_peak else None,
        device=dev, dtype=torch.float32)
    spec = params.generate_params(
        nb_states=S, D_max=1.0, LocErr_type=4 if per_peak else 1,
        slope_offsets_estimates=(1.0, 0.001))
    spec.add("p01", 0.0, vary=False)
    kw = dict(cell_dims=(0.5,), nb_substeps=n, window=W, min_len=2,
              input_loc_err=per_peak)
    return buckets, spec, kw


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from extrack_tpu_torch import (data, fit, histograms, params, predict,
                                   refine, simulate)
    from extrack_tpu_torch.core import tables
    from extrack_tpu_torch.ops import (cuda_lib, forward_kernel, grad_kernel,
                                       hist_kernel, hvp_kernel,
                                       predict_kernel, refine_kernel,
                                       topk_kernel)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()

    def entry(name, source, replaces):
        return {"name": name, "route": "cuda",
                "source": f"extrack_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": None, "max_abs_err": None,
                "ms": None, "wrapper_ms": None, "plain_ms": None,
                "bound_ms": None, "bound_by": None, "library_ms": None}

    # no single PyTorch call computes any of these recurrences, so
    # library_ms stays null (torch.topk does K7's selection only: its time
    # is printed for reading)
    kinfo = {
        "K1": entry("forward_loglik", "forward.cu",
                    "extrack_tpu/ops/pallas_engine.py:218"),
        "K2": entry("loglik_grad", "grad.cu",
                    "extrack_tpu/ops/pallas_grad.py:549"),
        "K3": entry("loglik_hvp", "hvp.cu",
                    "extrack_tpu/ops/pallas_hvp.py:78"),
        "K4": entry("posteriors", "predict.cu",
                    "extrack_tpu/ops/pallas_predict.py:65"),
        "K5": entry("duration_hist", "hist.cu",
                    "extrack_tpu/ops/pallas_hist.py:63"),
        "K6": entry("refinement", "refine.cu",
                    "extrack_tpu/ops/pallas_refine.py:108"),
        "K7": entry("topk_hist", "topk.cu",
                    "extrack_tpu/ops/pallas_topk.py:113"),
    }
    kmods = (forward_kernel, grad_kernel, hvp_kernel, predict_kernel,
             hist_kernel, refine_kernel, topk_kernel)
    errs = {k: [] for k in kinfo}

    def reset_counts():
        for m in kmods:
            m.LAUNCHES = m.PLAIN_CALLS = 0

    def plain_calls():
        return sum(m.PLAIN_CALLS for m in kmods)

    # ---- phase 0: toolchain and build ---------------------------------
    nvcc = cuda_lib.find_nvcc()
    nv = subprocess.run([nvcc, "--version"], capture_output=True, text=True)
    log(f"phase 0: torch {torch.__version__} cuda {torch.version.cuda} | "
        f"nvcc: {nv.stdout.strip().splitlines()[-1]}")
    log(f"phase 0: card: {card}")
    t0 = time.time()
    lib_path = cuda_lib.build()
    cuda_lib.library()
    log(f"phase 0: kernel build + load {time.time() - t0:.1f} s -> "
        f"{lib_path.name}")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if ("registers" in line or "spill" in line
                or "Compiling entry" in line):
            log("  ptxas " + line.strip())

    # ---- phase 1/2: kernel parity on the card ---------------------------
    for S, W, n, D, B, T in PARITY_CASES:
        pos, lens, isbl, tb = parity_case(S, W, n, 100 + S * 10 + W + n, dev,
                                          B=B, T=T, D=D, per_peak=(S == 3))
        kw = dict(window=W, nb_substeps=n, min_len=2)
        tag = f"S={S} W={W} n={n} D={D} B={B} T={T}"
        errs["K1"].append(check_forward(f"phase 1: K1 {tag}", pos, lens,
                                        isbl, tb, **kw))
        errs["K2"].append(check_table_grads(f"phase 2: K2 {tag}", pos, lens,
                                            isbl, tb, **kw))
    # K2 on each mapping: the block mapping is forced by a zero warp limit
    for S, W in K2_MAPPING_CASES:
        pos, lens, isbl, tb = parity_case(S, W, 1, 150 + S * 10 + W, dev)
        kw = dict(window=W, nb_substeps=1, min_len=2)
        saved = grad_kernel.WARP_MAX_K
        for mapping in (("warp", "block") if S ** W <= saved
                        else ("block",)):
            grad_kernel.WARP_MAX_K = saved if mapping == "warp" else 0
            try:
                errs["K2"].append(check_table_grads(
                    f"phase 2: K2 {mapping} mapping S={S} W={W} "
                    f"(K={S ** W})", pos, lens, isbl, tb, **kw))
            finally:
                grad_kernel.WARP_MAX_K = saved

    # ---- phase 3: the fit main path --------------------------------------
    t0 = time.time()
    tracks, true_states, _ = simulate.sim_fov(**SIM)
    n_tr = sum(len(v) for v in tracks.values())
    log(f"phase 3: simulated {n_tr} tracks in {time.time() - t0:.1f} s")
    # kernels vs plain at the fit's own bucket shapes, start parameters:
    # first each table cotangent per bucket, then the whole objective
    buckets = data.from_dict_bucketed(tracks, max_buckets=4, device=dev,
                                      dtype=torch.float32)
    spec = params.generate_params(
        nb_states=2, LocErr_type=1, LocErr_bounds=(0.005, 0.1),
        D_max=3.0, estimated_transition_rates=0.1)
    z0 = torch.tensor(spec.to_unconstrained(), dtype=torch.float32,
                      device=dev, requires_grad=True)
    with torch.no_grad():
        Ds, Fs, rates, loc_err, pBL = params.extract_arrays(
            spec.resolve(spec.from_unconstrained(z0)), 2, device=dev,
            dtype=torch.float32)
        tb0 = tables.build_tables(Ds, loc_err, Fs, rates, pBL, 0.02,
                                  cell_dims=(0.5,))
    min_len = data.default_min_len(
        np.concatenate([data.host_lengths(b) for b in buckets]))
    kw = dict(window=fit.default_window(2), nb_substeps=1, min_len=min_len)
    for b in buckets:
        tag = f"bucket T={b.max_len} B={b.batch_size}"
        args = (b.positions, b.lengths, b.is_bleached, tb0)
        errs["K1"].append(check_forward(f"phase 3: K1 {tag}", *args, **kw))
        errs["K2"].append(check_table_grads(f"phase 3: K2 {tag}", *args,
                                            **kw))
    obj = fit.make_objective(buckets, spec, 0.02, 2, cell_dims=(0.5,))
    v_k = obj(z0)
    (g_k,) = torch.autograd.grad(v_k, z0)
    saved = grad_kernel.neg_log_likelihood
    grad_kernel.neg_log_likelihood = grad_kernel.neg_log_likelihood_plain
    try:
        v_p = obj(z0)
        (g_p,) = torch.autograd.grad(v_p, z0)
    finally:
        grad_kernel.neg_log_likelihood = saved
    ok = (torch.allclose(v_k, v_p, **TOL_K2_VALUE)
          and torch.allclose(g_k, g_p, **TOL_Z_GRAD))
    log(f"phase 3: objective at z0, kernel vs plain over "
        f"{len(buckets)} buckets (T={[b.max_len for b in buckets]}): "
        f"value {float(v_k.detach()):.4f} vs {float(v_p.detach()):.4f}")
    for name, a, b in zip(spec.free_names(), g_k.tolist(), g_p.tolist()):
        log(f"phase 3: dobjective/dz[{name}] kernel {a:.6e} plain {b:.6e} "
            f"abs_err {abs(a - b):.3e}")
    log(f"phase 3: objective parity (value {TOL_K2_VALUE}, z-grad "
        f"{TOL_Z_GRAD}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("main-path objective: kernel disagrees with plain")

    # the main path: fit with error bars, through the default entry point
    evals = []
    reset_counts()
    t0 = time.time()
    t_evals = []
    res = fit.param_fitting(
        tracks, 0.02, nb_states=2, compute_errors=True, max_iter=FIT_ITERS,
        verbose=0, cell_dims=(0.5,),
        callback=lambda i, v, vals: (evals.append(v),
                                     t_evals.append(time.time())))
    torch.cuda.synchronize()
    t_fit = time.time() - t0
    k2, k3, plain = grad_kernel.LAUNCHES, hvp_kernel.LAUNCHES, plain_calls()
    for i in (1, len(evals)):
        log(f"phase 3: eval {i}: logL {-evals[i - 1]:.4f}")
    log(f"phase 3: fit with error bars {t_fit:.2f} s: {res.n_evals} evals "
        f"({res.message}) {t_evals[-1] - t0:.2f} s, then the error bars "
        f"{t0 + t_fit - t_evals[-1]:.2f} s; initial logL {-evals[0]:.4f} -> "
        f"final {res.logl:.4f}; K2 launches {k2}, K3 launches {k3}, plain "
        f"calls {plain} [{card}]")
    log("phase 3: fitted " + ", ".join(
        f"{k}={p.value:.5g}" for k, p in res.params.items()))
    if not (res.logl > -evals[0] and math.isfinite(res.logl)):
        fail("the fit did not improve the log likelihood")
    n_free = len(spec.free_names())
    if k2 == 0 or k3 != n_free * len(buckets) or plain != 0:
        fail(f"main path K2 launches {k2}, K3 launches {k3} (want "
             f"{n_free} x {len(buckets)}), plain calls {plain}")
    reset_counts()
    with torch.no_grad():
        v = obj(torch.tensor(spec.to_unconstrained(), dtype=torch.float32,
                             device=dev))
    k1, plain = forward_kernel.LAUNCHES, plain_calls()
    log(f"phase 3: value-only objective {float(v):.4f}: K1 launches "
        f"{k1}, plain calls {plain}")
    v_ref = float(v_k.detach())
    if k1 == 0 or plain != 0 or abs(float(v) - v_ref) > 2e-5 * abs(v_ref):
        fail("value-only objective did not run K1 or disagrees")
    kinfo["K1"]["launches"] = k1
    kinfo["K2"]["launches"] = k2
    kinfo["K3"]["launches"] = k3

    # ---- phase 4: times at the benchmark shape ---------------------------
    bench = bench_buckets(dev)
    n_bench = sum(b.batch_size for b in bench)
    bench_lens = np.concatenate([data.host_lengths(b) for b in bench])
    f32 = dict(dtype=torch.float32, device=dev)
    tb = tables.build_tables(
        torch.tensor([0.0, 0.08], **f32), torch.tensor(0.02, **f32),
        torch.tensor([0.5, 0.5], **f32),
        torch.tensor([[0.0, 0.1], [0.1, 0.0]], **f32),
        torch.tensor(0.1, **f32), 0.02, cell_dims=(0.5,))
    kw = dict(window=6, nb_substeps=1, min_len=3)
    args4 = [forward_kernel.kernel_inputs(b.positions, b.lengths,
                                          b.is_bleached, tb, 6, 1)
             for b in bench]
    args4 = [(d, [t.detach() for t in tabs]) for d, tabs in args4]

    def k1_run():
        for d, tabs in args4:
            forward_kernel.launch(d, tabs, 3)

    def k1_wrapped():
        for b in bench:
            forward_kernel.forward(b.positions, b.lengths, b.is_bleached, tb,
                                   **kw)

    def p1_run():
        with torch.no_grad():
            for b in bench:
                forward_kernel.forward_plain(b.positions, b.lengths,
                                             b.is_bleached, tb, **kw)

    def k2_run():
        for d, tabs in args4:
            grad_kernel.launch(d, tabs, 3)

    def k2_wrapped():
        # the same through the autograd.Function and kernel_inputs, as a fit
        # evaluation calls it: the host work between launches shows here
        for b in bench:
            grad_kernel.value_and_table_grads(b.positions, b.lengths,
                                              b.is_bleached, tb, **kw)

    def p2_run():
        # autograd of the engine keeps ~3000 floats per track and step:
        # chunks bound that to a few GB
        for b in bench:
            for i in range(0, b.batch_size, PLAIN_CHUNK):
                sl = slice(i, i + PLAIN_CHUNK)
                grad_kernel.value_and_table_grads_plain(
                    b.positions[sl], b.lengths[sl], b.is_bleached[sl],
                    tb, **kw)

    ms = {"K1": cuda_ms(k1_run, 10), "K2": cuda_ms(k2_run, 10)}
    k2_other = {}
    for mapping, stash in (("block", None), ("warp", "global")):
        def k2_forced(mapping=mapping, stash=stash):
            for d, tabs in args4:
                grad_kernel.launch(d, tabs, 3, mapping=mapping, stash=stash)
        k2_other[f"{mapping}, history {stash or 'default'}"] = cuda_ms(
            k2_forced, 10)
    wms = {"K1": cuda_ms(k1_wrapped, 5), "K2": cuda_ms(k2_wrapped, 5)}
    pms = {"K1": cuda_ms(p1_run, 3), "K2": cuda_ms(p2_run, 3)}
    # bytes: positions and l2 (B, T, D) in, lengths and isBL in, logL out;
    # K2 also writes d/dl2 (B, T, D); the tables are a few KB
    rows = sum(b.positions.numel() for b in bench) * 4
    nbytes = {"K1": 2 * rows + 12 * n_bench, "K2": 3 * rows + 12 * n_bench}
    for k in ("K1", "K2"):
        kinfo[k]["ms"], kinfo[k]["plain_ms"] = ms[k], pms[k]
        kinfo[k]["wrapper_ms"] = wms[k]
        kinfo[k]["bound_ms"], kinfo[k]["bound_by"] = bound(
            nbytes[k], walk_ops(bench_lens, 64, 2, 2, k))
        log(f"phase 4: {k} {n_bench} tracks ({len(bench)} buckets): "
            f"kernel {ms[k]:.3f} ms = {n_bench / ms[k] * 1e3 / 1e6:.3f}M "
            f"tracks/s (with its wrapper {wms[k]:.3f} ms); plain "
            f"{pms[k]:.3f} ms = "
            f"{n_bench / pms[k] * 1e3 / 1e6:.3f}M tracks/s; bound "
            f"{kinfo[k]['bound_ms']:.4f} ms ({kinfo[k]['bound_by']}) "
            f"[{card}]")
    log("phase 4: K2 for reading: " + ", ".join(
        f"{k} mapping {v:.3f} ms" for k, v in k2_other.items())
        + f" (default: warp mapping {ms['K2']:.3f} ms) [{card}]")

    # ---- phase 5: K3 -------------------------------------------------------
    for S, W, n, per_peak in HVP_CASES:
        buckets5, spec5, kw5 = hvp_case(S, W, n, per_peak, dev,
                                        200 + S * 10 + W + n)
        z5 = spec5.to_unconstrained()
        H = fit.hessian_hvp_columns(buckets5, spec5, z5, 0.02, S, **kw5)
        H0 = plain_hessian_columns(buckets5, spec5, z5, 0.02, S, **kw5)
        errs["K3"].append(check_hessian(
            f"phase 5: K3 S={S} W={W} n={n} per-peak={per_peak} "
            f"T={[b.max_len for b in buckets5]}", H, H0))

    # the main path's Hessian at the fitted parameters, against plain
    # second-order autograd of the engine
    z_fit = res.params.to_unconstrained()
    kw5 = dict(cell_dims=(0.5,), window=fit.default_window(2),
               min_len=min_len)
    t0 = time.time()
    H = fit.hessian_hvp_columns(buckets, spec, z_fit, 0.02, 2, **kw5)
    torch.cuda.synchronize()
    t_h = time.time() - t0
    t0 = time.time()
    H0 = fit.hessian_chunked(buckets, spec, z_fit, 0.02, 2, chunk=HESS_CHUNK,
                             **kw5)
    log(f"phase 5: main-path Hessian {t_h:.2f} s through K3 "
        f"({n_free * len(buckets)} launches), {time.time() - t0:.2f} s "
        f"through hessian_chunked [{card}]")
    errs["K3"].append(check_hessian("phase 5: K3 main path (4 buckets, "
                                    "plain: hessian_chunked)", H, H0))
    se_plain = fit.fisher_errors_from_hessian(H0, res.params, z_fit)
    ok = True
    for name, zi in zip(res.params.free_names(), z_fit):
        se, p = res.std_errors[name], res.params[name]
        rel = abs(se - se_plain[name]) / max(abs(se_plain[name]), 1e-30)
        # a parameter pinned at a bound (its bijection's slope below 1e-6
        # of the range) has no Gaussian error bar: both sides are round-off
        slope = float(torch.autograd.functional.jacobian(
            lambda z_: params._from_z(z_, p.min, p.max),
            torch.tensor(float(zi), dtype=torch.float64)))
        pinned = (math.isfinite(p.max - p.min)
                  and slope < 1e-6 * (p.max - p.min))
        good = math.isfinite(se) and (pinned or rel <= TOL_STD_ERR)
        ok &= good
        log(f"phase 5: std error {name} = {p.value:.6g} +/- {se:.6g} (K3) "
            f"vs {se_plain[name]:.6g} (plain), rel {rel:.2e}"
            f"{' (pinned at a bound: not compared)' if pinned else ''} "
            f"{'ok' if good else 'FAIL'}")
    log(f"phase 5: main path K3 launches {k3} = {n_free} free parameters x "
        f"{len(buckets)} buckets, plain calls 0")
    if not ok:
        fail(f"standard errors differ from the plain path by > "
             f"{TOL_STD_ERR}")

    # K3 time: one tangent direction over the bench buckets; the kernel's
    # tangent inputs come from kernel_inputs' JVP once, as table_hvp makes
    # them
    gen = torch.Generator(device="cpu").manual_seed(5)
    tb_dot = tables.ModelTables(*(
        1e-3 * torch.randn(f.shape, generator=gen).to(dev) for f in tb))
    args5 = []
    for b, (d, tabs) in zip(bench, args4):
        def args_of(*fs, _b=b):
            d_, t_ = forward_kernel.kernel_inputs(
                _b.positions, _b.lengths, _b.is_bleached,
                tables.ModelTables(*fs), 6, 1)
            return (d_[1], *t_)
        _, dots = torch.autograd.functional.jvp(args_of, tuple(tb),
                                                tuple(tb_dot))
        args5.append((d, tabs, [t.contiguous() for t in dots]))

    def k3_run():
        for d, tabs, dots in args5:
            hvp_kernel.launch(d, tabs, dots[0], dots[1:], 3)

    def k3_wrapped():
        for b in bench:
            hvp_kernel.table_hvp(b.positions, b.lengths, b.is_bleached, tb,
                                 tb_dot, **kw)

    def p3_run():
        for b in bench:
            for i in range(0, b.batch_size, PLAIN_HVP_CHUNK):
                sl = slice(i, i + PLAIN_HVP_CHUNK)
                hvp_kernel.table_hvp_plain(
                    b.positions[sl], b.lengths[sl], b.is_bleached[sl], tb,
                    tb_dot, **kw)

    def k3_block():
        for d, tabs, dots in args5:
            hvp_kernel.launch(d, tabs, dots[0], dots[1:], 3, mapping="block")

    ms3, wms3 = cuda_ms(k3_run, 10), cuda_ms(k3_wrapped, 5)
    ms3_block = cuda_ms(k3_block, 10)
    pms3 = cuda_ms(p3_run, 1, warmup=0)
    dual_rows = sum(b.positions.numel() for b in bench) * 4
    kinfo["K3"]["ms"], kinfo["K3"]["plain_ms"] = ms3, pms3
    kinfo["K3"]["wrapper_ms"] = wms3
    kinfo["K3"]["bound_ms"], kinfo["K3"]["bound_by"] = bound(
        dual_rows * (1 + 2 + 2) + 16 * n_bench,
        walk_ops(bench_lens, 64, 2, 2, "K3"))
    log(f"phase 5: K3 {n_bench} tracks ({len(bench)} buckets), one tangent "
        f"direction: kernel {ms3:.3f} ms (with its wrapper {wms3:.3f} ms); "
        f"plain (double backward, chunks of "
        f"{PLAIN_HVP_CHUNK}) {pms3:.3f} ms; bound "
        f"{kinfo['K3']['bound_ms']:.4f} ms ({kinfo['K3']['bound_by']}); "
        f"block mapping {ms3_block:.3f} ms (for reading) [{card}]")

    # ---- phase 6: K4 -------------------------------------------------------
    for S, W, D, B, T, per_peak in PREDICT_CASES:
        pos, lens, isbl, tb6 = parity_case(S, W, 1, 300 + S * 10 + W + T,
                                           dev, B=B, T=T, D=D,
                                           per_peak=per_peak)
        kw6 = dict(window=W, min_len=2)
        logl, preds = predict_kernel.predict(pos, lens, isbl, tb6, **kw6)
        logl0, preds0 = predict_kernel.predict_plain(pos, lens, isbl, tb6,
                                                     **kw6)
        torch.cuda.synchronize()
        e_l = float((logl - logl0).abs().max())
        e_p = float((preds - preds0).abs().max())
        L = lens.cpu().numpy()
        valid = (np.arange(T)[None, :] < L[:, None]) & (L >= 2)[:, None]
        sums = preds.sum(-1).cpu().numpy()
        ok = (torch.allclose(logl, logl0, **TOL_K4_LOGL)
              and torch.allclose(preds, preds0, **TOL_K4_PREDS)
              and np.allclose(sums[valid], 1.0, atol=1e-3)
              and bool(np.all(sums[~valid] == 0.0)))
        errs["K4"].append(max(e_l, e_p))
        log(f"phase 6: K4 S={S} W={W} D={D} B={B} T={T} per-peak="
            f"{per_peak}: logL max_abs_err {e_l:.3e}, preds max_abs_err "
            f"{e_p:.3e}, |sum-1| max {np.abs(sums[valid] - 1).max():.2e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"K4 disagrees with predict_plain at S={S} W={W} T={T}")

    # the annotation main path, through the default entry point
    values = {k: p.value for k, p in res.params.items()}
    reset_counts()
    t0 = time.time()
    out = predict.predict_Bs(tracks, 0.02, values, cell_dims=(0.5,),
                             nb_states=2, frame_len=5)
    torch.cuda.synchronize()
    t_pred = time.time() - t0
    k4, plain = predict_kernel.LAUNCHES, plain_calls()
    log(f"phase 6: predict_Bs on {n_tr} tracks {t_pred:.2f} s; K4 launches "
        f"{k4}, plain calls {plain}")
    if k4 == 0 or plain != 0:
        fail(f"annotation main path K4 launches {k4}, plain calls {plain}")
    kinfo["K4"]["launches"] = k4
    # each of predict_Bs's buckets against the plain version
    pbuckets = data.from_dict_bucketed(tracks, max_buckets=4, device=dev,
                                       dtype=torch.float32)
    Ds, Fs, rates, loc_err, pBL = params.extract_arrays(
        values, 2, device=dev, dtype=torch.float32)
    tbf = tables.build_tables(Ds, loc_err, Fs, rates, pBL, 0.02,
                              cell_dims=(0.5,))
    hits = total = 0
    for b in pbuckets:
        args = (b.positions, b.lengths, b.is_bleached, tbf)
        logl, preds = predict_kernel.predict(*args, window=5, min_len=min_len)
        logl0, preds0 = predict_kernel.predict_plain(*args, window=5,
                                                     min_len=min_len)
        got = data.to_dict(b, preds0)
        e_d = max(float(np.abs(out[k] - got[k]).max()) for k in got)
        L = data.host_lengths(b)
        valid = np.arange(b.max_len)[None, :] < L[:, None]
        sums = preds.sum(-1).cpu().numpy()
        ok = (torch.allclose(logl, logl0, **TOL_K4_LOGL)
              and torch.allclose(preds, preds0, **TOL_K4_PREDS)
              and np.allclose(sums[valid], 1.0, atol=1e-3)
              and bool(np.all(sums[~valid] == 0.0))
              and e_d <= TOL_K4_PREDS["atol"] + TOL_K4_PREDS["rtol"])
        errs["K4"].append(float((preds - preds0).abs().max()))
        log(f"phase 6: bucket T={b.max_len} B={b.batch_size}: logL "
            f"max_abs_err {float((logl - logl0).abs().max()):.3e}, preds "
            f"max_abs_err {float((preds - preds0).abs().max()):.3e}, "
            f"predict_Bs vs plain {e_d:.3e}, |sum-1| max "
            f"{np.abs(sums[valid] - 1).max():.2e} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"predict_Bs bucket T={b.max_len} disagrees with plain")
        for k in got:
            hits += int((out[k].argmax(-1) == true_states[k]).sum())
            total += true_states[k].size
    log(f"phase 6: frames whose most probable state is the simulated one: "
        f"{hits}/{total} = {hits / total:.4f} (for reading, not a gate)")

    # K4 time at 2^20 tracks, T=10, W=5
    args6 = [forward_kernel.kernel_inputs(b.positions, b.lengths,
                                          b.is_bleached, tb, 5, 1)
             for b in bench]
    args6 = [(d, [t.detach() for t in tabs]) for d, tabs in args6]

    def k4_run():
        for d, tabs in args6:
            predict_kernel.launch(d, tabs, 3, 2, 5)

    def k4_wrapped():
        for b in bench:
            predict_kernel.predict(b.positions, b.lengths, b.is_bleached, tb,
                                   window=5, min_len=3)

    def p4_run():
        with torch.no_grad():
            for b in bench:
                for i in range(0, b.batch_size, PLAIN_CHUNK):
                    sl = slice(i, i + PLAIN_CHUNK)
                    predict_kernel.predict_plain(
                        b.positions[sl], b.lengths[sl], b.is_bleached[sl],
                        tb, window=5, min_len=3)

    ms4, wms4 = cuda_ms(k4_run, 10), cuda_ms(k4_wrapped, 5)
    pms4 = cuda_ms(p4_run, 3)
    preds_bytes = sum(b.batch_size * b.max_len for b in bench) * 2 * 4
    kinfo["K4"]["ms"], kinfo["K4"]["plain_ms"] = ms4, pms4
    kinfo["K4"]["wrapper_ms"] = wms4
    kinfo["K4"]["bound_ms"], kinfo["K4"]["bound_by"] = bound(
        2 * rows + 12 * n_bench + preds_bytes,
        walk_ops(bench_lens, 32, 2, 2, "K4", T=10, W=5, S=2))
    log(f"phase 6: K4 {n_bench} tracks ({len(bench)} buckets), W=5: kernel "
        f"{ms4:.3f} ms = {n_bench / ms4 * 1e3 / 1e6:.3f}M tracks/s (with "
        f"its wrapper {wms4:.3f} ms); plain "
        f"{pms4:.3f} ms; bound {kinfo['K4']['bound_ms']:.4f} ms "
        f"({kinfo['K4']['bound_by']}) [{card}]")

    # ---- phase 7: K5 -------------------------------------------------------
    for S, W, D, B, T, per_peak in HIST_CASES:
        pos, lens, isbl, tb7 = parity_case(S, W, 1, 400 + S * 10 + W + T,
                                           dev, B=B, T=T, D=D,
                                           per_peak=per_peak)
        kw7 = dict(window=W, min_len=2)
        h = hist_kernel.hist(pos, lens, isbl, tb7, **kw7)
        again = hist_kernel.hist(pos, lens, isbl, tb7, **kw7)
        h0 = hist_kernel.hist_plain(pos, lens, isbl, tb7, **kw7)
        L = lens.cpu().numpy()
        errs["K5"].append(check_hist(
            f"phase 7: K5 S={S} W={W} D={D} B={B} T={T} per-peak={per_peak}",
            h, h0, float(L[L >= 2].sum())))
        if not torch.equal(h, again):
            fail(f"K5 gave two histograms for one input at S={S} W={W}")

    # the histogram main path, through the default entry point
    reset_counts()
    t0 = time.time()
    hist = histograms.len_hist(tracks, values, 0.02, cell_dims=(0.5,),
                               nb_states=2)
    t_hist = time.time() - t0
    k5, plain = hist_kernel.LAUNCHES, plain_calls()
    log(f"phase 7: len_hist on {n_tr} tracks (window 7) {t_hist:.2f} s; K5 "
        f"launches {k5}, plain calls {plain} [{card}]")
    if k5 != len(pbuckets) or plain != 0:
        fail(f"histogram main path K5 launches {k5} (want {len(pbuckets)}), "
             f"plain calls {plain}")
    kinfo["K5"]["launches"] = k5
    summed = np.zeros_like(hist)
    for b in pbuckets:
        args = (b.positions, b.lengths, b.is_bleached, tbf)
        h = hist_kernel.hist(*args, window=7, min_len=min_len)
        h0 = hist_kernel.hist_plain(*args, window=7, min_len=min_len)
        L = data.host_lengths(b)
        errs["K5"].append(check_hist(
            f"phase 7: bucket T={b.max_len} B={b.batch_size}", h, h0,
            float(L[L >= 2].sum())))
        summed[:b.max_len] += h.double().cpu().numpy()
    frames = sum(int(k) * len(v) for k, v in tracks.items() if int(k) >= 2)
    counted = float((hist * np.arange(1, hist.shape[0] + 1)[:, None]).sum())
    ok = (np.array_equal(summed, hist)
          and abs(counted - frames) <= TOL_FRAMES * frames)
    log(f"phase 7: len_hist = the sum of its buckets' K5 histograms: "
        f"{np.array_equal(summed, hist)}; frames {counted:.1f} of {frames} "
        f"(rel {abs(counted - frames) / frames:.2e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("len_hist differs from its buckets or loses frames")
    truth = histograms.ground_truth_hist(true_states, nb_states=2)
    log("phase 7: segments of length l, state 0 / state 1, fitted model vs "
        "simulated states (for reading, not a gate):")
    for ln in range(1, min(10, hist.shape[0]) + 1):
        log(f"  l={ln:2d}: {hist[ln - 1, 0]:10.1f} / {hist[ln - 1, 1]:10.1f}"
            f"   simulated {truth[ln - 1, 0]:8.0f} / {truth[ln - 1, 1]:8.0f}")

    # K5 time at 2^20 tracks, T=10, W=7
    args7 = [forward_kernel.kernel_inputs(b.positions, b.lengths,
                                          b.is_bleached, tb, 7, 1)
             for b in bench]
    args7 = [(d, [t.detach() for t in tabs[:6]]) for d, tabs in args7]

    def k5_run():
        for d, tabs in args7:
            hist_kernel.launch(d, tabs, 3, 2, 7)

    def k5_wrapped():
        for b in bench:
            hist_kernel.hist(b.positions, b.lengths, b.is_bleached, tb,
                             window=7, min_len=3)

    def p5_run():
        with torch.no_grad():
            for b in bench:
                for i in range(0, b.batch_size, PLAIN_HIST_CHUNK):
                    sl = slice(i, i + PLAIN_HIST_CHUNK)
                    hist_kernel.hist_plain(
                        b.positions[sl], b.lengths[sl], b.is_bleached[sl],
                        tb, window=7, min_len=3)

    ms5, wms5 = cuda_ms(k5_run, 10), cuda_ms(k5_wrapped, 5)
    pms5 = cuda_ms(p5_run, 1)
    # bytes: positions and l2 in, lengths and isBL in, the static segment
    # tables once per bucket, the (T, S) histogram out
    seg_bytes = sum(9 * 2 * b.max_len * 128 * 4 for b in bench)
    kinfo["K5"]["ms"], kinfo["K5"]["plain_ms"] = ms5, pms5
    kinfo["K5"]["wrapper_ms"] = wms5
    kinfo["K5"]["bound_ms"], kinfo["K5"]["bound_by"] = bound(
        2 * rows + 8 * n_bench + seg_bytes,
        sum(walk_ops(data.host_lengths(b), 128, 2, 2, "K5", T=b.max_len,
                     W=7, S=2) for b in bench))
    log(f"phase 7: K5 {n_bench} tracks ({len(bench)} buckets), W=7: kernel "
        f"{ms5:.3f} ms = {n_bench / ms5 * 1e3 / 1e6:.3f}M tracks/s (with "
        f"its wrapper {wms5:.3f} ms); plain {pms5:.3f} ms (chunks of "
        f"{PLAIN_HIST_CHUNK}); bound {kinfo['K5']['bound_ms']:.4f} ms "
        f"({kinfo['K5']['bound_by']}) [{card}]")

    # ---- phase 8: K6 -------------------------------------------------------
    for S, W, D, B, T, per_peak in REFINE_CASES:
        pos, lens, l2, lt, sig2 = refine_case(S, W, D, B, T, per_peak,
                                              500 + S * 10 + W + T, dev)
        mu, sig = refine_kernel.refine(pos, lens, l2, lt, sig2, window=W)
        mu0, sig0 = refine_kernel.refine_plain(pos, lens, l2, lt, sig2,
                                               window=W)
        errs["K6"].append(check_refine(
            f"phase 8: K6 S={S} W={W} D={D} B={B} T={T} per-peak={per_peak}",
            mu, sig, mu0, sig0, pos, lens, l2))

    # the refinement main path, through the default entry point, with the
    # fitted parameters: ds = sqrt(2 D dt), the port's transition matrix
    loc8 = values["LocErr"]
    ds8 = np.sqrt(2.0 * np.array([values["D0"], values["D1"]]) * 0.02)
    tr8 = tables.transition_matrix(rates).cpu().numpy()
    reset_counts()
    t0 = time.time()
    mus, sigmas = refine.position_refinement(
        tracks, loc8, ds8, [values["F0"], values["F1"]], tr8)
    t_ref = time.time() - t0
    k6, plain = refine_kernel.LAUNCHES, plain_calls()
    log(f"phase 8: position_refinement on {n_tr} tracks (window "
        f"{refine.default_window(2)}) {t_ref:.2f} s; K6 launches {k6}, plain "
        f"calls {plain} [{card}]")
    if k6 != len(pbuckets) or plain != 0:
        fail(f"refinement main path K6 launches {k6} (want {len(pbuckets)}), "
             f"plain calls {plain}")
    kinfo["K6"]["launches"] = k6
    f32 = dict(dtype=torch.float32, device=dev)
    l2_8 = (torch.tensor(loc8, **f32) ** 2).reshape(1, 1, 1)
    lt8 = tables.cap_log(torch.tensor(tr8, **f32))
    sig2_8 = torch.tensor(ds8, **f32) ** 2
    for b in pbuckets:
        mu, sig = refine.refine_batch(b, loc8, ds8, tr8)
        got_mu, got_sig = data.to_dict(b, mu), data.to_dict(b, sig[..., 0])
        same = all(np.array_equal(got_mu[k], mus[k])
                   and np.array_equal(got_sig[k], sigmas[k]) for k in got_mu)
        n = min(REFINE_CHECK, b.batch_size)
        mu0, sig0 = refine_kernel.refine_plain(
            b.positions[:n], b.lengths[:n], l2_8, lt8, sig2_8, window=7)
        errs["K6"].append(check_refine(
            f"phase 8: bucket T={b.max_len} B={b.batch_size}, first {n} "
            f"tracks", mu[:n], sig[:n], mu0, sig0, b.positions[:n],
            b.lengths[:n], l2_8))
        if not same:
            fail(f"position_refinement differs from K6 on bucket "
                 f"T={b.max_len}")

    # for reading: random walks with known true positions
    rng = np.random.default_rng(8)
    n_rw, L_rw = 20_000, 12
    st = np.zeros((n_rw, L_rw), int)
    st[:, 0] = rng.random(n_rw) < 0.5
    for t in range(1, L_rw):
        st[:, t] = np.where(rng.random(n_rw) < tr8[st[:, t - 1], 1], 1, 0)
    true = np.cumsum(rng.normal(0, 1, (n_rw, L_rw, 2))
                     * ds8[st][..., None], axis=1)
    obs = true + rng.normal(0, loc8, true.shape)
    mu_rw, _ = refine.position_refinement({str(L_rw): obs}, loc8, ds8,
                                          [0.5, 0.5], tr8)
    rms_raw = float(np.sqrt(((obs - true) ** 2).mean()))
    rms_ref = float(np.sqrt(((mu_rw[str(L_rw)] - true) ** 2).mean()))
    log(f"phase 8: {n_rw} random walks of {L_rw} frames with known true "
        f"positions (fitted ds, LocErr {loc8:.4g}): RMS error raw "
        f"{rms_raw:.5f}, refined {rms_ref:.5f} (for reading, not a gate)")

    # K6 time at 2^20 tracks, T=10, W=7; the plain version on all of them,
    # in the chunks refine_plain makes (its mixture bounds their size)
    tr_b = tables.transition_matrix(torch.tensor([[0.0, 0.1], [0.1, 0.0]],
                                                 **f32))
    lt_b = tables.cap_log(tr_b)
    sig2_b = torch.tensor([0.0, 2 * 0.08 * 0.02], **f32)
    l2_b = torch.full((1, 1, 1), 0.02 ** 2, **f32)
    tabs8 = [t.contiguous() for t in (
        *refine_kernel.build_refine_tables(lt_b, sig2_b, 7)[:2],
        *refine_kernel.build_refine_tables(lt_b.T, sig2_b, 7)[:2],
        refine_kernel.build_refine_tables(lt_b, sig2_b, 7)[2])]
    args8 = [(b.positions.contiguous(), b.lengths.contiguous(),
              l2_b.expand(b.positions.shape).contiguous()) for b in bench]

    def k6_run():
        for pos_, lens_, l2_ in args8:
            refine_kernel.launch(pos_, lens_, l2_, tabs8, 2)

    def k6_wrapped():
        for b in bench:
            refine_kernel.refine(b.positions, b.lengths, l2_b, lt_b, sig2_b,
                                 window=7)

    def p6_run(n=None):
        with torch.no_grad():
            for b in bench:
                refine_kernel.refine_plain(b.positions[:n], b.lengths[:n],
                                           l2_b, lt_b, sig2_b, window=7)

    ms6, wms6 = cuda_ms(k6_run, 5), cuda_ms(k6_wrapped, 3)
    p6_run(REFINE_PLAIN_WARMUP)         # warm-up on the first tracks only
    pms6 = cuda_ms(p6_run, 1, warmup=0)
    kinfo["K6"]["ms"], kinfo["K6"]["plain_ms"] = ms6, pms6
    kinfo["K6"]["wrapper_ms"] = wms6
    kinfo["K6"]["bound_ms"], kinfo["K6"]["bound_by"] = bound(
        4 * rows + 4 * n_bench,
        walk_ops(bench_lens, 128, 2, 2, "K6", S=2))
    log(f"phase 8: K6 {n_bench} tracks ({len(bench)} buckets), W=7: kernel "
        f"{ms6:.3f} ms = {n_bench / ms6 * 1e3 / 1e6:.3f}M tracks/s (with "
        f"its wrapper {wms6:.3f} ms); plain {pms6:.3f} ms on all "
        f"{n_bench} tracks; "
        f"bound {kinfo['K6']['bound_ms']:.4f} ms "
        f"({kinfo['K6']['bound_by']}) [{card}]")
    # ---- phase 9: K7 -------------------------------------------------------
    TOPK_CHUNK = histograms.TOPK_CHUNK
    for S, n, M, D, B, T, per_peak, kind in TOPK_CASES:
        pos, lens, isbl, tb9 = parity_case(S, 0, n, 600 + S * 10 + M + T,
                                           dev, B=B, T=T, D=D,
                                           per_peak=per_peak)
        kw9 = dict(max_nb_states=M, min_len=2, nb_substeps=n)
        tag = (f"phase 9: K7 S={S} n={n} M={M} D={D} B={B} T={T} "
               f"per-peak={per_peak}")
        raw = topk_kernel.backpointers(pos, lens, isbl, tb9, **kw9)
        raw2 = topk_kernel.backpointers(pos, lens, isbl, tb9, **kw9)
        h = topk_kernel.segment_topk(pos, lens, isbl, tb9, **kw9)
        again = topk_kernel.segment_topk(pos, lens, isbl, tb9, **kw9)
        h0 = topk_kernel.segment_topk_plain(pos, lens, isbl, tb9, **kw9)
        L = lens.cpu().numpy()
        errs["K7"].append(check_hist(tag, h, h0, float(L[L >= 2].sum()),
                                     topk_tol(kind, h0), "K7"))
        if not (all(torch.equal(a, b_) for a, b_ in zip(raw, raw2))
                and torch.equal(h, again)):
            fail(f"K7 gave two results for one input at {tag}")
        if kind == "unpruned":
            raw0 = histograms.segment_backpointers(pos, lens, isbl, tb9,
                                                   **kw9)
            same, count = live_backpointers_equal(raw, raw0, S ** (n + 1))
            e_w = float((raw[2] - raw0[2]).abs().max())
            ok = same and torch.allclose(raw[2], raw0[2],
                                         **TOL_TOPK_UNPRUNED)
            log(f"{tag}: raw parents and states equal on {count} live "
                f"slots: {same}; w_final max_abs_err {e_w:.3e} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"K7 backpointers differ from the plain version at {tag}")
        if kind == "prefix":
            par0, st0, w0 = histograms.segment_backpointers(pos, lens, isbl,
                                                            tb9, **kw9)
            ok = (torch.equal(raw[0].long(), par0)
                  and torch.equal(raw[1], st0)
                  and torch.allclose(raw[2], w0, **TOL_TOPK_UNPRUNED))
            log(f"{tag}: raw parents and states equal on all "
                f"{par0.numel()} slots, live and unused: {ok}")
            if not ok:
                fail(f"K7 backpointers differ from the plain version at {tag}")

    # the top-K main path, through the default entry point
    reset_counts()
    t0 = time.time()
    hist9 = histograms.len_hist(tracks, values, 0.02, cell_dims=(0.5,),
                                nb_states=2, engine="topk")
    t_topk = time.time() - t0
    k7, plain = topk_kernel.LAUNCHES, plain_calls()
    want_k7 = sum(-(-b.batch_size // TOPK_CHUNK) for b in pbuckets)
    log(f"phase 9: len_hist(engine='topk') on {n_tr} tracks (M=512) "
        f"{t_topk:.2f} s; K7 launches {k7} (want {want_k7}), plain calls "
        f"{plain} [{card}]")
    if k7 != want_k7 or plain != 0:
        fail(f"top-K main path K7 launches {k7} (want {want_k7}), plain "
             f"calls {plain}")
    kinfo["K7"]["launches"] = k7
    summed = np.zeros_like(hist9)
    for b in pbuckets:
        h = topk_chunks(b, 512, topk_kernel.segment_topk, tbf, min_len)
        h0 = topk_chunks(b, 512, topk_kernel.segment_topk_plain, tbf,
                         min_len)
        L = data.host_lengths(b)
        errs["K7"].append(check_hist(
            f"phase 9: bucket T={b.max_len} B={b.batch_size}", h, h0,
            float(L[L >= 2].sum()), topk_tol("large", h0), "K7"))
        summed[:b.max_len] += h.double().cpu().numpy()
    counted = float((hist9 * np.arange(1, hist9.shape[0] + 1)[:, None]).sum())
    ok = (np.array_equal(summed, hist9)
          and abs(counted - frames) <= TOL_FRAMES * frames)
    log(f"phase 9: len_hist = the sum of its buckets' K7 histograms: "
        f"{np.array_equal(summed, hist9)}; frames {counted:.1f} of {frames} "
        f"(rel {abs(counted - frames) / frames:.2e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("len_hist(engine='topk') differs from its buckets or loses "
             "frames")
    log("phase 9: segments of length l, state 0 / state 1, top-K (M=512) vs "
        "window (W=7) engine (for reading, not a gate):")
    for ln in range(1, min(10, hist9.shape[0]) + 1):
        log(f"  l={ln:2d}: {hist9[ln - 1, 0]:10.1f} / {hist9[ln - 1, 1]:10.1f}"
            f"   window {hist[ln - 1, 0]:10.1f} / {hist[ln - 1, 1]:10.1f}")

    # 3 states: the window engine's default (K = 3^7 > 1024) raises, the
    # top-K engine runs through K7
    tr3 = np.full((3, 3), 0.05) + np.eye(3) * 0.85
    tracks3, _, _ = simulate.sim_fov(
        nb_tracks=20_000, max_track_len=20, min_track_len=3, LocErr=0.02,
        Ds=(0.0, 0.02, 0.1), TrMat=tr3, dt=0.02, pBL=0.1, cell_dims=(0.5,),
        seed=3)
    values3 = {"LocErr": 0.02, "D0": 0.0, "D1": 0.02, "D2": 0.1,
               "F0": 1 / 3, "F1": 1 / 3, "F2": 1 / 3, "pBL": 0.1,
               **{f"p{i}{j}": 0.05 for i in range(3) for j in range(3)
                  if i != j}}
    try:
        histograms.len_hist(tracks3, values3, 0.02, cell_dims=(0.5,),
                            nb_states=3)
        fail("len_hist at 3 states, window 7, did not raise")
    except NotImplementedError as e:
        log(f"phase 9: 3 states, window engine: raises ({str(e)[:90]}...)")
    buckets3 = data.from_dict_bucketed(tracks3, max_buckets=4, device=dev,
                                       dtype=torch.float32)
    reset_counts()
    t0 = time.time()
    hist3 = histograms.len_hist(tracks3, values3, 0.02, cell_dims=(0.5,),
                                nb_states=3, engine="topk")
    t3 = time.time() - t0
    k7_3, plain = topk_kernel.LAUNCHES, plain_calls()
    n3 = sum(b.batch_size for b in buckets3)
    frames3 = sum(int(k) * len(v) for k, v in tracks3.items())
    counted3 = float((hist3 * np.arange(1, hist3.shape[0] + 1)[:, None]
                      ).sum())
    want3 = sum(-(-b.batch_size // TOPK_CHUNK) for b in buckets3)
    ok = (k7_3 == want3 and plain == 0 and np.isfinite(hist3).all()
          and abs(counted3 - frames3) <= TOL_FRAMES * frames3)
    log(f"phase 9: len_hist(nb_states=3, engine='topk') on {n3} tracks "
        f"{t3:.2f} s: K7 launches {k7_3} (want {want3}), plain calls "
        f"{plain}, frames {counted3:.1f} of {frames3} "
        f"{'ok' if ok else 'FAIL'} [{card}]")
    if not ok:
        fail("the 3-state top-K path did not run through K7 or lost frames")

    # K7 times at 2^20 tracks: bare launches on prepared inputs (the output
    # buffers reused across the chunks), through segment_topk (with the
    # decode), the plain version at T=10, M=512
    def topk_times(bench9, M9, reps):
        return (cuda_ms(topk_bare(bench9, tb, M9, dev), reps),
                cuda_ms(topk_wrapped(bench9, tb, M9), 2))

    ms7, wms7 = topk_times(bench, 512, 5)
    log(f"phase 9: K7 {n_bench} tracks ({len(bench)} buckets, T=10), M=512: "
        f"kernel {ms7:.3f} ms = {n_bench / ms7 * 1e3 / 1e6:.4f}M tracks/s "
        f"(through segment_topk {wms7:.3f} ms) [{card}]")

    def p7_run(n=None):
        with torch.no_grad():
            for b in bench:
                k = b.batch_size if n is None else n
                sub = data.TrackBatch(b.positions[:k], b.lengths[:k],
                                      is_bleached=b.is_bleached[:k])
                topk_chunks(sub, 512, topk_kernel.segment_topk_plain, tb)

    p7_run(1024)                        # warm-up on the first tracks only
    pms7 = cuda_ms(p7_run, 1, warmup=0)
    keys = torch.randn((n_bench, 1024), device=dev)
    tk_ms = cuda_ms(lambda: torch.topk(keys, 512, dim=1), 3)
    del keys
    # bound: what the function needs, positions and l2 (and lengths and
    # isBL) in, the histogram rows out, the live rows' work (topk_ops);
    # the count of all M rows (``walk_ops``, the backpointers out) beside it
    def k7_bounds(bench9, lens9, M9):
        rows_in = sum(2 * b.positions.numel() * 4 + 8 * b.batch_size
                      for b in bench9)
        new = bound(rows_in + sum(b.batch_size * b.max_len * 2 * 4
                                  for b in bench9),
                    topk_ops(lens9, M9, 2, 2, 4))
        old = bound(rows_in + sum(b.batch_size * M9 * (4 + 3 * (b.max_len
                                                                - 1))
                                  for b in bench9),
                    walk_ops(lens9, M9, 2, 2, "K7"))
        return new, old

    (b7, by7), (b7_old, by7_old) = k7_bounds(bench, bench_lens, 512)
    kinfo["K7"]["ms"], kinfo["K7"]["plain_ms"] = ms7, pms7
    kinfo["K7"]["wrapper_ms"] = wms7
    kinfo["K7"]["bound_ms"], kinfo["K7"]["bound_by"] = b7, by7
    log(f"phase 9: K7 plain version on all {n_bench} tracks (chunks of "
        f"{TOPK_CHUNK}) {pms7:.3f} ms; bound {b7:.4f} ms ({by7}; live "
        f"rows, histogram rows out), all-rows count {b7_old:.4f} ms "
        f"({by7_old}; all M rows, backpointers out); torch.topk(k=512) of "
        f"one step's ({n_bench}, 1024) scores {tk_ms:.3f} ms (for reading: "
        f"the selection only) [{card}]")
    del bench
    bench30 = bench_buckets(dev, T=30)
    ms30, wms30 = topk_times(bench30, 128, 3)
    lens30 = np.concatenate([data.host_lengths(b) for b in bench30])
    (b30, by30), (b30_old, by30_old) = k7_bounds(bench30, lens30, 128)
    log(f"phase 9: K7 {n_bench} tracks ({len(bench30)} buckets, T=30), "
        f"M=128: kernel {ms30:.3f} ms (through segment_topk {wms30:.3f} "
        f"ms); bound {b30:.4f} ms ({by30}), all-rows count {b30_old:.4f} ms "
        f"({by30_old}) [{card}]")

    for k in kinfo:
        kinfo[k]["max_abs_err"] = max(errs[k])
    log(card)
    log(json.dumps({"kernels": list(kinfo.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
