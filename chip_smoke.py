#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # every phase, one card

Phases (each prints its lines; a failed check exits non-zero):

0. toolchain: torch / CUDA versions, nvcc, the card's name and power limit,
   the kernel build time (one nvcc per source, in parallel) and nvcc's
   register / spill report, which fails the run on a spill in any K1, K4,
   K5 or K6 instantiation of up to 512 threads, constant or variable dt
   (K5's variable-dt instantiations listed with their spill bytes, and
   the 21 instantiations of the wide mapping with their registers and
   spill bytes);
1. K1 (csrc/forward.cu) against its plain version ``forward_plain`` in f32
   on the card, three register configurations, ~3000 tracks each, then on
   both of its mappings (the warp mapping at K = 8, 16, 32, 64 and the
   wide mapping at the same K and at K = 243);
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
   five configurations (T=2 rows, 0/1-frame rows, per-peak LocErr, K = 8
   to 512), through ``predict`` and then on each of its mappings (a warp
   per track up to 64 slots, a block per track at any K) with its stash
   of fusion weights in shared memory and in global scratch; then the
   annotation main path, ``predict.predict_Bs`` on the 10^5 tracks with
   the fitted parameters, with its K4 launch count, each bucket against
   the plain version, and the share of frames whose most probable state
   is the simulated one; K4's time at 2^20 tracks (T=10, W=5, S=2),
   launched on prepared inputs and through ``predict_kernel.predict``;
7. K5 (csrc/hist.cu): the histogram against ``hist_plain`` at seven
   configurations with a forbidden transition (3 states, per-peak LocErr,
   T=2 and 0/1-frame rows, D = 1 and 3, rows in global scratch), twice
   for repeatability; then the histogram main path,
   ``histograms.len_hist`` on the 10^5 tracks with the fitted parameters
   (window 7, 4 length buckets), with its K5 launch count, each bucket
   against the plain version, frame conservation, and the simulated
   states' histogram beside it; then K5 at two sub-steps a frame against
   the plain version in float64 (S=2 at windows of 4 and 5 frames, K =
   128 and 512; S=3 at 3 frames, K = 243) and
   ``len_hist(nb_substeps=2, window=4)`` on the 10^5 tracks (its K5
   launches, each bucket against the plain version, frame conservation);
   K5's time at 2^20 tracks (T=10, W=7 sub-steps, S=2) at one and at two
   sub-steps a frame, launched on prepared inputs and through
   ``hist_kernel.hist``;
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
   version's time on the first quarter of each bucket (in the chunks
   ``refine_plain`` makes), with the SFU floor beside the bound (one
   rsqrt and one exp2 per pair at 16 a clock per SM); then a 3-state
   ``position_refinement`` at the JAX package's default window (tracks of
   up to 9 frames: W=6, K=729), its time, launches and each bucket's
   first tracks against the plain version;
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
   and the window engine's histogram beside it; on 3-state tracks
   ``len_hist`` at its default window 7 (K = 2187, K5's wide mapping: each
   bucket against the plain version, frames conserved) and
   ``len_hist(engine="topk")``; K7's time
   at 2^20 tracks (T=10 with M=512, T=30 with M=128), launched on prepared
   inputs and through ``topk_kernel.segment_topk``, both with the decode
   fused in, the plain version's time on the 2^20 tracks at T=10, M=512,
   and, for reading, ``torch.topk`` on one step's (2^20, 1024) scores;
   K7's bound as the live register needs it (``topk_ops``) beside the
   count of all M rows;
10. variable dt (K1..K5 reading the streamed (B, T-1, P) displacement
   variances): K1's logL, K2's value and every table gradient (the
   stream's, through ``sig2``, included), K3's Hessian-vector products and
   K4's posteriors against their plain versions in float64 (on the same
   float32 inputs) at phases 1-2's six
   configurations (2 states at W=6, 3 at W=5, two sub-steps, D = 1 and 3,
   a T = 2 bucket, ragged lengths with padded dt tails), each with a
   per-step (T-1, P) and a per-track (B, T-1, P) table (per-track only at
   T = 2, where a per-step table is one row: a constant dt), K2's stream
   cotangent exactly 0 past each track's length, K3's Hessian columns on
   per-track dt buckets, a stream of a constant dt against the
   constant-dt kernels, and K5's histogram per step and per track at one
   and two sub-steps a frame (K = 128 and 243); then the mixed-frame-rate
   main path: ``sim_fov``
   at dt 0.02 (seed 0) and 0.05 (seed 1), 25,000 tracks each, merged into
   one length-keyed dict with a per-track dt dict; per bucket the
   objective's value and z-gradient against the plain version; then
   ``fit.param_fitting(dt=dt_dict, compute_errors=True)`` with its K2 and
   K3 launch counts, a value-only objective (K1), and
   ``predict.predict_Bs(dt=dt_dict)`` with its K4 launches and
   ``histograms.len_hist(dt=dt_dict)`` (window 7) with its K5 launches,
   each bucket against the plain version (the histogram's frames
   conserved); the variable-dt kernels' times at the bench shape with
   per-track dt uniform in 0.01..0.03, bare and through their wrappers,
   beside their plain versions and the constant-dt times;
11. past 1024 register slots (K1, K4, K5 and K6 on their wide mapping, a
   thread a fusion group): the README workflow at 3 states and the JAX
   package's defaults on ~5 x 10^4 ``sim_fov`` tracks (``param_fitting(
   compute_errors=True)`` from a rough guess of the Ds, its fitted Ds held
   to the simulated ones, ``predict_Bs``, ``len_hist`` at window 7 with
   K = 2187, ``position_refinement``), a value-only objective at window 7
   (K1), ``predict_Bs`` at 5 states and frame_len 5 (K4, K = 3125) and
   ``position_refinement`` of 6-state 1-D tracks of 3-5 frames at the
   default window 4 (K6, K = 1296), each with its launches, 0 plain calls,
   its wall time and its buckets' first tracks against the plain version;
   then each wide kernel's bare time on 2^16 random walks of lengths
   3..10 (K6 on 2^14), beside its bound and its plain version's time;
12. past 4096 register slots (K4 and K5 on the wide mapping, the carries
   in global scratch where a block's shared memory cannot hold them), at
   the JAX package's defaults on 2^12-2^13 ``sim_fov`` tracks each:
   ``len_hist`` at 4 states (K = 16384) and at two sub-steps a frame
   (K = 8192), ``predict_Bs`` at 6 states (K = 7776), each with its
   launches, 0 plain calls, its wall time and each whole bucket against
   its plain version; at 3 states ``tracking.Proba_Cs`` (K1) and
   ``refine.get_best_estimates`` (K4 at K = 6561); then the three
   kernels' bare times on 2^12-2^13 random walks beside their bounds and
   plain versions (one unwarmed pass of the plain version);
13. simulate -> fit -> sample on the card: ``simulate.sim_fov_batch`` at
   the main path's model and 10^6 requested tracks (its wall time, batch
   invariants and length histogram against phase 3's host ``sim_fov``),
   ``fit.fit(compute_errors=True)`` on those batches (D1 and LocErr held
   to the simulated ones, K2 and K3 launches), a ~10^4-track subset's
   warm-start fit with error bars, then ``sample.sample_posterior`` from it
   with its Fisher errors (acceptance, step size, R-hat, ESS, the
   posterior of D1 against the 10^6-track fit's and the Fisher error, K2
   launches against the sampler's formula with 0 plain calls, the wall
   time per iteration against bare K2 time x launches); K2 at the
   sampler's buckets against the plain version (at the fit's start), the
   kernel launches and heaviest host operations of one gradient of the
   HMC potential (``torch.profiler``), the potential's value and
   z-gradient against the plain version in float64, the samples at
   ``dispatch_chunk`` 4 and 10000 bit for bit, and
   ``simulate.brownian_frames`` on 2^20 x 10 frames (time, moments);
14. the user's entry points on phase 3's tracks, written to a CSV:
   ``io.readers.read_table`` with the native parser and with pandas (each
   timed, the two dicts equal), ``pipeline.analyze`` from the CSV with CSV
   and XML export (the launches of K2, K4, K5 and K6 with 0 plain calls,
   its fitted values against phase 3's fit, its posteriors, histogram and
   refined positions against the drivers called directly), the CLI in
   subprocesses (``python -m extrack_tpu_torch.cli -v``: ``fit`` with its
   K2 and K3 launches, ``predict``, ``histogram`` and ``refine`` against
   ``analyze``'s results, ``sample`` on every 9th track, each timed),
   ``auto_fitting.model_selection`` at 2 and 3 states and a headless
   ``gui.Session``'s four runners on that subset, and
   ``utils.observe.trace`` around ``predict_Bs``, whose Chrome trace must
   name K4's kernel.
15. the sharded paths (``extrack_tpu_torch.parallel``): on a mesh of the
   one card, ``param_fitting(compute_errors=True)``, ``predict_Bs``,
   ``len_hist`` and ``position_refinement`` with ``sharded=True`` on phase
   3's tracks, bit for bit against phase 3's fit and the unsharded drivers
   (K2..K6 launches, no plain call); two gloo processes sharing the card
   (``phase15_rank``), each reading the tracks from a CSV and keeping its
   ``process_slice`` through ``global_batch``: the sharded objective at
   phase 3's optimum, a sharded fit with error bars (the two processes
   bit for bit alike; against phase 3 by phase 14's rule and
   TOL_STD_ERR) and the three post-fit drivers against the unsharded
   ones; NCCL at world size 1 on every SUBSET_STRIDE-th track against the
   in-process sharded fit.  The three processes run beside the
   in-process part; their wall time is printed, and is not a speed.

Every kernel's ``bound_ms`` is the larger of the bytes it must move (each
input read once, each output written once) over 3.35 TB/s and the
operations its walk does on this run's lengths (``walk_ops``) over
67 TFLOP/s f32 (one H100 SXM's published peaks at 700 W); a variable-dt
variant also reads its (B, T-1, P) stream (and K2 and K3 write its
cotangent).

The line before the last is a JSON object describing each kernel: ``ms``
is the bare launches' time, ``wrapper_ms`` the same work through the
wrapper a caller uses (``forward``, ``value_and_table_grads``,
``table_hvp``, ``predict``, ``hist``, ``refine``, ``segment_topk``), host
work included; ``plain_ms`` the plain version's time, on the same tracks
as ``ms`` unless ``plain_tracks`` counts fewer (K3, K6, K3 with variable
dt and the wide kernels time the first 1/PLAIN_SHARE of each bucket);
the last
line is ``{"ok": true, "device": {...}}``.  Exits non-zero without output of
a result when no CUDA device is present.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

TOL_K1 = dict(rtol=2e-5, atol=2e-4)     # per-track logL, f32 vs f32 plain
TOL_K2_VALUE = dict(rtol=2e-5, atol=0.0)
TOL_K2_GRAD = dict(rtol=2e-3, atol=2e-3)
# phase 10: a cotangent with an entry per track (a per-track sig2 table, a
# per-peak l2) is a sum of per-slot terms as large as the field's largest
# entry that cancel; their f32 rounding adds this fraction of max|ref| to
# the absolute tolerance (the plain version in f32 rounds them as much)
TOL_K2_TRACK_FLOOR = 2e-6
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
# (S, W): K1 and K2 on each of their mappings, K = 8, 16, 32, 64 (warp
# and K1's wide / K2's block) and K = 243 (K1 wide, K2 block)
MAPPING_CASES = [(2, 3), (2, 4), (2, 5), (2, 6), (3, 5)]
# K3: (S, W, nb_substeps, per-peak LocErr), 1500 tracks of T <= 10 in two
# buckets, p01 fixed at 0 (a forbidden transition) in every case
HVP_CASES = [(2, 6, 1, False), (2, 4, 2, False), (3, 5, 1, True),
             (4, 4, 1, False)]
HVP_TRACKS = 1500
# K4: (S, W, D, B, T, per-peak LocErr); K = 32, 81, 8, 8 and 512
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
# K5 past one sub-step (phase 7) and with variable dt (phase 10), against
# the plain version in float64 on the same inputs: (S, frames in the
# window, sub-steps a frame); K = 128, 512, 243 at two sub-steps, and
# with variable dt K = 128 and 243 at one and at two
HIST_SUB_CASES = [(2, 4, 2), (2, 5, 2), (3, 3, 2)]
HIST_DT_CASES = [(2, 7, 1), (3, 5, 1), (2, 4, 2), (3, 3, 2)]
# K6: the same fields; odd K (S=3), 4 states, and a stash in global scratch
# last
REFINE_CASES = [(2, 7, 2, 1001, 10, False), (3, 5, 2, 1001, 10, False),
                (4, 4, 2, 1001, 10, False), (2, 5, 2, 3001, 10, True),
                (2, 4, 2, 257, 2, True), (2, 5, 1, 301, 12, False),
                (2, 4, 3, 301, 12, False), (2, 8, 2, 32, 60, True)]
REFINE_CHECK = 4096           # main-path tracks per bucket held to plain
REFINE3_CHECK = 256           # 3-state (K=729) tracks per bucket held to plain
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
# phase 10's mixed frame rates: two movies of SIM's cells, at 50 and 20
# frames a second (25,000 requested tracks each since the entry points'
# phase was added: the host simulator took 15 s for 2 x 50,000)
SIM_DT = [dict(SIM, nb_tracks=25_000, dt=0.02, seed=0),
          dict(SIM, nb_tracks=25_000, dt=0.05, seed=1)]
# phase 11: the wide mapping's paths.  The README workflow at 3 states
# (phase 9's model: Ds 0, 0.02, 0.1; 0.85 + 0.05 on the diagonal), 5
# states annotated at frame_len 5, 6 states refined on 1-D tracks of 3-5
# frames, each at the JAX package's defaults (K = 2187, 3125, 1296)
TR3 = np.full((3, 3), 0.05) + np.eye(3) * 0.85
SIM3 = dict(SIM, nb_tracks=50_000, Ds=(0.0, 0.02, 0.1), TrMat=TR3, seed=5)
# the 3-state fit's start: param_fitting's own parameters but for a rough
# guess of the Ds.  From param_fitting's default start (Ds 0, 0.375, 1.5)
# L-BFGS-B stops after 4 evaluations at D2 ~ 1.2, in the JAX package
# alike (tests/test_torch_fit.py); from this one both converge
FIT3_START = dict(nb_states=3, LocErr_type=1, LocErr_bounds=(0.005, 0.1),
                  D_max=3.0, estimated_Ds=[0.001, 0.01, 0.2],
                  estimated_transition_rates=0.1)
# the fitted Ds against SIM3's: D1 and D2 within this share, D0 below this
# share of D1
TOL_FIT3_D = 0.1
TR5 = np.full((5, 5), 0.03) + np.eye(5) * 0.85
SIM5 = dict(SIM, nb_tracks=20_000, Ds=(0.0, 0.01, 0.03, 0.06, 0.1),
            TrMat=TR5, seed=6)
TR6 = np.full((6, 6), 0.02) + np.eye(6) * 0.88
SIM6 = dict(SIM, nb_tracks=50_000, max_track_len=5, nb_dims=1,
            Ds=(0.0, 0.005, 0.01, 0.02, 0.05, 0.1), TrMat=TR6, seed=7)
WIDE_CHECK = 1024             # tracks per bucket held to the plain version
# (kernel, S, W, D): the bare times of the wide kernels at the main paths'
# registers, on WIDE_TRACKS random walks of lengths 3..10 (K6: 2^14, its
# plain version's chunks are small)
WIDE_TIMES = [("K1 wide", 3, 7, 2), ("K4 wide", 5, 5, 2),
              ("K5 wide", 3, 7, 2), ("K6 wide", 6, 4, 1)]
WIDE_TRACKS = 1 << 16
WIDE_K6_TRACKS = 1 << 14
WIDE_PLAIN_CHUNK = 1 << 12    # the plain versions carry K*(T or (1+S)T)
# phase 12: past 4096 slots at the JAX package's defaults, 2^12-2^13
# tracks each: len_hist at 4 states (K = 4^7) and at two sub-steps a frame
# (2 states, K = 2^13), predict_Bs at 6 states (K = 6^5) on 2-D tracks,
# and phase 11's 3-state model for Proba_Cs and get_best_estimates
TR4 = np.full((4, 4), 0.04) + np.eye(4) * 0.84
SIM4 = dict(SIM, nb_tracks=4096, Ds=(0.0, 0.01, 0.04, 0.1), TrMat=TR4,
            seed=8)
SIM2N = dict(SIM, nb_tracks=4096, seed=9)
SIM6P = dict(SIM, nb_tracks=4096, Ds=SIM6["Ds"], TrMat=TR6, seed=10)
SIM3B = dict(SIM3, nb_tracks=8192, seed=11)
PAST_PLAIN_CHUNK = 512        # the plain versions past 4096 slots
BEST_CHECK = 64               # get_best_estimates' tracks run on the CPU
# (kernel, S, W, nb_substeps, tracks): bare times at phase 12's registers
PAST_TIMES = [("K4 past 4096", 6, 5, 1, 1 << 13),
              ("K5 past 4096", 4, 7, 1, 1 << 12),
              ("K5 n=2 past 4096", 2, 13, 2, 1 << 12)]
# phase 13: the main path's model simulated on the card at 10^6 requested
# tracks; the fit's D1 and LocErr within tests/test_simulate_device.py's
# tolerances of the simulated ones
SIM_DEV = dict(SIM, nb_tracks=1_000_000)
TOL_SIM_FIT = {"D1": 0.015, "LocErr": 0.005}
# the sampler's subset and budget (2 chains, 2 length buckets: at 10^4
# tracks a gradient is ~40 ms of host work over 4 buckets against 0.6 ms
# of K2, so the run is sized to about 30 s on an H100), its R-hat bound
# and the posterior checks: the mean
# of D1 within SAMPLE_SDS posterior sds of the 10^6-track fit's D1, the
# sd within a factor SAMPLE_SDS of the warm-start fit's Fisher error
SAMPLE_TRACKS = 10_000
SAMPLE_KW = dict(num_chains=2, num_warmup=40, num_samples=60, n_leapfrog=6,
                 max_buckets=2, seed=0)
RHAT_MAX = 1.3
SAMPLE_SDS = 4.0
PROFILE_EVALS = 5             # gradients under torch.profiler
# dispatch_chunk invariance at a tiny size
CHUNK_TRACKS = 500
CHUNK_KW = dict(num_chains=2, num_warmup=6, num_samples=7, n_leapfrog=3,
                max_buckets=1, seed=5)
BROWNIAN = dict(nb_tracks=1 << 20, track_len=10, Ds=(0.0, 0.08),
                Fs=(0.5, 0.5), tr_mat=[[0.9, 0.1], [0.1, 0.9]], loc_err=0.02,
                dt=0.02)
# phase 14, the user's entry points on phase 3's tracks: the native
# parser's positions against pandas' (its decimal conversion is not
# correctly rounded: ~1e-13 relative on 10^6 localizations), analyze's
# and the CLI's fits against phase 3's (relative, or a tenth of phase 3's
# standard error where that is larger), every SUBSET_STRIDE-th track for
# the CLI's sampler, model selection and the GUI session, and the
# sampler's budget there
TOL_NATIVE_REL = 1e-12
TOL_ANALYZE_FIT = 1e-4
SUBSET_STRIDE = 9
CLI_SAMPLE = ["--samples", "10", "--warmup", "10", "--chains", "2",
              "--n-leapfrog", "3"]
BENCH_DT = (0.01, 0.03)       # phase 10's per-track intervals at the bench
FIT_ITERS = 200
BENCH_TRACKS = 1 << 20
# the heaviest plain versions (K3 and K6 at the bench shape, K3 with
# variable dt, the wide kernels: 4-30 s a pass) are timed on the first
# 1/PLAIN_SHARE of each bucket's tracks; their entries' ``plain_tracks``
# counts them (null: the plain version ran on the same tracks as ``ms``)
PLAIN_SHARE = 4
PLAIN_CHUNK = 1 << 17         # tracks per plain autograd call (memory)
PLAIN_HVP_CHUNK = 1 << 15     # double backward keeps ~3x more per track
PLAIN_HIST_CHUNK = 1 << 16    # the plain histogram carries ~4K*(1+S)*T
HESS_CHUNK = 1 << 14          # hessian_chunked on the main path
PEAK_FLOPS = 67e12            # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


_T0 = time.time()


def log(msg: str):
    """Print a line with the seconds since the script started."""
    print(f"[{time.time() - _T0:7.1f} s] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def parity_case(S, W, n, seed, dev, B=3001, T=10, D=2, per_peak=False,
                dt=None):
    """Random tracks (lengths 2..T, isBL on) and f32 tables with one
    forbidden transition, built on ``dev``.  ``dt`` "step" or "track":
    variable dt, a (T-1,) or (B, T-1) table of intervals uniform in
    0.01..0.05 (a track's steps from its length on at the median, as
    data.from_dict pads them); else 0.02."""
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
    dts = 0.02
    if dt is not None:
        rng_dt = np.random.default_rng(seed + 7)
        d = rng_dt.uniform(0.01, 0.05, (B, T - 1) if dt == "track"
                           else T - 1)
        if dt == "track":
            d[np.arange(T - 1)[None, :] >= lengths[:, None] - 1] = (
                np.median(d))
        dts = torch.tensor(d, **f32)
    tb = tables.build_tables(Ds, torch.tensor(0.02, **f32), Fs, rates,
                             torch.tensor(0.1, **f32), dts,
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


def bench_buckets(dev, T=10, seed=0, lo=3, dt_range=None, n=BENCH_TRACKS,
                  D=2):
    """``n`` 2-state random walks in D dimensions, lengths lo..T,
    length-bucketed on ``dev``; with ``dt_range`` (lo, hi) each track's
    intervals are drawn uniform in it (a per-track dt dict, from its own
    seed), else none."""
    from extrack_tpu_torch import data
    rng = np.random.default_rng(seed)
    lengths = rng.integers(lo, T + 1, n)
    tracks = {}
    for L in range(lo, T + 1):
        nb = int((lengths == L).sum())
        state = rng.integers(0, 2, (nb, 1, 1))
        sig = np.where(state == 1, math.sqrt(2 * 0.08 * 0.02), 1e-4)
        steps = rng.normal(0, 1, (nb, L, D)) * sig
        tracks[str(L)] = (steps.cumsum(1)
                          + rng.normal(0, 0.02, (nb, L, D))).astype(np.float32)
    dts = None
    if dt_range is not None:
        rng_dt = np.random.default_rng(seed + 1)
        dts = {k: rng_dt.uniform(*dt_range, (v.shape[0], v.shape[1] - 1))
               for k, v in tracks.items()}
    return data.from_dict_bucketed(tracks, max_buckets=4, dt=dts, device=dev,
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
    the update at L-1 and the harvest (the posteriors of the frames that
    left the window carried back through their fusions' weights, linear
    in the length, rather than the engine's history mix).  K5 runs L-2
    fusions (A = S^n children a group), each fusion group mixing its A
    members' (1+S)*min(t+1, T) run/hist bins at step t, 2 per bin and
    member (where the oldest frame drops, the run mixes the A/S members
    whose run goes on and the histogram adds the (S-1)A/S whose run ends:
    A members a bin all the same), and a harvest of 4 per slot and bin.
    K6 runs 2(L-2) transition-only
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
            ops += float((L - 2 >= t).sum()) * (step + G * A * 2 * bins)
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
    # K4: one more fusion and update per track and the harvest: the
    # softmax (3 a slot), one add a slot for each frame still in the window
    # and, for each frame that left it, the weights carried back through
    # that frame's fusion (group sums, member masses and their sums by
    # state: 3 a slot)
    harvest = float((K * (3 + np.minimum(L, W)
                          + 3 * np.maximum(L - W, 0))).sum())
    return fwd + float((L >= 3).sum()) * (step + K * 14 * D) + harvest


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


def sfu_ms(mufu_ops: float, dev) -> float:
    """The least time the card's special-function units take for
    ``mufu_ops`` results: 16 a clock per SM (sm_90) at the top SM clock."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return mufu_ops / (16 * sms * mhz * 1e6) * 1e3


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over the card's memory
    rate and operations over its f32 rate."""
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def float64(pos, isbl, tb):
    """Float64 copies of a case's positions, flags and tables: the plain
    version's inputs where it is the float64 reference (phase 10)."""
    from extrack_tpu_torch.core import tables
    return (pos.double(), isbl.double(),
            tables.ModelTables(*(f.double() for f in tb)))


def check_forward(tag, pos, lens, isbl, tb, ref64=False, **kw) -> float:
    """K1's per-track logL against ``forward_plain``'s at TOL_K1 (with
    ``ref64`` the plain version in float64 on the same inputs); prints one
    line, exits on a disagreement, returns the largest absolute error."""
    from extrack_tpu_torch.ops import forward_kernel
    got = forward_kernel.forward(pos, lens, isbl, tb, **kw)
    if ref64:
        p64, i64, tb64 = float64(pos, isbl, tb)
        want = forward_kernel.forward_plain(p64, lens, i64, tb64, **kw)
        got = got.double()
    else:
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


def check_table_grads(tag, pos, lens, isbl, tb, ref64=False, **kw) -> float:
    """K2's value and every table cotangent against the plain version's at
    TOL_K2_VALUE / TOL_K2_GRAD (with ``ref64`` the plain version in
    float64 on the same inputs); prints one line per table, exits on a
    disagreement, returns the largest absolute error."""
    from extrack_tpu_torch.ops import grad_kernel
    v, g = grad_kernel.value_and_table_grads(pos, lens, isbl, tb, **kw)
    if ref64:
        p64, i64, tb64 = float64(pos, isbl, tb)
        v0, g0 = grad_kernel.value_and_table_grads_plain(p64, lens, i64,
                                                         tb64, **kw)
        _, g32 = grad_kernel.value_and_table_grads_plain(pos, lens, isbl, tb,
                                                         **kw)
        v, g = v.double(), {k: x.double() for k, x in g.items()}
    else:
        v0, g0 = grad_kernel.value_and_table_grads_plain(pos, lens, isbl,
                                                         tb, **kw)
    torch.cuda.synchronize()
    ok = torch.allclose(v, v0, **TOL_K2_VALUE)
    worst = abs(float(v - v0))
    for name in g:
        scale = float(g0[name].abs().max())
        per_track = ref64 and g0[name].ndim == 3 and (
            g0[name].shape[0] == pos.shape[0] > 1)
        tol = dict(TOL_K2_GRAD, atol=TOL_K2_GRAD["atol"]
                   + (TOL_K2_TRACK_FLOOR * scale if per_track else 0.0))
        good = torch.allclose(g[name], g0[name], **tol)
        e = float((g[name] - g0[name]).abs().max())
        worst = max(worst, e)
        e32 = (float((g32[name].double() - g0[name]).abs().max())
               if ref64 else 0.0)
        also = (f"; plain f32 {e32:.3e}, atol {tol['atol']:.3e}" if ref64
                else "")
        log(f"{tag}: d/d{name} {tuple(g[name].shape)} max_abs_err {e:.3e} "
            f"(|ref|max {scale:.3e}{also}) {'ok' if good else 'FAIL'}")
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


def on_card(refined, dev):
    """``refine.refine_batch``'s numpy (mu, sigma, B) as (mu, sigma)
    tensors on ``dev``, for the checks against the plain version."""
    mu, sig, _ = refined
    return torch.as_tensor(mu, device=dev), torch.as_tensor(sig, device=dev)


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


def hvp_case(S, W, n, per_peak, dev, seed, T=10, dt=False):
    """Length-bucketed random tracks and a spec with p01 fixed at 0 (and
    an affine per-peak LocErr when ``per_peak``) for a K3 parity case;
    ``dt``: per-track intervals uniform in 0.01..0.05 (a dt dict)."""
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
    dts = None
    if dt:
        rng_dt = np.random.default_rng(seed + 1)
        dts = {k: rng_dt.uniform(0.01, 0.05, (v.shape[0], v.shape[1] - 1))
               for k, v in tracks.items()}
    buckets = data.from_dict_bucketed(
        tracks, max_buckets=2, input_loc_err=errs if per_peak else None,
        dt=dts, device=dev, dtype=torch.float32)
    spec = params.generate_params(
        nb_states=S, D_max=1.0, LocErr_type=4 if per_peak else 1,
        slope_offsets_estimates=(1.0, 0.001))
    spec.add("p01", 0.0, vary=False)
    kw = dict(cell_dims=(0.5,), nb_substeps=n, window=W, min_len=2,
              input_loc_err=per_peak)
    return buckets, spec, kw


def merged_movies(sims):
    """``sim_fov`` once per configuration of ``sims``, merged into one
    length-keyed dict of tracks, a per-track dt dict (each track's steps at
    its movie's dt) and the simulated states."""
    from extrack_tpu_torch import simulate
    tracks, dts, states = {}, {}, {}
    for cfg in sims:
        tr, st, _ = simulate.sim_fov(**cfg)
        for k, v in tr.items():
            d = np.full((v.shape[0], v.shape[1] - 1), cfg["dt"])
            tracks[k] = np.concatenate([tracks[k], v]) if k in tracks else v
            dts[k] = np.concatenate([dts[k], d]) if k in dts else d
            states[k] = (np.concatenate([states[k], st[k]]) if k in states
                         else st[k])
    return tracks, dts, states


def stream_zero_past_lengths(tag, pos, lens, isbl, tb, W, n) -> None:
    """K2's stream cotangent is exactly 0 in every row from a track's
    length on (and nonzero somewhere before); exits otherwise."""
    from extrack_tpu_torch.ops import forward_kernel, grad_kernel
    d, tabs = forward_kernel.kernel_inputs(pos, lens, isbl, tb, W, n)
    _, _, cts = grad_kernel.launch(d, [t.detach() for t in tabs], 2)
    T = pos.shape[1]
    dead = torch.arange(T - 1, device=pos.device)[None, :] >= (
        lens.long()[:, None] - 1)
    ok = (len(cts) == 11 and bool((cts[10][dead] == 0).all())
          and bool((cts[10][~dead] != 0).any())
          and all(bool((cts[i] == 0).all()) for i in (1, 5, 7)))
    log(f"{tag}: stream cotangent rows past each length exactly 0 "
        f"({int(dead.sum())} rows), s20/sig2v/s2n cotangents 0 "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"K2's stream cotangent at {tag}")


def check_table_hvp(tag, pos, lens, isbl, tb, seed, **kw) -> float:
    """K3's Hessian-vector product along one random tangent of every
    table, against the plain double backward in float64 on the same inputs
    at TOL_H (each field's atol a fraction of its max); prints one line,
    exits on a disagreement, returns the largest absolute error."""
    from extrack_tpu_torch.core import tables
    from extrack_tpu_torch.ops import hvp_kernel
    gen = torch.Generator(device="cpu").manual_seed(seed)
    dot = tables.ModelTables(*(
        1e-2 * torch.randn(f.shape, generator=gen).to(f.device)
        for f in tb))
    _, _, hv = hvp_kernel.table_hvp(pos, lens, isbl, tb, dot, **kw)
    p64, i64, tb64 = float64(pos, isbl, tb)
    _, _, hv0 = hvp_kernel.table_hvp_plain(
        p64, lens, i64, tb64, tables.ModelTables(*(f.double() for f in dot)),
        **kw)
    torch.cuda.synchronize()
    ok, worst = True, 0.0
    for name in hv0:
        scale = float(hv0[name].abs().max())
        hv[name] = hv[name].double()
        e = float((hv[name] - hv0[name]).abs().max())
        worst = max(worst, e)
        ok &= torch.allclose(hv[name], hv0[name], rtol=TOL_H["rtol"],
                             atol=TOL_H["atol"] * scale) and bool(
            torch.isfinite(hv[name]).all())
    log(f"{tag}: H.v of every table max_abs_err {worst:.3e} (tol rtol "
        f"{TOL_H['rtol']}, atol {TOL_H['atol']} max|H.v| a field) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"K3 disagrees with table_hvp_plain at {tag}")
    return worst


def check_predict(tag, pos, lens, isbl, tb, W, runs) -> float:
    """K4's logL and posteriors against ``predict_plain`` in float64 on the
    same inputs at TOL_K4_LOGL / TOL_K4_PREDS, through ``predict`` and each
    (mapping, stash) of ``runs``; prints one line each, exits on a
    disagreement, returns the largest absolute error."""
    from extrack_tpu_torch.ops import forward_kernel, predict_kernel
    S = tb.nb_states
    p64, i64, tb64 = float64(pos, isbl, tb)
    logl0, preds0 = predict_kernel.predict_plain(p64, lens, i64, tb64,
                                                 window=W, min_len=2)
    d, tabs = forward_kernel.kernel_inputs(pos, lens, isbl, tb, W, 1)
    tabs = [t.detach() for t in tabs]
    worst = 0.0
    for mapping, stash in [(None, None)] + list(runs):
        if mapping is None:
            logl, preds = predict_kernel.predict(pos, lens, isbl, tb,
                                                 window=W, min_len=2)
        else:
            logl, preds = predict_kernel.launch(d, tabs, 2, S, W,
                                                mapping=mapping, stash=stash)
        torch.cuda.synchronize()
        logl, preds = logl.double(), preds.double()
        e = max(float((logl - logl0).abs().max()),
                float((preds - preds0).abs().max()))
        worst = max(worst, e)
        ok = (torch.allclose(logl, logl0, **TOL_K4_LOGL)
              and torch.allclose(preds, preds0, **TOL_K4_PREDS))
        how = f"{mapping} mapping, stash in {stash}" if mapping else "predict"
        log(f"{tag} ({how}): logL and preds max_abs_err {e:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"K4 disagrees with predict_plain at {tag} ({how})")
    return worst


def k5_bound(buckets, n: int, stream: int = 0):
    """K5's bound (2 states, W=7 sub-steps, K=128) on ``buckets`` at n
    sub-steps a frame: positions and l2 in, lengths and isBL in, the
    static segment tables (Wf+2 rows) once per bucket, ``stream`` bytes
    of variable dt, the (T, S) histogram out."""
    from extrack_tpu_torch import data
    wf = (7 - 1) // n + 1
    rows = sum(b.positions.numel() for b in buckets) * 4
    n_tr = sum(b.batch_size for b in buckets)
    seg_bytes = sum((wf + 2) * 2 * b.max_len * 128 * 4 for b in buckets)
    return bound(2 * rows + 8 * n_tr + seg_bytes + stream,
                 sum(walk_ops(data.host_lengths(b), 128, 2 ** n, 2, "K5",
                              T=b.max_len, W=7, S=2) for b in buckets))


def k5_runs(buckets, tbs, n: int, W: int = 7, min_len: int = 3):
    """Three functions over ``buckets`` (each with its tables in ``tbs``)
    at W sub-steps, n a frame: bare K5 launches on prepared inputs, K5
    through ``hist_kernel.hist``, and the plain version in chunks of
    PLAIN_HIST_CHUNK tracks (a per-track table sliced with them)."""
    from extrack_tpu_torch.ops import forward_kernel, hist_kernel
    args = []
    for b, tb in zip(buckets, tbs):
        d, tabs = forward_kernel.kernel_inputs(b.positions, b.lengths,
                                               b.is_bleached, tb, W, n)
        args.append((d, [t.detach() for t in tabs]))
    kw = dict(window=W, min_len=min_len, nb_substeps=n)

    def bare():
        for d, tabs in args:
            hist_kernel.launch(d, tabs, min_len, 2, W, n)

    def wrapped():
        for b, tb in zip(buckets, tbs):
            hist_kernel.hist(b.positions, b.lengths, b.is_bleached, tb, **kw)

    def plain():
        with torch.no_grad():
            for b, tb in zip(buckets, tbs):
                for i in range(0, b.batch_size, PLAIN_HIST_CHUNK):
                    sl = slice(i, i + PLAIN_HIST_CHUNK)
                    hist_kernel.hist_plain(
                        b.positions[sl], b.lengths[sl], b.is_bleached[sl],
                        tb._replace(sig2=tb.sig2[sl] if tb.sig2.ndim == 3
                                    else tb.sig2), **kw)
    return bare, wrapped, plain


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
                "plain_tracks": None, "bound_ms": None, "bound_by": None,
                "library_ms": None}

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
        # variable dt: the same kernels reading the streamed displacement
        # variances (the TPU kernels' streamed-sig2 paths)
        "K1 dt": entry("forward_loglik_variable_dt", "forward.cu",
                       "extrack_tpu/ops/pallas_engine.py:218"),
        "K2 dt": entry("loglik_grad_variable_dt", "grad.cu",
                       "extrack_tpu/ops/pallas_grad.py:549"),
        "K3 dt": entry("loglik_hvp_variable_dt", "hvp.cu",
                       "extrack_tpu/ops/pallas_hvp.py:78"),
        "K4 dt": entry("posteriors_variable_dt", "predict.cu",
                       "extrack_tpu/ops/pallas_predict.py:65"),
        "K5 dt": entry("duration_hist_variable_dt", "hist.cu",
                       "extrack_tpu/ops/pallas_hist.py:63"),
        # two sub-steps a frame: the TPU kernel stops at one, and JAX runs
        # its XLA window engine there (extrack_tpu/histograms.py:290)
        "K5 n=2": entry("duration_hist_substeps", "hist.cu",
                        "extrack_tpu/ops/pallas_hist.py:63"),
        # past 1024 slots, the wide mapping (a thread a fusion group): JAX
        # runs its XLA engines there when the TPU kernels' VMEM budget
        # is exceeded (extrack_tpu/histograms.py:632-645, predict.py:113-121,
        # refine.py:654-668)
        "K1 wide": entry("forward_loglik_wide", "forward.cu",
                         "extrack_tpu/ops/pallas_engine.py:218"),
        "K4 wide": entry("posteriors_wide", "predict.cu",
                         "extrack_tpu/ops/pallas_predict.py:65"),
        "K5 wide": entry("duration_hist_wide", "hist.cu",
                         "extrack_tpu/ops/pallas_hist.py:63"),
        "K6 wide": entry("refinement_wide", "refine.cu",
                         "extrack_tpu/ops/pallas_refine.py:108"),
        # past 4096 slots: the wide mapping with its carries in global
        # scratch where shared memory cannot hold them
        "K4 past 4096": entry("posteriors_past_4096", "predict.cu",
                              "extrack_tpu/ops/pallas_predict.py:65"),
        "K5 past 4096": entry("duration_hist_past_4096", "hist.cu",
                              "extrack_tpu/ops/pallas_hist.py:63"),
        "K5 n=2 past 4096": entry("duration_hist_substeps_past_4096",
                                  "hist.cu",
                                  "extrack_tpu/ops/pallas_hist.py:63"),
        # the HMC sampler's gradients (phase 13): K2 at its subset's
        # buckets, as every leapfrog step launches it
        "K2 sample": entry("loglik_grad_sampler", "grad.cu",
                           "extrack_tpu/ops/pallas_grad.py:549"),
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
    spills = []
    entry_name = ""
    k5_new = {}     # spill bytes of K5's variable-dt and sub-step kernels
    wide_regs = {}  # registers and spill bytes of the wide instantiations
    global_regs = {}  # the same of the wide ones with carries in scratch
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if ("registers" in line or "spill" in line
                or "Compiling entry" in line):
            log("  ptxas " + line.strip())
        if "Compiling entry" in line:
            entry_name = line.split("'")[1]
        spilled = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill",
                            line)
        k5 = re.match(r"_ZN7extrack11hist_kernelILi(\d)ELi(\d+)ELb([01])E"
                      r"Lb([01])E", entry_name)
        if spilled and k5 and "1" in k5.group(3, 4):
            key = "D={} NT={} VDT={} SUB={}".format(*k5.group(1, 2, 3, 4))
            k5_new[key] = int(spilled.group(1)) + int(spilled.group(2))
        wide = re.match(r"_ZN7extrack1[68](walk|hist|refine)_wide_kernel",
                        entry_name)
        scratch = re.match(r"_ZN7extrack23(walk|hist)_wide_global_kernel",
                           entry_name)
        regs = re.search(r"Used (\d+) registers", line)
        for found, table in ((wide, wide_regs), (scratch, global_regs)):
            if found and (spilled or regs):
                key = entry_name[:60]
                table.setdefault(key, [0, 0])
                if regs:
                    table[key][0] = int(regs.group(1))
                if spilled:
                    table[key][1] = (int(spilled.group(1))
                                     + int(spilled.group(2)))
        block = re.match(r"_ZN7extrack(?:1[13](?:hist|refine)_kernel|17walk_"
                         r"block_kernel)ILi\dELi(\d+)E", entry_name)
        threads = (int(block.group(1)) if block
                   else 128 if entry_name.startswith(
                       "_ZN7extrack16walk_warp_kernel") else 0)
        if (spilled and 0 < threads <= 512
                and (int(spilled.group(1)) or int(spilled.group(2)))):
            spills.append(entry_name)
    if spills:
        fail(f"K1/K4/K5/K6 instantiations of <= 512 threads spill: {spills}")
    log("phase 0: no K1, K4, K5 (constant or variable dt) or K6 "
        "instantiation of <= 512 threads spills; K5's variable-dt and "
        "sub-step instantiations, spill bytes (stores + loads): "
        + ", ".join(f"{k} {v}" for k, v in sorted(k5_new.items())))
    if len(k5_new) != 36:
        fail(f"K5 has {len(k5_new)} variable-dt or sub-step instantiations, "
             "not 36 (D 1..3, 4 block sizes, 3 flag pairs)")
    log("phase 0: the wide mapping's instantiations (1024 threads, K <= "
        "4096; registers, spill bytes stores + loads): " + ", ".join(
            f"{k} {r} regs {b} B" for k, (r, b) in sorted(wide_regs.items())))
    if len(wide_regs) != 21:
        fail(f"{len(wide_regs)} wide instantiations, not 21 (K1 and K4: D "
             "1..3 x constant and variable dt; K5: D 1..3 x constant and "
             "variable dt; K6: D 1..3)")
    log("phase 0: K4's and K5's wide instantiations with their carries in "
        "global scratch (1024 threads, K <= 16384; registers, spill bytes "
        "stores + loads): " + ", ".join(
            f"{k} {r} regs {b} B"
            for k, (r, b) in sorted(global_regs.items())))
    if len(global_regs) != 12:
        fail(f"{len(global_regs)} wide instantiations with carries in global "
             "scratch, not 12 (K4 and K5: D 1..3 x constant and variable "
             "dt)")

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
    # K1 and K2 on each mapping: K1's wide mapping and K2's block mapping
    # are forced by a zero warp limit
    for S, W in MAPPING_CASES:
        pos, lens, isbl, tb = parity_case(S, W, 1, 150 + S * 10 + W, dev)
        kw = dict(window=W, nb_substeps=1, min_len=2)
        for k, mod, check, team in (
                ("K1", forward_kernel, check_forward, "wide"),
                ("K2", grad_kernel, check_table_grads, "block")):
            saved = mod.WARP_MAX_K
            for mapping in (("warp", team) if S ** W <= saved
                            else (team,)):
                mod.WARP_MAX_K = saved if mapping == "warp" else 0
                try:
                    errs[k].append(check(
                        f"phase {k[1]}: {k} {mapping} mapping S={S} W={W} "
                        f"(K={S ** W})", pos, lens, isbl, tb, **kw))
                finally:
                    mod.WARP_MAX_K = saved

    # ---- phase 3: the fit main path --------------------------------------
    t0 = time.time()
    tracks, true_states, _ = simulate.sim_fov(**SIM)
    n_tr = sum(len(v) for v in tracks.values())
    host_counts = {int(k): len(v) for k, v in tracks.items()}
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
    fit3 = res                  # phase 14 holds the entry points to it

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
    # the plain versions once each, unwarmed: seconds a pass at 2^20
    pms = {"K1": cuda_ms(p1_run, 1, warmup=0),
           "K2": cuda_ms(p2_run, 1, warmup=0)}
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
            n = b.batch_size // PLAIN_SHARE
            for i in range(0, n, PLAIN_HVP_CHUNK):
                sl = slice(i, min(i + PLAIN_HVP_CHUNK, n))
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
    kinfo["K3"]["plain_tracks"] = sum(b.batch_size // PLAIN_SHARE
                                      for b in bench)
    kinfo["K3"]["wrapper_ms"] = wms3
    kinfo["K3"]["bound_ms"], kinfo["K3"]["bound_by"] = bound(
        dual_rows * (1 + 2 + 2) + 16 * n_bench,
        walk_ops(bench_lens, 64, 2, 2, "K3"))
    log(f"phase 5: K3 {n_bench} tracks ({len(bench)} buckets), one tangent "
        f"direction: kernel {ms3:.3f} ms (with its wrapper {wms3:.3f} ms); "
        f"plain (double backward, chunks of "
        f"{PLAIN_HVP_CHUNK}) {pms3:.3f} ms on "
        f"{kinfo['K3']['plain_tracks']} of the tracks; bound "
        f"{kinfo['K3']['bound_ms']:.4f} ms ({kinfo['K3']['bound_by']}); "
        f"block mapping {ms3_block:.3f} ms (for reading) [{card}]")

    # ---- phase 6: K4 -------------------------------------------------------
    for S, W, D, B, T, per_peak in PREDICT_CASES:
        pos, lens, isbl, tb6 = parity_case(S, W, 1, 300 + S * 10 + W + T,
                                           dev, B=B, T=T, D=D,
                                           per_peak=per_peak)
        kw6 = dict(window=W, min_len=2)
        logl0, preds0 = predict_kernel.predict_plain(pos, lens, isbl, tb6,
                                                     **kw6)
        L = lens.cpu().numpy()
        valid = (np.arange(T)[None, :] < L[:, None]) & (L >= 2)[:, None]
        # through the wrapper's plan, then on every mapping with the stash
        # of fusion weights in shared memory and in global scratch
        d6, t6 = forward_kernel.kernel_inputs(pos, lens, isbl, tb6, W, 1)
        t6 = [t.detach() for t in t6]
        for mapping, stash in [(None, None)] + [
                (m, st) for m in (("warp", "block") if S ** W <= 64
                                  else ("block",))
                for st in ("smem", "global")]:
            if mapping is None:
                logl, preds = predict_kernel.predict(pos, lens, isbl, tb6,
                                                     **kw6)
            else:
                logl, preds = predict_kernel.launch(d6, t6, 2, S, W,
                                                    mapping=mapping,
                                                    stash=stash)
            torch.cuda.synchronize()
            e_l = float((logl - logl0).abs().max())
            e_p = float((preds - preds0).abs().max())
            sums = preds.sum(-1).cpu().numpy()
            ok = (torch.allclose(logl, logl0, **TOL_K4_LOGL)
                  and torch.allclose(preds, preds0, **TOL_K4_PREDS)
                  and np.allclose(sums[valid], 1.0, atol=1e-3)
                  and bool(np.all(sums[~valid] == 0.0)))
            errs["K4"].append(max(e_l, e_p))
            how = (f"{mapping} mapping, stash in {stash}" if mapping
                   else "predict")
            log(f"phase 6: K4 S={S} W={W} D={D} B={B} T={T} per-peak="
                f"{per_peak} ({how}): logL max_abs_err {e_l:.3e}, preds "
                f"max_abs_err {e_p:.3e}, |sum-1| max "
                f"{np.abs(sums[valid] - 1).max():.2e} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"K4 disagrees with predict_plain at S={S} W={W} T={T} "
                     f"({how})")

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
    pms4 = cuda_ms(p4_run, 1, warmup=0)
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

    # K5 past one sub-step: parity against the plain version in float64,
    # then len_hist(nb_substeps=2) on the main path
    for S, wf, n in HIST_SUB_CASES:
        W = n * (wf - 1) + 1
        pos, lens, isbl, tb7 = parity_case(S, W, n, 430 + S * 10 + wf, dev)
        kw7 = dict(window=W, min_len=2, nb_substeps=n)
        h = hist_kernel.hist(pos, lens, isbl, tb7, **kw7)
        again = hist_kernel.hist(pos, lens, isbl, tb7, **kw7)
        p64, i64, t64 = float64(pos, isbl, tb7)
        h0 = hist_kernel.hist_plain(p64, lens, i64, t64, **kw7)
        L = lens.cpu().numpy()
        errs["K5 n=2"].append(check_hist(
            f"phase 7: K5 S={S} window {wf} frames n={n} (W={W}, K={S ** W})"
            " against the plain version in float64", h.double(), h0,
            float(L[L >= 2].sum())))
        if not torch.equal(h, again):
            fail(f"K5 gave two histograms for one input at S={S} n={n}")
    reset_counts()
    t0 = time.time()
    hist2 = histograms.len_hist(tracks, values, 0.02, cell_dims=(0.5,),
                                nb_states=2, nb_substeps=2, window=4)
    t_hist2 = time.time() - t0
    k5, plain = hist_kernel.LAUNCHES, plain_calls()
    log(f"phase 7: len_hist(nb_substeps=2, window=4) on {n_tr} tracks "
        f"(W=7, K=128) {t_hist2:.2f} s; K5 launches {k5}, plain calls "
        f"{plain} [{card}]")
    if k5 != len(pbuckets) or plain != 0:
        fail(f"two-sub-step histogram path K5 launches {k5} (want "
             f"{len(pbuckets)}), plain calls {plain}")
    kinfo["K5 n=2"]["launches"] = k5
    tbf2 = tables.build_tables(Ds, loc_err, Fs, rates, pBL, 0.02,
                               cell_dims=(0.5,), nb_substeps=2)
    summed = np.zeros_like(hist2)
    for b in pbuckets:
        args = (b.positions, b.lengths, b.is_bleached, tbf2)
        kw7 = dict(window=7, min_len=min_len, nb_substeps=2)
        h = hist_kernel.hist(*args, **kw7)
        h0 = hist_kernel.hist_plain(*args, **kw7)
        L = data.host_lengths(b)
        errs["K5 n=2"].append(check_hist(
            f"phase 7: n=2 bucket T={b.max_len} B={b.batch_size}", h, h0,
            float(L[L >= 2].sum()), kernel="K5 (n=2)"))
        summed[:b.max_len] += h.double().cpu().numpy()
    counted = float((hist2 * np.arange(1, hist2.shape[0] + 1)[:, None]).sum())
    ok = (np.array_equal(summed, hist2)
          and abs(counted - frames) <= TOL_FRAMES * frames)
    log(f"phase 7: len_hist(nb_substeps=2) = the sum of its buckets' K5 "
        f"histograms: {np.array_equal(summed, hist2)}; frames {counted:.1f} "
        f"of {frames} (rel {abs(counted - frames) / frames:.2e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("len_hist(nb_substeps=2) differs from its buckets or loses "
             "frames")

    # K5 time at 2^20 tracks, T=10, W=7: one sub-step, then two (window
    # of 4 frames, K=128, A=4)
    tb2 = tables.build_tables(
        torch.tensor([0.0, 0.08], **f32), torch.tensor(0.02, **f32),
        torch.tensor([0.5, 0.5], **f32),
        torch.tensor([[0.0, 0.1], [0.1, 0.0]], **f32),
        torch.tensor(0.1, **f32), 0.02, cell_dims=(0.5,), nb_substeps=2)
    for k, n, tbk in (("K5", 1, tb), ("K5 n=2", 2, tb2)):
        bare, wrapped, plain_run = k5_runs(bench, [tbk] * len(bench), n)
        info = kinfo[k]
        info["ms"], info["wrapper_ms"] = cuda_ms(bare, 10), cuda_ms(wrapped, 5)
        info["plain_ms"] = cuda_ms(plain_run, 1, warmup=0)
        info["bound_ms"], info["bound_by"] = k5_bound(bench, n)
        log(f"phase 7: {k} {n_bench} tracks ({len(bench)} buckets), W=7, "
            f"n={n}: kernel {info['ms']:.3f} ms = "
            f"{n_bench / info['ms'] * 1e3 / 1e6:.3f}M tracks/s (with its "
            f"wrapper {info['wrapper_ms']:.3f} ms); plain "
            f"{info['plain_ms']:.3f} ms (chunks of {PLAIN_HIST_CHUNK}); "
            f"bound {info['bound_ms']:.4f} ms ({info['bound_by']}) [{card}]")
    ms5 = kinfo["K5"]["ms"]

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
    W8 = refine.default_window(2, max(int(k) for k in tracks), 2)
    log(f"phase 8: position_refinement on {n_tr} tracks (window {W8}, the "
        f"JAX package's default) {t_ref:.2f} s; K6 launches {k6}, plain "
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
        mu, sig = on_card(refine.refine_batch(b, loc8, ds8, tr8), dev)
        got_mu, got_sig = data.to_dict(b, mu), data.to_dict(b, sig[..., 0])
        same = all(np.array_equal(got_mu[k], mus[k])
                   and np.array_equal(got_sig[k], sigmas[k]) for k in got_mu)
        n = min(REFINE_CHECK, b.batch_size)
        mu0, sig0 = refine_kernel.refine_plain(
            b.positions[:n], b.lengths[:n], l2_8, lt8, sig2_8, window=W8)
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
        """The plain version on each bucket's first ``n`` tracks (default:
        its first 1/PLAIN_SHARE)."""
        with torch.no_grad():
            for b in bench:
                m = b.batch_size // PLAIN_SHARE if n is None else n
                refine_kernel.refine_plain(b.positions[:m], b.lengths[:m],
                                           l2_b, lt_b, sig2_b, window=7)

    ms6, wms6 = cuda_ms(k6_run, 5), cuda_ms(k6_wrapped, 3)
    p6_run(REFINE_PLAIN_WARMUP)         # warm-up on the first tracks only
    pms6 = cuda_ms(p6_run, 1, warmup=0)
    kinfo["K6"]["ms"], kinfo["K6"]["plain_ms"] = ms6, pms6
    kinfo["K6"]["plain_tracks"] = sum(b.batch_size // PLAIN_SHARE
                                      for b in bench)
    kinfo["K6"]["wrapper_ms"] = wms6
    kinfo["K6"]["bound_ms"], kinfo["K6"]["bound_by"] = bound(
        4 * rows + 4 * n_bench,
        walk_ops(bench_lens, 128, 2, 2, "K6", S=2))
    # the SFU floor beside the operation bound: one rsqrt and one exp2 per
    # pair, 16 results per clock per SM at the card's top SM clock
    pairs = float((np.maximum(bench_lens - 2, 0) * 2 * 64 ** 2).sum())
    sfu6 = sfu_ms(2 * pairs, dev)   # for the log only: not a measurement
    log(f"phase 8: K6 {n_bench} tracks ({len(bench)} buckets), W=7: kernel "
        f"{ms6:.3f} ms = {n_bench / ms6 * 1e3 / 1e6:.3f}M tracks/s (with "
        f"its wrapper {wms6:.3f} ms); plain {pms6:.3f} ms on the first "
        f"{kinfo['K6']['plain_tracks']} of them (a quarter of each bucket); "
        f"bound {kinfo['K6']['bound_ms']:.4f} ms "
        f"({kinfo['K6']['bound_by']}), SFU floor "
        f"{sfu6:.4f} ms ({pairs:.4g} pairs) [{card}]")

    # 3 states at the JAX package's default window: tracks of up to 9
    # frames take W=6 (K=729, the 1024-thread instantiation)
    tr3r = np.full((3, 3), 0.05) + np.eye(3) * 0.85
    tracks3r, _, _ = simulate.sim_fov(
        nb_tracks=20_000, max_track_len=9, min_track_len=3, LocErr=0.02,
        Ds=(0.0, 0.02, 0.1), TrMat=tr3r, dt=0.02, pBL=0.1, cell_dims=(0.5,),
        seed=4)
    ds3 = np.sqrt(2.0 * np.array([0.0, 0.02, 0.1]) * 0.02)
    T3 = max(int(k) for k in tracks3r)
    W3 = refine.default_window(3, T3, 2)
    buckets3r = data.from_dict_bucketed(tracks3r, max_buckets=4, device=dev)
    for b in buckets3r:             # warm-up (and the buckets to check)
        refine.refine_batch(b, 0.02, ds3, tr3r, frame_len=W3)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    mus3, sigmas3 = refine.position_refinement(tracks3r, 0.02, ds3,
                                               [1 / 3] * 3, tr3r)
    torch.cuda.synchronize()
    t_r3 = time.time() - t0
    k6_3, plain = refine_kernel.LAUNCHES, plain_calls()
    n3r = sum(len(v) for v in tracks3r.values())
    log(f"phase 8: position_refinement on {n3r} 3-state tracks of up to "
        f"{T3} frames: window {W3} (K={3 ** W3}, the JAX package's default "
        f"at T={T3}, D=2) {t_r3:.3f} s; K6 launches {k6_3}, plain calls "
        f"{plain} [{card}]")
    if k6_3 != len(buckets3r) or plain != 0 or W3 != 6:
        fail(f"3-state refinement: K6 launches {k6_3} (want "
             f"{len(buckets3r)}), plain calls {plain}, window {W3}")
    f32 = dict(dtype=torch.float32, device=dev)
    lt3 = tables.cap_log(torch.tensor(tr3r, **f32))
    sig2_3 = torch.tensor(ds3, **f32) ** 2
    l2_3 = torch.full((1, 1, 1), 0.02 ** 2, **f32)
    # each bucket: the entry point's output is refine_batch's bit for bit,
    # and that output holds to the plain version on the first tracks
    for b in buckets3r:
        mu, sig = on_card(refine.refine_batch(b, 0.02, ds3, tr3r,
                                              frame_len=W3), dev)
        got_mu, got_sig = data.to_dict(b, mu), data.to_dict(b, sig[..., 0])
        same = all(np.array_equal(got_mu[k], mus3[k])
                   and np.array_equal(got_sig[k], sigmas3[k])
                   for k in got_mu)
        n = min(REFINE3_CHECK, b.batch_size)
        mu0, sig0 = refine_kernel.refine_plain(
            b.positions[:n], b.lengths[:n], l2_3, lt3, sig2_3, window=W3)
        errs["K6"].append(check_refine(
            f"phase 8: 3 states, W={W3}, bucket T={b.max_len}, first {n} "
            f"tracks", mu[:n], sig[:n], mu0, sig0, b.positions[:n],
            b.lengths[:n], l2_3))
        if not same:
            fail(f"3-state position_refinement differs from K6 on bucket "
                 f"T={b.max_len}")
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

    # 3 states: the window engine's default (K = 3^7 = 2187) runs K5's
    # wide mapping, each bucket held to the plain version; the top-K
    # engine runs through K7
    tracks3, _, _ = simulate.sim_fov(
        nb_tracks=20_000, max_track_len=20, min_track_len=3, LocErr=0.02,
        Ds=(0.0, 0.02, 0.1), TrMat=TR3, dt=0.02, pBL=0.1, cell_dims=(0.5,),
        seed=3)
    values3 = {"LocErr": 0.02, "D0": 0.0, "D1": 0.02, "D2": 0.1,
               "F0": 1 / 3, "F1": 1 / 3, "F2": 1 / 3, "pBL": 0.1,
               **{f"p{i}{j}": 0.05 for i in range(3) for j in range(3)
                  if i != j}}
    buckets3 = data.from_dict_bucketed(tracks3, max_buckets=4, device=dev,
                                       dtype=torch.float32)
    reset_counts()
    t0 = time.time()
    hist3w = histograms.len_hist(tracks3, values3, 0.02, cell_dims=(0.5,),
                                 nb_states=3)
    t3w = time.time() - t0
    k5_3, plain = hist_kernel.LAUNCHES, plain_calls()
    n3 = sum(len(v) for v in tracks3.values())
    log(f"phase 9: len_hist(nb_states=3) on {n3} tracks, window 7 "
        f"(K=2187: K5 wide) {t3w:.2f} s; K5 launches "
        f"{k5_3}, plain calls {plain} [{card}]")
    if k5_3 != len(buckets3) or plain != 0:
        fail(f"3-state len_hist: K5 launches {k5_3}, plain calls {plain}")
    Ds3, Fs3, rates3, loc3, pBL3 = params.extract_arrays(
        values3, 3, device=dev, dtype=torch.float32)
    tb3 = tables.build_tables(Ds3, loc3, Fs3, rates3, pBL3, 0.02,
                              cell_dims=(0.5,))
    min3 = data.default_min_len(
        np.concatenate([data.host_lengths(b) for b in buckets3]))
    summed = np.zeros_like(hist3w)
    for b in buckets3:
        args = (b.positions, b.lengths, b.is_bleached, tb3)
        h = hist_kernel.hist(*args, window=7, min_len=min3)
        with torch.no_grad():
            h0 = sum(hist_kernel.hist_plain(
                *(x[i:i + WIDE_PLAIN_CHUNK] for x in args[:3]), tb3,
                window=7, min_len=min3)
                for i in range(0, b.batch_size, WIDE_PLAIN_CHUNK))
        L = data.host_lengths(b)
        errs["K5 wide"].append(check_hist(
            f"phase 9: 3 states, window 7 (K5 wide), bucket T={b.max_len} "
            f"B={b.batch_size}", h, h0, float(L[L >= 2].sum()),
            kernel="K5 wide"))
        summed[:b.max_len] += h.double().cpu().numpy()
    frames3 = sum(int(k) * len(v) for k, v in tracks3.items())
    if not np.array_equal(summed, hist3w) or abs(
            float((hist3w * np.arange(1, hist3w.shape[0] + 1)[:, None]
                   ).sum()) - frames3) > TOL_FRAMES * frames3:
        fail("3-state len_hist differs from its buckets or loses frames")
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

    del bench30
    phase10(dev, card, kinfo, errs, reset_counts, plain_calls, ms, ms3, ms4,
            ms5)
    phase11(dev, card, kinfo, errs, reset_counts, plain_calls)
    phase12(dev, card, kinfo, errs, reset_counts, plain_calls)
    phase13(dev, card, kinfo, errs, reset_counts, plain_calls, host_counts)
    phase14(dev, card, reset_counts, plain_calls, tracks, fit3)
    phase15(dev, card, reset_counts, plain_calls, tracks, fit3)

    for k in kinfo:
        kinfo[k]["max_abs_err"] = max(errs[k])
    print(card, flush=True)
    print(json.dumps({"kernels": list(kinfo.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def phase10(dev, card, kinfo, errs, reset_counts, plain_calls, ms, ms3,
            ms4, ms5):
    """Variable dt: parity of K1..K5 with the streamed table, the
    mixed-frame-rate main path, and the variable-dt kernels' times (``ms``,
    ``ms3``, ``ms4``, ``ms5``: the constant-dt bare times of phases
    4-7)."""
    from extrack_tpu_torch import data, fit, histograms, params, predict
    from extrack_tpu_torch.core import tables
    from extrack_tpu_torch.ops import (forward_kernel, grad_kernel,
                                       hist_kernel, hvp_kernel,
                                       predict_kernel)
    t10 = time.time()
    # parity, kernel against the plain version in float64 on the same
    # (float32) inputs: the f32 plain version's own rounding of the
    # per-peak l2 cotangents (sums of terms up to 1e4 that cancel) reaches
    # the tolerance, the kernel's stays below it.  Per-step and per-track
    # tables
    for S, W, n, D, B, T in PARITY_CASES:
        # a per-step table at T = 2 has one row: a constant dt
        for kind in ("step", "track") if T > 2 else ("track",):
            pos, lens, isbl, tb = parity_case(
                S, W, n, 500 + S * 10 + W + n, dev, B=B, T=T, D=D,
                per_peak=(S == 3), dt=kind)
            if not forward_kernel.classify_sig2(tb.sig2, T):
                fail(f"phase 10: S={S} W={W} T={T} {kind} dt not variable")
            kw = dict(window=W, nb_substeps=n, min_len=2)
            tag = (f"phase 10: {{}} S={S} W={W} n={n} D={D} B={B} T={T} "
                   f"{kind} dt")
            errs["K1 dt"].append(check_forward(tag.format("K1"), pos, lens,
                                               isbl, tb, ref64=True, **kw))
            errs["K2 dt"].append(check_table_grads(tag.format("K2"), pos,
                                                   lens, isbl, tb,
                                                   ref64=True, **kw))
            stream_zero_past_lengths(tag.format("K2"), pos, lens, isbl, tb,
                                     W, n)
            errs["K3 dt"].append(check_table_hvp(tag.format("K3"), pos, lens,
                                                 isbl, tb, 600 + W, **kw))
            if n == 1:
                runs = [(m, st) for m in (("warp", "block") if S ** W <= 64
                                          else ("block",))
                        for st in ("smem", "global")]
                errs["K4 dt"].append(check_predict(tag.format("K4"), pos,
                                                   lens, isbl, tb, W, runs))
    # K3's Hessian columns on per-track dt buckets
    for S, W, n, per_peak in HVP_CASES[:3]:
        buckets, spec, kw = hvp_case(S, W, n, per_peak, dev,
                                     700 + S * 10 + W + n, dt=True)
        z = spec.to_unconstrained()
        H = fit.hessian_hvp_columns(buckets, spec, z, 0.02, S, **kw)
        H0 = plain_hessian_columns(buckets, spec, z, 0.02, S, **kw)
        errs["K3 dt"].append(check_hessian(
            f"phase 10: K3 S={S} W={W} n={n} per-peak={per_peak} per-track "
            f"dt T={[b.max_len for b in buckets]}", H, H0))
    # a stream of the constant table gives the constant-dt kernels' logL
    for S, W, n in ((2, 6, 1), (3, 5, 1), (2, 4, 2)):
        pos, lens, isbl, tb = parity_case(S, W, n, 800 + S + W, dev)
        d, tabs = forward_kernel.kernel_inputs(pos, lens, isbl, tb, W, n)
        tabs = [t.detach() for t in tabs]
        streamed = tabs + [forward_kernel.sig2_stream(tb.sig2, *pos.shape[:2])]
        a = forward_kernel.launch(d, streamed, 2)
        b = forward_kernel.launch(d, tabs, 2)
        e = float((a - b).abs().max())
        ok = torch.allclose(a, b, rtol=1e-6, atol=1e-5)
        log(f"phase 10: K1 S={S} W={W} n={n}: a stream of the constant "
            f"table against the constant-dt kernel: max_abs_err {e:.3e} "
            f"(rtol 1e-6, atol 1e-5) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("K1 on a constant stream differs from constant-dt K1")

    # K5 per step and per track, at one and two sub-steps a frame
    for S, wf, n in HIST_DT_CASES:
        W = n * (wf - 1) + 1
        for kind in ("step", "track"):
            pos, lens, isbl, tb = parity_case(S, W, n, 560 + S * 10 + wf + n,
                                              dev, dt=kind)
            kw = dict(window=W, min_len=2, nb_substeps=n)
            h = hist_kernel.hist(pos, lens, isbl, tb, **kw)
            p64, i64, t64 = float64(pos, isbl, tb)
            h0 = hist_kernel.hist_plain(p64, lens, i64, t64, **kw)
            L = lens.cpu().numpy()
            errs["K5 dt"].append(check_hist(
                f"phase 10: K5 S={S} window {wf} frames n={n} (K={S ** W}) "
                f"{kind} dt against the plain version in float64",
                h.double(), h0, float(L[L >= 2].sum()), kernel="K5 dt"))
    log(f"phase 10: parity {time.time() - t10:.1f} s")
    # the mixed-frame-rate main path
    t0 = time.time()
    tracks, dts, states = merged_movies(SIM_DT)
    n_tr = sum(len(v) for v in tracks.values())
    log(f"phase 10: simulated {n_tr} tracks (dt 0.02 and 0.05, "
        f"{len(SIM_DT)} movies) in {time.time() - t0:.1f} s")
    buckets = data.from_dict_bucketed(tracks, max_buckets=4, dt=dts,
                                      device=dev, dtype=torch.float32)
    spec = params.generate_params(
        nb_states=2, LocErr_type=1, LocErr_bounds=(0.005, 0.1),
        D_max=3.0, estimated_transition_rates=0.1)
    z0 = torch.tensor(spec.to_unconstrained(), dtype=torch.float32,
                      device=dev, requires_grad=True)
    min_len = data.default_min_len(
        np.concatenate([data.host_lengths(b) for b in buckets]))
    for b in buckets:
        obj = fit.make_objective([b], spec, 0.0, 2, cell_dims=(0.5,),
                                 min_len=min_len)
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
        e = float((g_k - g_p).abs().max())
        errs["K2 dt"].append(abs(float((v_k - v_p).detach())))
        log(f"phase 10: bucket T={b.max_len} B={b.batch_size}: objective "
            f"{float(v_k.detach()):.4f} vs plain {float(v_p.detach()):.4f}, "
            f"z-gradient "
            f"max_abs_err {e:.3e} (value {TOL_K2_VALUE}, z-grad "
            f"{TOL_Z_GRAD}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"mixed-frame-rate objective at bucket T={b.max_len}")

    reset_counts()
    evals = []
    t0 = time.time()
    res = fit.param_fitting(
        tracks, dts, nb_states=2, compute_errors=True, max_iter=FIT_ITERS,
        verbose=0, cell_dims=(0.5,),
        callback=lambda i, v, vals: evals.append((v, time.time())))
    torch.cuda.synchronize()
    t_fit = time.time() - t0
    k1, k2, k3 = (forward_kernel.LAUNCHES, grad_kernel.LAUNCHES,
                  hvp_kernel.LAUNCHES)
    plain = plain_calls()
    n_free = len(res.params.free_names())
    log(f"phase 10: fit with error bars on mixed frame rates {t_fit:.2f} s: "
        f"{res.n_evals} evals ({res.message}) {evals[-1][1] - t0:.2f} s, "
        f"then the error bars {t0 + t_fit - evals[-1][1]:.2f} s; logL "
        f"{-evals[0][0]:.4f} -> {res.logl:.4f}; K1 launches {k1}, K2 "
        f"launches {k2}, K3 launches {k3}, plain calls {plain} [{card}]")
    if k2 == 0 or k3 != n_free * len(buckets) or plain != 0:
        fail(f"mixed-frame-rate fit: K2 launches {k2}, K3 launches {k3} "
             f"(want {n_free} x {len(buckets)}), plain calls {plain}")
    # D1 = D0 + D1_minus_D0 is derived: its error bar by the delta method
    # on the fit's Hessian (K3 again, after the counts above)
    z_fit = res.params.to_unconstrained()
    H = fit.hessian_hvp_exact(buckets, res.params, z_fit, 0.0, 2,
                              cell_dims=(0.5,), window=fit.default_window(2),
                              min_len=min_len)
    J = torch.autograd.functional.jacobian(
        lambda z_: res.params.resolve(res.params.from_unconstrained(z_))[
            "D1"] * torch.ones((), dtype=torch.float64),
        torch.tensor(z_fit, dtype=torch.float64)).numpy()
    se1 = float(np.sqrt(max(J @ np.linalg.pinv(H) @ J, 0.0)))
    d1 = res.params["D1"].value
    log(f"phase 10: fitted D1 = {d1:.5f} +/- {se1:.5f} (true 0.08); "
        + ", ".join(f"{k}={p.value:.5g}"
                    + (f" +/- {res.std_errors[k]:.3g}"
                       if k in res.std_errors else "")
                    for k, p in res.params.items()))
    if not (res.logl > -evals[0][0] and math.isfinite(res.logl)
            and math.isfinite(se1) and se1 > 0):
        fail("the mixed-frame-rate fit did not improve or has no error bar")
    # the value-only objective (K1) at the fit, against K2's value there
    obj = fit.make_objective(buckets, spec, 0.0, 2, cell_dims=(0.5,))
    z_t = torch.tensor(z_fit, dtype=torch.float32, device=dev,
                       requires_grad=True)
    v2 = float(obj(z_t).detach())
    reset_counts()
    with torch.no_grad():
        v = float(obj(z_t))
    k1, plain = forward_kernel.LAUNCHES, plain_calls()
    log(f"phase 10: value-only objective at the fit {v:.4f} (K2's "
        f"{v2:.4f}): K1 launches {k1}, plain calls {plain}")
    if k1 != len(buckets) or plain != 0 or abs(v - v2) > 2e-5 * abs(v2):
        fail("mixed-frame-rate value-only objective")
    kinfo["K1 dt"]["launches"] = k1
    kinfo["K2 dt"]["launches"] = k2
    kinfo["K3 dt"]["launches"] = k3

    values = {k: p.value for k, p in res.params.items()}
    reset_counts()
    t0 = time.time()
    out = predict.predict_Bs(tracks, dts, values, cell_dims=(0.5,),
                             nb_states=2, frame_len=5)
    torch.cuda.synchronize()
    t_pred = time.time() - t0
    k4, plain = predict_kernel.LAUNCHES, plain_calls()
    log(f"phase 10: predict_Bs on {n_tr} mixed-frame-rate tracks "
        f"{t_pred:.2f} s; K4 launches {k4}, plain calls {plain}")
    if k4 != len(buckets) or plain != 0:
        fail(f"mixed-frame-rate annotation: K4 launches {k4}, plain {plain}")
    kinfo["K4 dt"]["launches"] = k4
    Ds, Fs, rates, loc_err, pBL = params.extract_arrays(
        values, 2, device=dev, dtype=torch.float32)
    hits = total = 0
    # predict_Bs and len_hist give every bucket the dataset's
    # representative dt for its survival tables
    dt_repr = data.dt_median(tracks, dts)
    for b in buckets:
        tb = tables.build_tables(Ds, loc_err, Fs, rates, pBL, b.dt,
                                 cell_dims=(0.5,), dt_repr=dt_repr)
        args = (b.positions, b.lengths, b.is_bleached, tb)
        logl, preds = predict_kernel.predict(*args, window=5,
                                             min_len=min_len)
        logl0, preds0 = predict_kernel.predict_plain(*args, window=5,
                                                     min_len=min_len)
        got = data.to_dict(b, preds0)
        e_d = max(float(np.abs(out[k] - got[k]).max()) for k in got)
        ok = (torch.allclose(logl, logl0, **TOL_K4_LOGL)
              and torch.allclose(preds, preds0, **TOL_K4_PREDS)
              and e_d <= TOL_K4_PREDS["atol"] + TOL_K4_PREDS["rtol"])
        errs["K4 dt"].append(float((preds - preds0).abs().max()))
        log(f"phase 10: bucket T={b.max_len} B={b.batch_size}: logL "
            f"max_abs_err {float((logl - logl0).abs().max()):.3e}, preds "
            f"max_abs_err {float((preds - preds0).abs().max()):.3e}, "
            f"predict_Bs vs plain {e_d:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"mixed-frame-rate predict_Bs bucket T={b.max_len}")
        for k in got:
            hits += int((out[k].argmax(-1) == states[k]).sum())
            total += states[k].size
    log(f"phase 10: frames whose most probable state is the simulated one: "
        f"{hits}/{total} = {hits / total:.4f} (for reading, not a gate)")
    # the duration histogram of the mixed frame rates (K5 on the stream)
    reset_counts()
    t0 = time.time()
    hist = histograms.len_hist(tracks, values, dts, cell_dims=(0.5,),
                               nb_states=2)
    t_hist = time.time() - t0
    k5, plain = hist_kernel.LAUNCHES, plain_calls()
    log(f"phase 10: len_hist on {n_tr} mixed-frame-rate tracks (window 7) "
        f"{t_hist:.2f} s; K5 launches {k5}, plain calls {plain} [{card}]")
    if k5 != len(buckets) or plain != 0:
        fail(f"mixed-frame-rate histogram: K5 launches {k5}, plain {plain}")
    kinfo["K5 dt"]["launches"] = k5
    summed = np.zeros_like(hist)
    for b in buckets:
        tb = tables.build_tables(Ds, loc_err, Fs, rates, pBL, b.dt,
                                 cell_dims=(0.5,), dt_repr=dt_repr)
        args = (b.positions, b.lengths, b.is_bleached, tb)
        h = hist_kernel.hist(*args, window=7, min_len=min_len)
        h0 = hist_kernel.hist_plain(*args, window=7, min_len=min_len)
        L = data.host_lengths(b)
        errs["K5 dt"].append(check_hist(
            f"phase 10: histogram bucket T={b.max_len} B={b.batch_size}", h,
            h0, float(L[L >= 2].sum()), kernel="K5 dt"))
        summed[:b.max_len] += h.double().cpu().numpy()
    frames = sum(int(k) * len(v) for k, v in tracks.items() if int(k) >= 2)
    counted = float((hist * np.arange(1, hist.shape[0] + 1)[:, None]).sum())
    ok = (np.array_equal(summed, hist)
          and abs(counted - frames) <= TOL_FRAMES * frames)
    log(f"phase 10: len_hist = the sum of its buckets' K5 histograms: "
        f"{np.array_equal(summed, hist)}; frames {counted:.1f} of {frames} "
        f"(rel {abs(counted - frames) / frames:.2e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("mixed-frame-rate len_hist differs from its buckets or loses "
             "frames")
    del tracks, buckets, out
    log(f"phase 10: parity and main path {time.time() - t10:.1f} s")

    # times at the bench shape, per-track dt uniform in BENCH_DT
    bench = bench_buckets(dev, dt_range=BENCH_DT)
    n_bench = sum(b.batch_size for b in bench)
    bench_lens = np.concatenate([data.host_lengths(b) for b in bench])
    f32 = dict(dtype=torch.float32, device=dev)
    tbs = [tables.build_tables(
        torch.tensor([0.0, 0.08], **f32), torch.tensor(0.02, **f32),
        torch.tensor([0.5, 0.5], **f32),
        torch.tensor([[0.0, 0.1], [0.1, 0.0]], **f32),
        torch.tensor(0.1, **f32), b.dt, cell_dims=(0.5,)) for b in bench]
    kw = dict(window=6, nb_substeps=1, min_len=3)

    def inputs(W):
        out = []
        for b, tb in zip(bench, tbs):
            d, tabs = forward_kernel.kernel_inputs(
                b.positions, b.lengths, b.is_bleached, tb, W, 1)
            out.append((d, [t.detach() for t in tabs]))
        return out

    args6, args5 = inputs(6), inputs(5)
    gen = torch.Generator(device="cpu").manual_seed(5)
    tb_dots = [tables.ModelTables(*(
        1e-3 * torch.randn(f.shape, generator=gen).to(dev) for f in tb))
        for tb in tbs]
    args3 = []
    for b, tb, tb_dot, (d, tabs) in zip(bench, tbs, tb_dots, args6):
        def args_of(*fs, _b=b):
            d_, t_ = forward_kernel.kernel_inputs(
                _b.positions, _b.lengths, _b.is_bleached,
                tables.ModelTables(*fs), 6, 1)
            return (d_[1], *t_)
        _, dots = torch.autograd.functional.jvp(args_of, tuple(tb),
                                                tuple(tb_dot))
        args3.append((d, tabs, [t.contiguous() for t in dots]))

    def each(fn, chunk=None, share=1):
        """fn over each bucket's first 1/share of the tracks, in chunks."""
        def run():
            for b, tb, dot in zip(bench, tbs, tb_dots):
                n = b.batch_size // share
                step = chunk or n
                for i in range(0, n, step):
                    sl = slice(i, min(i + step, n))
                    fn(b.positions[sl], b.lengths[sl], b.is_bleached[sl],
                       tb._replace(sig2=tb.sig2[sl]), dot._replace(
                           sig2=dot.sig2[sl]))
        return run

    runs = {
        "K1 dt": (lambda: [forward_kernel.launch(d, t, 3) for d, t in args6],
                  each(lambda p, l, i, tb, _: forward_kernel.forward(
                      p, l, i, tb, **kw)),
                  each(lambda p, l, i, tb, _: forward_kernel.forward_plain(
                      p, l, i, tb, **kw))),
        "K2 dt": (lambda: [grad_kernel.launch(d, t, 3) for d, t in args6],
                  each(lambda p, l, i, tb, _:
                       grad_kernel.value_and_table_grads(p, l, i, tb, **kw)),
                  each(lambda p, l, i, tb, _:
                       grad_kernel.value_and_table_grads_plain(
                           p, l, i, tb, **kw), PLAIN_CHUNK)),
        "K3 dt": (lambda: [hvp_kernel.launch(d, t, dd[0], dd[1:], 3)
                           for d, t, dd in args3],
                  each(lambda p, l, i, tb, dot: hvp_kernel.table_hvp(
                      p, l, i, tb, dot, **kw)),
                  each(lambda p, l, i, tb, dot: hvp_kernel.table_hvp_plain(
                      p, l, i, tb, dot, **kw), PLAIN_HVP_CHUNK, PLAIN_SHARE)),
        "K4 dt": (lambda: [predict_kernel.launch(d, t, 3, 2, 5)
                           for d, t in args5],
                  each(lambda p, l, i, tb, _: predict_kernel.predict(
                      p, l, i, tb, window=5, min_len=3)),
                  each(lambda p, l, i, tb, _: predict_kernel.predict_plain(
                      p, l, i, tb, window=5, min_len=3), PLAIN_CHUNK)),
    }
    runs["K5 dt"] = k5_runs(bench, tbs, 1)
    const = {"K1 dt": ms["K1"], "K2 dt": ms["K2"], "K3 dt": ms3,
             "K4 dt": ms4, "K5 dt": ms5}
    rows = sum(b.positions.numel() for b in bench) * 4
    stream = sum(b.batch_size * (b.max_len - 1) * 4 for b in bench) * 4
    nbytes = {"K1 dt": 2 * rows + 12 * n_bench + stream,
              "K2 dt": 3 * rows + 12 * n_bench + 2 * stream,
              "K3 dt": rows * 5 + 16 * n_bench + 4 * stream,
              "K4 dt": 2 * rows + 12 * n_bench + stream
              + sum(b.batch_size * b.max_len for b in bench) * 2 * 4}
    nops = {"K1 dt": walk_ops(bench_lens, 64, 2, 2, "K1"),
            "K2 dt": walk_ops(bench_lens, 64, 2, 2, "K2"),
            "K3 dt": walk_ops(bench_lens, 64, 2, 2, "K3"),
            "K4 dt": walk_ops(bench_lens, 32, 2, 2, "K4", T=10, W=5, S=2)}
    for k, (bare, wrapped, plain_run) in runs.items():
        info = kinfo[k]
        info["ms"] = cuda_ms(bare, 10)
        info["wrapper_ms"] = cuda_ms(wrapped, 5)
        with torch.no_grad() if k in ("K1 dt", "K4 dt") else (
                torch.enable_grad()):
            info["plain_ms"] = cuda_ms(plain_run, 1, warmup=0)
        if k == "K3 dt":
            info["plain_tracks"] = sum(b.batch_size // PLAIN_SHARE
                                       for b in bench)
        info["bound_ms"], info["bound_by"] = (
            k5_bound(bench, 1, stream) if k == "K5 dt"
            else bound(nbytes[k], nops[k]))
        on = (f" on {info['plain_tracks']} of the tracks"
              if info["plain_tracks"] else "")
        log(f"phase 10: {k} {n_bench} tracks ({len(bench)} buckets), "
            f"per-track dt in {BENCH_DT}: kernel {info['ms']:.3f} ms = "
            f"{info['ms'] / const[k]:.3f}x constant dt's {const[k]:.3f} ms "
            f"(with its wrapper {info['wrapper_ms']:.3f} ms); plain "
            f"{info['plain_ms']:.3f} ms{on}; bound {info['bound_ms']:.4f} ms "
            f"({info['bound_by']}; the stream {stream / 1e6:.1f} MB) "
            f"[{card}]")
    log(f"phase 10: {time.time() - t10:.1f} s")


def wide_bucket_checks(tag, buckets, fn, plain, check, n=WIDE_CHECK):
    """Each bucket's first ``n`` tracks through a wide kernel's wrapper
    (``fn``) and its plain version (``plain``), held by ``check(tag, got,
    want, bucket slice)``; returns the largest error."""
    from extrack_tpu_torch import data
    worst = 0.0
    for b in buckets:
        k = min(n, b.batch_size)
        sub = data.TrackBatch(b.positions[:k], b.lengths[:k],
                              is_bleached=b.is_bleached[:k])
        with torch.no_grad():
            got, want = fn(sub), plain(sub)
        worst = max(worst, check(f"{tag} bucket T={b.max_len}, first {k} "
                                 "tracks", got, want, sub))
    return worst


def phase11(dev, card, kinfo, errs, reset_counts, plain_calls):
    """Past 1024 slots: K1, K4, K5 and K6 on their wide mapping (a thread
    a fusion group, csrc/walk.cuh, hist.cu, refine.cu) on the paths that
    reach them at the JAX package's defaults, each with its launches, 0
    plain calls, its wall time and its buckets' first tracks against the
    plain version; then each wide kernel's bare time beside its bound and
    its plain version's time."""
    from extrack_tpu_torch import (data, fit, histograms, params, predict,
                                   refine, simulate)
    from extrack_tpu_torch.core import tables
    from extrack_tpu_torch.ops import (forward_kernel, hist_kernel,
                                       predict_kernel, refine_kernel)
    t11 = time.time()
    f32 = dict(dtype=torch.float32, device=dev)

    def tables_of(values, S):
        Ds, Fs, rates, loc_err, pBL = params.extract_arrays(
            values, S, device=dev, dtype=torch.float32)
        return tables.build_tables(Ds, loc_err, Fs, rates, pBL, 0.02,
                                   cell_dims=(0.5,))

    # ---- 3 states: the README workflow at the JAX package's defaults
    # (windows, frame_len), the fit started from FIT3_START ----
    tracks, _, _ = simulate.sim_fov(**SIM3)
    n_tr = sum(len(v) for v in tracks.values())
    buckets = data.from_dict_bucketed(tracks, max_buckets=4, device=dev,
                                      dtype=torch.float32)
    lens = np.concatenate([data.host_lengths(b) for b in buckets])
    min_len = data.default_min_len(lens)
    reset_counts()
    t0 = time.time()
    res = fit.param_fitting(tracks, 0.02,
                            params=params.generate_params(**FIT3_START),
                            nb_states=3, compute_errors=True,
                            max_iter=FIT_ITERS, verbose=0, cell_dims=(0.5,))
    torch.cuda.synchronize()
    t_fit = time.time() - t0
    values = {k: p.value for k, p in res.params.items()}
    Ds = [values[f"D{i}"] for i in range(3)]
    log(f"phase 11: 3 states, fitted Ds {Ds[0]:.5g}, {Ds[1]:.5g}, "
        f"{Ds[2]:.5g} (simulated {SIM3['Ds']}) after {res.n_evals} "
        f"evaluations ({res.message})")
    if not (all(abs(d - d0) <= TOL_FIT3_D * d0
                for d, d0 in zip(Ds[1:], SIM3["Ds"][1:]))
            and 0.0 <= Ds[0] <= TOL_FIT3_D * SIM3["Ds"][1]):
        fail(f"the 3-state fit's Ds {Ds} are not the simulated "
             f"{SIM3['Ds']} (within {TOL_FIT3_D:.0%})")
    t0 = time.time()
    preds = predict.predict_Bs(tracks, 0.02, values, cell_dims=(0.5,),
                               nb_states=3)
    torch.cuda.synchronize()
    t_pred = time.time() - t0
    k4 = predict_kernel.LAUNCHES
    t0 = time.time()
    hist = histograms.len_hist(tracks, values, 0.02, cell_dims=(0.5,),
                               nb_states=3)
    t_hist = time.time() - t0
    k5 = hist_kernel.LAUNCHES
    # refinement with the fitted model: ds = sqrt(2 D dt), the port's
    # transition matrix (phase 8's)
    ds = np.sqrt(2.0 * np.array([values[f"D{i}"] for i in range(3)]) * 0.02)
    _, Fs, rates, _, _ = params.extract_arrays(values, 3, device=dev,
                                               dtype=torch.float32)
    TrMat = tables.transition_matrix(rates).cpu().numpy()
    Fs = Fs.cpu().numpy()
    t0 = time.time()
    mus, _ = refine.position_refinement(tracks, values["LocErr"], ds, Fs,
                                        TrMat)
    torch.cuda.synchronize()
    t_ref = time.time() - t0
    k6, plain = refine_kernel.LAUNCHES, plain_calls()
    frames = int(lens[lens >= 2].sum())
    counted = float((hist * np.arange(1, hist.shape[0] + 1)[:, None]).sum())
    T3 = max(int(k) for k in tracks)
    W6 = refine.default_window(3, T3, 2)
    log(f"phase 11: 3 states, {n_tr} tracks: param_fitting(compute_errors"
        f"=True) {t_fit:.2f} s ({res.n_evals} evals; "
        + ", ".join(f"{k}={p.value:.4g}" for k, p in res.params.items())
        + f"), predict_Bs (frame_len 5, K=243) {t_pred:.2f} s, len_hist "
        f"(window 7, K=2187: wide) {t_hist:.2f} s, position_refinement "
        f"(window {W6}, K={3 ** W6}) {t_ref:.2f} s; whole workflow "
        f"{t_fit + t_pred + t_hist + t_ref:.2f} s; launches K4 {k4}, K5 "
        f"{k5}, K6 {k6}, plain calls {plain}; frames {counted:.1f} of "
        f"{frames} [{card}]")
    if (k4 != len(buckets) or k5 != len(buckets) or k6 != len(buckets)
            or plain != 0 or abs(counted - frames) > TOL_FRAMES * frames
            or len(preds) != len(tracks) or len(mus) != len(tracks)):
        fail("the 3-state workflow did not run through its kernels, or "
             "lost frames")
    kinfo["K5 wide"]["launches"] = k5
    tb3 = tables_of(values, 3)

    def hist_check(tag, got, want, sub):
        L = data.host_lengths(sub)
        return check_hist(tag, got, want, float(L[L >= 2].sum()),
                          kernel="K5 wide")

    errs["K5 wide"].append(wide_bucket_checks(
        "phase 11: K5 wide, 3 states, window 7,", buckets,
        lambda b: hist_kernel.hist(b.positions, b.lengths, b.is_bleached,
                                   tb3, window=7, min_len=min_len),
        lambda b: hist_kernel.hist_plain(b.positions, b.lengths,
                                         b.is_bleached, tb3, window=7,
                                         min_len=min_len), hist_check))
    # a value-only objective at window 7 (K1 on the wide mapping): the
    # likelihood of the fitted model at a longer memory
    spec = params.generate_params(nb_states=3)
    spec.set_values(values)
    obj = fit.make_objective(buckets, spec, 0.02, 3, cell_dims=(0.5,),
                             window=7, min_len=min_len)
    z = torch.tensor(spec.to_unconstrained(), **f32)
    reset_counts()
    t0 = time.time()
    with torch.no_grad():
        v = float(obj(z))
    t_obj = time.time() - t0
    k1, plain = forward_kernel.LAUNCHES, plain_calls()
    log(f"phase 11: 3 states, value-only objective at window 7 (K=2187: "
        f"K1 wide) {v:.4f} in {t_obj:.3f} s; K1 launches {k1}, plain calls "
        f"{plain} [{card}]")
    if k1 != len(buckets) or plain != 0 or not math.isfinite(v):
        fail(f"value-only objective at window 7: K1 launches {k1}, plain "
             f"{plain}, value {v}")
    kinfo["K1 wide"]["launches"] = k1

    def logl_check(tag, got, want, sub):
        err = float((got - want).abs().max())
        ok = torch.allclose(got, want, **TOL_K1) and bool(
            torch.isfinite(got).all())
        log(f"{tag}: logL max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"K1 wide disagrees with forward_plain at {tag}")
        return err

    errs["K1 wide"].append(wide_bucket_checks(
        "phase 11: K1 wide, 3 states, window 7,", buckets,
        lambda b: forward_kernel.forward(b.positions, b.lengths,
                                         b.is_bleached, tb3, window=7,
                                         min_len=min_len),
        lambda b: forward_kernel.forward_plain(b.positions, b.lengths,
                                               b.is_bleached, tb3, window=7,
                                               min_len=min_len),
        logl_check))
    del tracks, buckets, preds, mus

    # ---- 5 states: predict_Bs at its default frame_len 5 (K4 wide) -----
    tracks, states, _ = simulate.sim_fov(**SIM5)
    n_tr = sum(len(v) for v in tracks.values())
    values = {"LocErr": 0.02, "pBL": 0.1,
              **{f"D{i}": d for i, d in enumerate(SIM5["Ds"])},
              **{f"F{i}": 0.2 for i in range(5)},
              **{f"p{i}{j}": 0.03 for i in range(5) for j in range(5)
                 if i != j}}
    buckets = data.from_dict_bucketed(tracks, max_buckets=4, device=dev,
                                      dtype=torch.float32)
    lens = np.concatenate([data.host_lengths(b) for b in buckets])
    min_len = data.default_min_len(lens)
    for b in buckets[:1]:           # warm-up
        predict.predict_batch(b, values, 0.02, 5, cell_dims=(0.5,),
                              window=5)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    out = predict.predict_Bs(tracks, 0.02, values, cell_dims=(0.5,),
                             nb_states=5)
    torch.cuda.synchronize()
    t_pred = time.time() - t0
    k4, plain = predict_kernel.LAUNCHES, plain_calls()
    hits = sum(int((out[k].argmax(-1) == states[k]).sum()) for k in out)
    total = sum(states[k].size for k in out)
    log(f"phase 11: 5 states, predict_Bs on {n_tr} tracks (frame_len 5, "
        f"K=3125: K4 wide) {t_pred:.2f} s; K4 launches {k4}, plain calls "
        f"{plain}; most probable state the simulated one in {hits}/{total} "
        f"frames [{card}]")
    if k4 != len(buckets) or plain != 0:
        fail(f"5-state predict_Bs: K4 launches {k4}, plain calls {plain}")
    kinfo["K4 wide"]["launches"] = k4
    tb5 = tables_of(values, 5)

    def preds_check(tag, got, want, sub):
        (logl, p), (logl0, p0) = got, want
        e = max(float((logl - logl0).abs().max()),
                float((p - p0).abs().max()))
        ok = (torch.allclose(logl, logl0, **TOL_K4_LOGL)
              and torch.allclose(p, p0, **TOL_K4_PREDS))
        log(f"{tag}: logL and preds max_abs_err {e:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"K4 wide disagrees with predict_plain at {tag}")
        return e

    errs["K4 wide"].append(wide_bucket_checks(
        "phase 11: K4 wide, 5 states, W=5,", buckets,
        lambda b: predict_kernel.predict(b.positions, b.lengths,
                                         b.is_bleached, tb5, window=5,
                                         min_len=min_len),
        lambda b: predict_kernel.predict_plain(b.positions, b.lengths,
                                               b.is_bleached, tb5, window=5,
                                               min_len=min_len),
        preds_check, n=256))
    # predict_Bs gives each bucket's K4 result
    for b in buckets:
        _, p = predict_kernel.predict(b.positions, b.lengths, b.is_bleached,
                                      tb5, window=5, min_len=min_len)
        got = data.to_dict(b, p)
        if not all(np.array_equal(got[k], out[k]) for k in got):
            fail(f"5-state predict_Bs differs from K4 on bucket "
                 f"T={b.max_len}")
    del tracks, states, out, buckets

    # ---- 6 states, 1-D tracks of 3-5 frames: refinement (K6 wide) ------
    tracks, _, _ = simulate.sim_fov(**SIM6)
    n_tr = sum(len(v) for v in tracks.values())
    ds6 = np.sqrt(2.0 * np.array(SIM6["Ds"]) * 0.02)
    T6 = max(int(k) for k in tracks)
    W6 = refine.default_window(6, T6, 1)
    buckets = data.from_dict_bucketed(tracks, max_buckets=4, device=dev)
    refine.refine_batch(buckets[0], 0.02, ds6, TR6)          # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    mus, sigmas = refine.position_refinement(tracks, 0.02, ds6,
                                             [1 / 6] * 6, TR6)
    torch.cuda.synchronize()
    t_ref = time.time() - t0
    k6, plain = refine_kernel.LAUNCHES, plain_calls()
    log(f"phase 11: 6 states, position_refinement on {n_tr} 1-D tracks of "
        f"up to {T6} frames: window {W6} (K={6 ** W6}: K6 wide, the JAX "
        f"package's default at T={T6}, D=1) {t_ref:.3f} s; K6 launches "
        f"{k6}, plain calls {plain} [{card}]")
    if k6 != len(buckets) or plain != 0 or W6 != 4:
        fail(f"6-state refinement: K6 launches {k6}, plain calls {plain}, "
             f"window {W6}")
    kinfo["K6 wide"]["launches"] = k6
    lt6 = tables.cap_log(torch.tensor(TR6, **f32))
    sig2_6 = torch.tensor(ds6, **f32) ** 2
    l2_6 = torch.full((1, 1, 1), 0.02 ** 2, **f32)
    for b in buckets:
        mu, sig = on_card(refine.refine_batch(b, 0.02, ds6, TR6), dev)
        got_mu = data.to_dict(b, mu)
        if not all(np.array_equal(got_mu[k], mus[k]) for k in got_mu):
            fail(f"6-state position_refinement differs from K6 on bucket "
                 f"T={b.max_len}")
        n = min(WIDE_CHECK, b.batch_size)
        mu0, sig0 = refine_kernel.refine_plain(
            b.positions[:n], b.lengths[:n], l2_6, lt6, sig2_6, window=W6)
        errs["K6 wide"].append(check_refine(
            f"phase 11: K6 wide, 6 states, W={W6}, bucket T={b.max_len}, "
            f"first {n} tracks", mu[:n], sig[:n], mu0, sig0,
            b.positions[:n], b.lengths[:n], l2_6))
    del tracks, buckets, mus, sigmas
    log(f"phase 11: paths {time.time() - t11:.1f} s")

    # ---- bare times at the main paths' registers ------------------------
    for name, S, W, D in WIDE_TIMES:
        n = WIDE_K6_TRACKS if name == "K6 wide" else WIDE_TRACKS
        bench = bench_buckets(dev, n=n, D=D)
        blens = np.concatenate([data.host_lengths(b) for b in bench])
        K = S ** W
        info = kinfo[name]
        rows = sum(b.positions.numel() for b in bench) * 4
        if name == "K6 wide":
            tr = np.full((S, S), 0.1 / (S - 1)) + np.eye(S) * (0.9 - 0.1
                                                               / (S - 1))
            lt = tables.cap_log(torch.tensor(tr, **f32))
            s2 = torch.tensor((0.08 * (1 + np.arange(S))) ** 2, **f32)
            l2 = torch.full((1, 1, 1), 4e-4, **f32)
            tabs = [t.contiguous() for t in (
                *refine_kernel.build_refine_tables(lt, s2, W)[:2],
                *refine_kernel.build_refine_tables(lt.T, s2, W))]
            prep = [(b.positions, b.lengths.to(torch.int32),
                     l2.expand(b.positions.shape).contiguous())
                    for b in bench]

            def bare():
                for p_, l_, e_ in prep:
                    refine_kernel.launch(p_, l_, e_, tabs, S)

            def plain_run():
                for b in bench:
                    m = b.batch_size // PLAIN_SHARE
                    refine_kernel.refine_plain(b.positions[:m],
                                               b.lengths[:m], l2, lt, s2,
                                               window=W)
            nbytes = 2 * rows + 4 * len(blens) + 2 * rows
            ops = walk_ops(blens, K, S, D, "K6", S=S)
        else:
            rates = torch.full((S, S), 0.1, **f32)
            rates.fill_diagonal_(0.0)
            tb = tables.build_tables(
                torch.linspace(0.0, 0.08, S, **f32),
                torch.tensor(0.02, **f32), torch.full((S,), 1.0 / S, **f32),
                rates, torch.tensor(0.1, **f32), 0.02, cell_dims=(0.5,))
            args = []
            for b in bench:
                d, t = forward_kernel.kernel_inputs(
                    b.positions, b.lengths, b.is_bleached, tb, W, 1)
                args.append((b, d, [x.detach() for x in t]))
            if name == "K1 wide":
                def bare():
                    for _, d, t in args:
                        forward_kernel.launch(d, t, 3)
                plain_fn = forward_kernel.forward_plain
                nbytes = 2 * rows + 12 * len(blens)
                ops = walk_ops(blens, K, S, D, "K1")
            elif name == "K4 wide":
                def bare():
                    for _, d, t in args:
                        predict_kernel.launch(d, t, 3, S, W)
                plain_fn = predict_kernel.predict_plain
                nbytes = 2 * rows + 12 * len(blens) + sum(
                    b.batch_size * b.max_len for b in bench) * S * 4
                ops = walk_ops(blens, K, S, D, "K4", T=10, W=W, S=S)
            else:
                def bare():
                    for _, d, t in args:
                        hist_kernel.launch(d, t, 3, S, W)
                plain_fn = hist_kernel.hist_plain
                nbytes = 2 * rows + 8 * len(blens) + sum(
                    (W + 2) * S * b.max_len * K * 4 for b in bench)
                ops = sum(walk_ops(data.host_lengths(b), K, S, D, "K5",
                                   T=b.max_len, W=W, S=S) for b in bench)

            def plain_run(_fn=plain_fn):
                with torch.no_grad():
                    for b in bench:
                        m = b.batch_size // PLAIN_SHARE
                        for i in range(0, m, WIDE_PLAIN_CHUNK):
                            sl = slice(i, min(i + WIDE_PLAIN_CHUNK, m))
                            _fn(b.positions[sl], b.lengths[sl],
                                b.is_bleached[sl], tb, window=W, min_len=3)
        info["ms"] = cuda_ms(bare, 5)
        info["plain_ms"] = cuda_ms(plain_run, 1, warmup=0)
        info["plain_tracks"] = sum(b.batch_size // PLAIN_SHARE
                                   for b in bench)
        info["bound_ms"], info["bound_by"] = bound(nbytes, ops)
        log(f"phase 11: {name} S={S} W={W} (K={K}) D={D}, {len(blens)} "
            f"tracks of lengths 3..10 ({len(bench)} buckets): kernel "
            f"{info['ms']:.3f} ms = {len(blens) / info['ms'] * 1e3 / 1e6:.4f}"
            f"M tracks/s; plain {info['plain_ms']:.3f} ms on "
            f"{info['plain_tracks']} of the tracks; bound "
            f"{info['bound_ms']:.4f} ms ({info['bound_by']}), "
            f"{info['ms'] / info['bound_ms']:.1f}x [{card}]")
        del bench
    log(f"phase 11: {time.time() - t11:.1f} s")


def phase12(dev, card, kinfo, errs, reset_counts, plain_calls):
    """Past 4096 slots: K4 and K5 at the JAX package's defaults where the
    register passes 4096 slots (``len_hist`` at 4 states, window 7, K =
    16384; at two sub-steps a frame, window 7 = 13 sub-steps, K = 8192;
    ``predict_Bs`` at 6 states, frame_len 5, K = 7776), each with its
    launches, 0 plain calls, its wall time and each whole bucket against
    its plain version; ``tracking.Proba_Cs`` (K1) and
    ``refine.get_best_estimates`` (K4 at K = 3^8 = 6561) at 3 states; then
    the three kernels' bare times beside their bounds and plain
    versions."""
    from extrack_tpu_torch import (data, histograms, params, predict,
                                   refine, simulate, tracking)
    from extrack_tpu_torch.core import tables
    from extrack_tpu_torch.ops import (forward_kernel, hist_kernel,
                                       predict_kernel)
    t12 = time.time()
    f32 = dict(dtype=torch.float32, device=dev)

    def values_of(S, Ds, p):
        return {"LocErr": 0.02, "pBL": 0.1,
                **{f"D{i}": d for i, d in enumerate(Ds)},
                **{f"F{i}": 1 / S for i in range(S)},
                **{f"p{i}{j}": p for i in range(S) for j in range(S)
                   if i != j}}

    def chunked(fn, b, n=PAST_PLAIN_CHUNK):
        """``fn`` over a bucket's tracks in chunks of ``n`` (the plain
        versions carry K floats per track and frame, and more)."""
        with torch.no_grad():
            return [fn(*(x[i:i + n] for x in (b.positions, b.lengths,
                                               b.is_bleached)))
                    for i in range(0, b.batch_size, n)]

    # ---- len_hist past 4096 slots: 4 states (K = 4^7) and two sub-steps
    # a frame (K = 2^13), at the default window 7 ----
    for name, sim, S, n in (("K5 past 4096", SIM4, 4, 1),
                            ("K5 n=2 past 4096", SIM2N, 2, 2)):
        tracks, _, _ = simulate.sim_fov(**sim)
        n_tr = sum(len(v) for v in tracks.values())
        values = values_of(S, sim["Ds"], 0.04 if S == 4 else 0.1)
        buckets = data.from_dict_bucketed(tracks, max_buckets=4, device=dev,
                                          dtype=torch.float32)
        W = n * 6 + 1
        K = S ** W
        reset_counts()
        t0 = time.time()
        hist = histograms.len_hist(tracks, values, 0.02, cell_dims=(0.5,),
                                   nb_states=S, nb_substeps=n)
        t_h = time.time() - t0
        k5, plain = hist_kernel.LAUNCHES, plain_calls()
        log(f"phase 12: len_hist(nb_states={S}, nb_substeps={n}) on {n_tr} "
            f"tracks, window 7 ({W} sub-steps, K={K}) {t_h:.2f} s; K5 "
            f"launches {k5}, plain calls {plain} [{card}]")
        if k5 != len(buckets) or plain != 0:
            fail(f"len_hist past 4096 slots (S={S}, n={n}): K5 launches "
                 f"{k5}, plain calls {plain}")
        kinfo[name]["launches"] = k5
        Ds, Fs, rates, loc, pBL = params.extract_arrays(values, S, **f32)
        tb = tables.build_tables(Ds, loc, Fs, rates, pBL, 0.02,
                                 cell_dims=(0.5,), nb_substeps=n)
        min_len = data.default_min_len(
            np.concatenate([data.host_lengths(b) for b in buckets]))
        kw = dict(window=W, min_len=min_len, nb_substeps=n)
        summed = np.zeros_like(hist)
        for b in buckets:
            h = hist_kernel.hist(b.positions, b.lengths, b.is_bleached, tb,
                                 **kw)
            h0 = sum(chunked(lambda p, l_, i: hist_kernel.hist_plain(
                p, l_, i, tb, **kw), b))
            L = data.host_lengths(b)
            errs[name].append(check_hist(
                f"phase 12: {name}, bucket T={b.max_len} B={b.batch_size}",
                h, h0, float(L[L >= 2].sum()), kernel=name))
            summed[:b.max_len] += h.double().cpu().numpy()
        frames = sum(int(k) * len(v) for k, v in tracks.items())
        if not np.array_equal(summed, hist) or abs(
                float((hist * np.arange(1, hist.shape[0] + 1)[:, None]
                       ).sum()) - frames) > TOL_FRAMES * frames:
            fail(f"len_hist (S={S}, n={n}) differs from its buckets or "
                 "loses frames")
        del tracks, buckets

    # ---- predict_Bs at 6 states and its default frame_len 5 (K = 6^5) --
    tracks, states, _ = simulate.sim_fov(**SIM6P)
    n_tr = sum(len(v) for v in tracks.values())
    values = values_of(6, SIM6P["Ds"], 0.02)
    buckets = data.from_dict_bucketed(tracks, max_buckets=4, device=dev,
                                      dtype=torch.float32)
    min_len = data.default_min_len(
        np.concatenate([data.host_lengths(b) for b in buckets]))
    reset_counts()
    t0 = time.time()
    out = predict.predict_Bs(tracks, 0.02, values, cell_dims=(0.5,),
                             nb_states=6)
    torch.cuda.synchronize()
    t_pred = time.time() - t0
    k4, plain = predict_kernel.LAUNCHES, plain_calls()
    hits = sum(int((out[k].argmax(-1) == states[k]).sum()) for k in out)
    total = sum(states[k].size for k in out)
    log(f"phase 12: 6 states, predict_Bs on {n_tr} tracks (frame_len 5, "
        f"K=7776) {t_pred:.2f} s; K4 launches {k4}, plain calls {plain}; "
        f"most probable state the simulated one in {hits}/{total} frames "
        f"[{card}]")
    if k4 != len(buckets) or plain != 0:
        fail(f"6-state predict_Bs: K4 launches {k4}, plain calls {plain}")
    kinfo["K4 past 4096"]["launches"] = k4
    Ds, Fs, rates, loc, pBL = params.extract_arrays(values, 6, **f32)
    tb6 = tables.build_tables(Ds, loc, Fs, rates, pBL, 0.02,
                              cell_dims=(0.5,))
    for b in buckets:
        logl, p = predict_kernel.predict(b.positions, b.lengths,
                                         b.is_bleached, tb6, window=5,
                                         min_len=min_len)
        parts = chunked(lambda x, l_, i: predict_kernel.predict_plain(
            x, l_, i, tb6, window=5, min_len=min_len), b)
        logl0 = torch.cat([q[0] for q in parts])
        p0 = torch.cat([q[1] for q in parts])
        e = max(float((logl - logl0).abs().max()),
                float((p - p0).abs().max()))
        ok = (torch.allclose(logl, logl0, **TOL_K4_LOGL)
              and torch.allclose(p, p0, **TOL_K4_PREDS))
        got = data.to_dict(b, p)
        same = all(np.array_equal(got[k], out[k]) for k in got)
        log(f"phase 12: K4 past 4096, 6 states, W=5, bucket T={b.max_len} "
            f"B={b.batch_size}: logL and preds max_abs_err {e:.3e}; "
            f"predict_Bs gives the bucket's K4 result: {same} "
            f"{'ok' if ok and same else 'FAIL'}")
        if not (ok and same):
            fail(f"K4 past 4096 slots disagrees with predict_plain or with "
                 f"predict_Bs on bucket T={b.max_len}")
        errs["K4 past 4096"].append(e)
    del tracks, buckets, out

    # ---- 3 states: Proba_Cs (K1) and get_best_estimates (K4, K = 3^8) on
    # the simulated tracks of T_b frames ----
    tracks, _, _ = simulate.sim_fov(**SIM3B)
    # the most populated length past the window of 8 frames
    T_b = max((int(k) for k in tracks if int(k) > 8),
              key=lambda k: len(tracks[str(k)]))
    Cs = tracks[str(T_b)]
    ds3 = np.sqrt(2.0 * np.array(SIM3B["Ds"]) * 0.02)
    Fs3 = np.full(3, 1 / 3)
    reset_counts()
    t0 = time.time()
    logl = tracking.Proba_Cs(Cs, 0.02, ds3, Fs3, TR3, 0.1, 0, (0.5,))
    torch.cuda.synchronize()
    t_p = time.time() - t0
    k1, plain = forward_kernel.LAUNCHES, plain_calls()
    logl0 = tracking.Proba_Cs(Cs, 0.02, ds3, Fs3, TR3, 0.1, 0, (0.5,),
                              device="cpu")
    e = float((logl.double().cpu() - logl0).abs().max())
    ok = (k1 == 1 and plain == 0 and torch.allclose(
        logl.double().cpu(), logl0, **TOL_K1))
    log(f"phase 12: Proba_Cs on {len(Cs)} 3-state tracks of {T_b} "
        f"frames (frame_len 6, K=729: K1) {t_p:.3f} s; K1 launches {k1}, "
        f"plain calls {plain}; against the plain engine in float64 "
        f"max_abs_err {e:.3e} {'ok' if ok else 'FAIL'} [{card}]")
    if not ok:
        fail("Proba_Cs: K1 did not run once or disagrees with the plain "
             "engine")
    errs["K1 wide"].append(e)
    reset_counts()
    t0 = time.time()
    mus, sigs = refine.get_best_estimates(Cs, 0.02, ds3, Fs3, TR3)
    t_b = time.time() - t0
    k4, plain = predict_kernel.LAUNCHES, plain_calls()
    log(f"phase 12: get_best_estimates on {len(Cs)} 3-state tracks of "
        f"{T_b} frames (window 8, K=6561: K4) {t_b:.3f} s; K4 launches "
        f"{k4}, plain calls {plain} [{card}]")
    if k4 != 1 or plain != 0:
        fail(f"get_best_estimates: K4 launches {k4}, plain calls {plain}")
    tb3 = refine.matrix_tables(0.02, ds3, Fs3, TR3, dev, torch.float32)
    pos = torch.as_tensor(Cs, **f32)
    lens = torch.full((len(Cs),), T_b, dtype=torch.int32, device=dev)
    isbl = torch.zeros(len(Cs), **f32)
    b3 = data.TrackBatch(pos, lens, is_bleached=isbl)
    _, p = predict_kernel.predict(pos, lens, isbl, tb3, window=8, min_len=2)
    p0 = torch.cat([q[1] for q in chunked(
        lambda x, l_, i: predict_kernel.predict_plain(
            x, l_, i, tb3, window=8, min_len=2), b3)])
    e = float((p - p0).abs().max())
    mu_k, sig_k = refine.refine_positions_fixed_states(
        pos, lens, tb3.loc_err2, torch.as_tensor(ds3 ** 2, **f32),
        p.argmax(-1))
    mus64, _ = refine.get_best_estimates(Cs[:BEST_CHECK], 0.02, ds3, Fs3,
                                         TR3, device="cpu")
    near = float(np.mean(np.isclose(mus[:BEST_CHECK], mus64, **TOL_K6_MU)))
    ok = (torch.allclose(p, p0, **TOL_K4_PREDS)
          and np.array_equal(mus, mu_k.cpu().numpy())
          and np.array_equal(sigs, sig_k.cpu().numpy()) and near >= 0.99)
    log(f"phase 12: get_best_estimates' K4 posteriors against the plain "
        f"version max_abs_err {e:.3e}; its positions are the fixed-state "
        f"refinement's at the K4 argmax states; within mu's tolerance of "
        f"the float64 plain run (first {BEST_CHECK} tracks, on the CPU) at "
        f"{near:.4%} of the positions "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("get_best_estimates disagrees with its parts on the card")
    errs["K4 past 4096"].append(e)
    del tracks
    log(f"phase 12: paths {time.time() - t12:.1f} s")

    # ---- bare times at the paths' registers ----------------------------
    for name, S, W, n, ntr in PAST_TIMES:
        bench = bench_buckets(dev, n=ntr)
        blens = np.concatenate([data.host_lengths(b) for b in bench])
        K, A = S ** W, S ** n
        info = kinfo[name]
        rows = sum(b.positions.numel() for b in bench) * 4
        rates = torch.full((S, S), 0.1, **f32)
        rates.fill_diagonal_(0.0)
        tb = tables.build_tables(
            torch.linspace(0.0, 0.08, S, **f32), torch.tensor(0.02, **f32),
            torch.full((S,), 1.0 / S, **f32), rates, torch.tensor(0.1, **f32),
            0.02, cell_dims=(0.5,), nb_substeps=n)
        args = []
        for b in bench:
            d, t = forward_kernel.kernel_inputs(
                b.positions, b.lengths, b.is_bleached, tb, W, n)
            args.append((b, d, [x.detach() for x in t]))
        if name.startswith("K4"):
            def bare():
                for _, d, t in args:
                    predict_kernel.launch(d, t, 3, S, W)

            def plain_one(b):
                return predict_kernel.predict_plain(
                    b.positions, b.lengths, b.is_bleached, tb, window=W,
                    min_len=3)
            nbytes = 2 * rows + 12 * len(blens) + sum(
                b.batch_size * b.max_len for b in bench) * S * 4
            ops = walk_ops(blens, K, S, 2, "K4", T=10, W=W, S=S)
        else:
            wf = (W - 1) // n + 1

            def bare():
                for _, d, t in args:
                    hist_kernel.launch(d, t, 3, S, W, n)

            def plain_one(b):
                return hist_kernel.hist_plain(
                    b.positions, b.lengths, b.is_bleached, tb, window=W,
                    min_len=3, nb_substeps=n)
            nbytes = 2 * rows + 8 * len(blens) + sum(
                (wf + 2) * S * b.max_len * K * 4 for b in bench)
            ops = sum(walk_ops(data.host_lengths(b), K, A, 2, "K5",
                               T=b.max_len, W=W, S=S) for b in bench)

        def plain_run():
            for b in bench:
                for i in range(0, b.batch_size, PAST_PLAIN_CHUNK):
                    sl = slice(i, i + PAST_PLAIN_CHUNK)
                    with torch.no_grad():
                        plain_one(data.TrackBatch(
                            b.positions[sl], b.lengths[sl],
                            is_bleached=b.is_bleached[sl]))
        info["ms"] = cuda_ms(bare, 3)
        info["plain_ms"] = cuda_ms(plain_run, 1, warmup=0)
        info["bound_ms"], info["bound_by"] = bound(nbytes, ops)
        log(f"phase 12: {name} S={S} W={W} n={n} (K={K}) D=2, {len(blens)} "
            f"tracks of lengths 3..10 ({len(bench)} buckets): kernel "
            f"{info['ms']:.3f} ms = {len(blens) / info['ms'] * 1e3 / 1e6:.4f}"
            f"M tracks/s; plain {info['plain_ms']:.3f} ms; bound "
            f"{info['bound_ms']:.4f} ms ({info['bound_by']}), "
            f"{info['ms'] / info['bound_ms']:.1f}x [{card}]")
        del bench, args
    log(f"phase 12: {time.time() - t12:.1f} s")


def phase13(dev, card, kinfo, errs, reset_counts, plain_calls, host_counts):
    """Simulate on the card, fit, and draw HMC posterior samples from the
    fit's warm start (``host_counts``: phase 3's host ``sim_fov`` lengths,
    the same model at 10^5 requested tracks)."""
    from extrack_tpu_torch import data, fit, params, sample, simulate
    from extrack_tpu_torch.core import tables
    from extrack_tpu_torch.ops import (forward_kernel, grad_kernel,
                                       hvp_kernel)
    t13 = time.time()
    f32 = dict(dtype=torch.float32, device=dev)

    # ---- sim_fov_batch at 10^6 requested tracks ----------------------------
    torch.cuda.synchronize()
    t0 = time.time()
    batches, states = simulate.sim_fov_batch(**SIM_DEV)
    torch.cuda.synchronize()
    t_sim = time.time() - t0
    lens = np.concatenate([b.np_lengths for b in batches])
    n_dev = len(lens)
    bad = []
    for b, st in zip(batches, states):
        le = b.lengths.cpu().numpy()
        valid = torch.arange(b.max_len, device=dev)[None, :] < b.lengths[:,
                                                                          None]
        if not (np.array_equal(le, b.np_lengths)
                and le.min() >= SIM_DEV["min_track_len"]
                and b.lengths.dtype == torch.int32
                and st.dtype == torch.int8
                and b.positions.dtype == torch.float32
                and bool((b.positions[~valid] == 0).all())
                and bool(torch.isfinite(b.positions).all())
                and np.array_equal(b.is_bleached.cpu().numpy(),
                                   (le < lens.max()).astype(np.float32))):
            bad.append(b.max_len)
    n_host = sum(host_counts.values())
    req = SIM_DEV["nb_tracks"] / SIM["nb_tracks"]
    mean_host = (sum(L * c for L, c in host_counts.items()) / n_host)
    yield_err = abs(n_dev / req - n_host) / n_host
    mean_err = abs(lens.mean() - mean_host) / mean_host
    log(f"phase 13: sim_fov_batch on the card, {SIM_DEV['nb_tracks']} "
        f"requested tracks (T={SIM_DEV['max_track_len']}, cells "
        f"{SIM_DEV['cell_dims']}): {n_dev} tracks in {len(batches)} buckets "
        f"(T={[b.max_len for b in batches]}) in {t_sim:.2f} s; invariants "
        f"(lengths, dtypes, zero padding, bleach flags) "
        f"{'ok' if not bad else f'FAIL at T={bad}'} [{card}]")
    shares = []
    for L in sorted(host_counts):
        c_dev = int((lens == L).sum()) / req
        c_host = host_counts[L]
        rel = abs(c_dev - c_host) / c_host
        shares.append(c_host < 400 or rel < 0.15)
        log(f"phase 13: length {L}: card {int((lens == L).sum())} "
            f"({c_dev:.1f} per 10^5 requested), host sim_fov {c_host}, "
            f"rel {rel:.3f}")
    ok = not bad and yield_err < 0.05 and mean_err < 0.03 and all(shares)
    log(f"phase 13: yield per 10^5 requested {n_dev / req:.1f} vs host "
        f"{n_host} (rel {yield_err:.4f}, tol 0.05), mean length "
        f"{lens.mean():.4f} vs {mean_host:.4f} (rel {mean_err:.4f}, tol "
        f"0.03), populous lengths within 0.15 "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("sim_fov_batch: invariants or length distribution")
    del states

    # ---- the fit with error bars on the card's batches ---------------------
    spec = params.generate_params(
        nb_states=2, LocErr_type=1, LocErr_bounds=(0.005, 0.1),
        D_max=3.0, estimated_transition_rates=0.1)
    reset_counts()
    t0 = time.time()
    res = fit.fit(batches, spec, 0.02, 2, cell_dims=(0.5,),
                  compute_errors=True, max_iter=FIT_ITERS)
    torch.cuda.synchronize()
    t_fit = time.time() - t0
    k2, k3, plain = grad_kernel.LAUNCHES, hvp_kernel.LAUNCHES, plain_calls()
    d1, le_fit = res.params["D1"].value, res.params["LocErr"].value
    d1_big = d1
    ok = (abs(d1 - SIM["Ds"][1]) < TOL_SIM_FIT["D1"]
          and abs(le_fit - SIM["LocErr"]) < TOL_SIM_FIT["LocErr"]
          and k3 == len(spec.free_names()) * len(batches) and plain == 0
          and k2 > 0)
    log(f"phase 13: fit with error bars on {n_dev} card-simulated tracks "
        f"{t_fit:.2f} s ({res.n_evals} evals, {res.message}): D1 {d1:.6f} "
        f"+/- {res.std_errors['D1_minus_D0']:.2e} (simulated "
        f"{SIM['Ds'][1]}, tol {TOL_SIM_FIT['D1']}), LocErr {le_fit:.6f} "
        f"+/- {res.std_errors['LocErr']:.2e} (simulated {SIM['LocErr']}, "
        f"tol {TOL_SIM_FIT['LocErr']}); K2 launches {k2}, K3 launches {k3}, "
        f"plain calls {plain} {'ok' if ok else 'FAIL'} [{card}]")
    if not ok:
        fail("the fit on the card's simulation missed D1 or LocErr, or its "
             "launches are off")

    # ---- a ~10^4-track subset: warm-start fit with error bars --------------
    step = max(1, n_dev // SAMPLE_TRACKS)
    sub = {}
    for b in batches:
        part = data.TrackBatch(b.positions[::step], b.lengths[::step],
                               np_lengths=b.np_lengths[::step])
        sub.update(data.to_dict(part))
    del batches
    n_sub = sum(len(v) for v in sub.values())
    reset_counts()
    t0 = time.time()
    warm = fit.param_fitting(sub, 0.02, params=res.params.copy(),
                             nb_states=2, compute_errors=True,
                             cell_dims=(0.5,), verbose=0, max_iter=FIT_ITERS)
    torch.cuda.synchronize()
    t_warm = time.time() - t0
    k2, k3, plain = grad_kernel.LAUNCHES, hvp_kernel.LAUNCHES, plain_calls()
    fisher = warm.std_errors
    log(f"phase 13: warm-start fit with error bars on a {n_sub}-track "
        f"subset (every {step}th) {t_warm:.2f} s ({warm.n_evals} evals): "
        + ", ".join(f"{k}={p.value:.5g} +/- {fisher.get(k, 0.0):.2e}"
                    for k, p in warm.params.items() if k in fisher)
        + f"; K2 launches {k2}, K3 launches {k3}, plain calls {plain} "
        f"[{card}]")
    if plain != 0 or k3 == 0:
        fail("the warm-start fit did not run K2 and K3 alone")

    # ---- K2 at the sampler's buckets: parity, bare time, bound -------------
    nbk = SAMPLE_KW["max_buckets"]
    buckets = data.from_dict_bucketed(sub, max_buckets=nbk, device=dev)
    n_b = len(buckets)
    sub_lens = np.concatenate([data.host_lengths(b) for b in buckets])
    min_len = data.default_min_len(sub_lens)
    # the tables at the fit's start (as phase 3): at the optimum the table
    # cotangents are sums that cancel to near 0, below what f32 resolves
    # against a relative tolerance (the potential's check below takes the
    # warm start, against its absolute tolerance)
    vals = spec.resolve()
    Ds, Fs, rates, loc_err, pBL = params.extract_arrays(vals, 2, **f32)
    tb = tables.build_tables(Ds, loc_err, Fs, rates, pBL, 0.02,
                             cell_dims=(0.5,))
    window = fit.default_window(2)
    kw = dict(window=window, nb_substeps=1, min_len=min_len)
    for b in buckets:
        errs["K2 sample"].append(check_table_grads(
            f"phase 13: K2 sampler bucket T={b.max_len} B={b.batch_size}",
            b.positions, b.lengths, b.is_bleached, tb, **kw))
    args = [forward_kernel.kernel_inputs(b.positions, b.lengths,
                                         b.is_bleached, tb, window, 1)
            for b in buckets]
    args = [(d, [t.detach() for t in tabs]) for d, tabs in args]

    def k2_eval():
        for d, tabs in args:
            grad_kernel.launch(d, tabs, min_len)

    def p2_eval():
        for b in buckets:
            grad_kernel.value_and_table_grads_plain(
                b.positions, b.lengths, b.is_bleached, tb, **kw)

    # the potential the sampler differentiates, as sample_posterior builds
    # it: -logL over the same buckets minus the log-Jacobian
    obj = fit.make_objective(buckets, warm.params, 0.02, 2,
                             cell_dims=(0.5,))
    z0 = torch.tensor(warm.params.to_unconstrained(), **f32)

    def potential_eval(objective=obj, z=z0):
        z = z.detach().requires_grad_(True)
        u = objective(z) - warm.params.unconstrained_log_jacobian(z)
        (g,) = torch.autograd.grad(u, z)
        return u.detach(), g

    info = kinfo["K2 sample"]
    info["ms"] = cuda_ms(k2_eval, 20)
    info["wrapper_ms"] = cuda_ms(potential_eval, 20)
    info["plain_ms"] = cuda_ms(p2_eval, 3)
    rows = sum(b.positions.numel() for b in buckets) * 4
    info["bound_ms"], info["bound_by"] = bound(
        3 * rows + 12 * n_sub, walk_ops(sub_lens, 2 ** window, 2, 2, "K2"))
    log(f"phase 13: K2 on the sampler's {n_b} buckets ({n_sub} tracks, "
        f"W={window}): one evaluation's launches {info['ms']:.4f} ms bare, "
        f"{info['wrapper_ms']:.4f} ms as the sampler's potential (value and "
        f"z-gradient); plain {info['plain_ms']:.3f} ms; bound "
        f"{info['bound_ms']:.5f} ms ({info['bound_by']}) [{card}]")
    # the potential and its z-gradient at z0 against the plain version in
    # float64 on the same subset (on the CPU: the card's entry points take
    # float32)
    reset_counts()
    u_k, g_k = potential_eval()
    k2_pot, plain_pot = grad_kernel.LAUNCHES, plain_calls()
    b64 = data.from_dict_bucketed(sub, max_buckets=nbk, device="cpu")
    obj64 = fit.make_objective(b64, warm.params, 0.02, 2, cell_dims=(0.5,))
    u_p, g_p = (x.to(dev) for x in potential_eval(obj64, z0.cpu().double()))
    ok = (k2_pot == n_b and plain_pot == 0
          and torch.allclose(u_k.double(), u_p, **TOL_K2_VALUE)
          and torch.allclose(g_k.double(), g_p, **TOL_Z_GRAD))
    log(f"phase 13: potential at z0 on the card {float(u_k):.4f} vs plain "
        f"float64 {float(u_p):.4f} (rel "
        f"{abs(float(u_k) - float(u_p)) / abs(float(u_p)):.2e}, tol "
        f"{TOL_K2_VALUE}); z-gradient max_abs_err "
        f"{float((g_k.double() - g_p).abs().max()):.3e} (|g|max "
        f"{float(g_p.abs().max()):.3e}, tol {TOL_Z_GRAD}); K2 launches "
        f"{k2_pot}, plain calls {plain_pot} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the HMC potential on the card disagrees with the plain "
             "version")
    del b64, obj64

    # ---- sample_posterior from the warm start, with its Fisher errors -------
    C, W, S = (SAMPLE_KW[k] for k in ("num_chains", "num_warmup",
                                      "num_samples"))
    L = SAMPLE_KW["n_leapfrog"]
    steps_a = max(2 * W // 3, 1)
    iters = steps_a + max(W - steps_a, 1) + S
    want_k2 = C * n_b * (1 + iters * (L + 1))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    out = sample.sample_posterior(sub, 0.02, warm.params, nb_states=2,
                                  cell_dims=(0.5,), fisher_sd=fisher,
                                  **SAMPLE_KW)
    torch.cuda.synchronize()
    t_s = time.time() - t0
    k2, k1, plain = (grad_kernel.LAUNCHES, forward_kernel.LAUNCHES,
                     plain_calls())
    info["launches"] = k2
    d1s = out.samples["D1_minus_D0"] + out.samples["D0"]
    mean, sd = float(d1s.mean()), float(d1s.std())
    se = fisher["D1_minus_D0"]
    rhat = out.rhat["D1_minus_D0"]
    log(f"phase 13: sample_posterior on {n_sub} tracks ({n_b} buckets), "
        f"{C} chains x ({W} warmup + {S} samples), {L} leapfrog steps: "
        f"{t_s:.2f} s; acceptance {out.accept_rate:.3f}, step size "
        f"{out.step_size:.4g} [{card}]")
    for line in out.summary().splitlines():
        log(f"phase 13:   {line}")
    per_iter = t_s / (C * iters) * 1e3
    k2_iter = info["ms"] * (L + 1)
    log(f"phase 13: {per_iter:.3f} ms per HMC iteration against bare K2 "
        f"{k2_iter:.4f} ms ({L + 1} evaluations x {n_b} launches): host "
        f"share {1 - k2_iter / per_iter:.4f} [{card}]")
    ok_k = k2 == want_k2 and k1 == 0 and plain == 0
    log(f"phase 13: sampler K2 launches {k2} = {C} chains x {n_b} buckets x "
        f"(1 + {iters} iterations x ({L} + 1)) = {want_k2}: {k2 == want_k2}; "
        f"K1 launches {k1}, plain calls {plain} {'ok' if ok_k else 'FAIL'}")
    if not ok_k:
        fail("the sampler's launches differ from its formula, or it called "
             "a plain version")
    d_big = abs(mean - d1_big) / sd
    d_sim = abs(mean - SIM["Ds"][1]) / sd
    ok = (rhat < RHAT_MAX and d_big < SAMPLE_SDS
          and se / SAMPLE_SDS < sd < SAMPLE_SDS * se
          and 0.0 < out.accept_rate <= 1.0)
    log(f"phase 13: posterior D1 {mean:.6f} +/- {sd:.3e}: R-hat {rhat:.4f} "
        f"(< {RHAT_MAX}), ESS {out.ess['D1_minus_D0']:.1f}; "
        f"{d_big:.2f} sd from the {n_dev}-track fit's D1 {d1_big:.6f} "
        f"(< {SAMPLE_SDS}); sd / Fisher error {sd / se:.3f} (within "
        f"{SAMPLE_SDS}x); {d_sim:.2f} sd from the simulated D1 "
        f"{SIM['Ds'][1]} (the model's shortfall, shared with the JAX "
        f"package: tests/fit_bias_check.py) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the posterior did not converge or misses the fit")

    # where the potential's host time goes (after the timed run: the
    # profiler's hooks stay out of it): CUDA launches and the heaviest
    # host operations of PROFILE_EVALS gradients (torch.profiler)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_EVALS):
            potential_eval()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    launches = sum(e.count for e in ev if e.key == "cudaLaunchKernel")
    top = sorted((e for e in ev if not e.key.startswith("cuda")),
                 key=lambda e: e.self_cpu_time_total, reverse=True)[:5]
    log(f"phase 13: one gradient of the potential makes "
        f"{launches / PROFILE_EVALS:.0f} kernel launches; most host time "
        f"(self, a gradient, under the profiler): " + ", ".join(
            f"{e.key} {e.self_cpu_time_total / PROFILE_EVALS / 1e3:.3f} ms "
            f"({e.count // PROFILE_EVALS} calls)" for e in top))

    # ---- dispatch_chunk invariance on the card -----------------------------
    tiny = {k: v[:max(1, CHUNK_TRACKS * len(v) // n_sub)]
            for k, v in sub.items()}
    runs = [sample.sample_posterior(tiny, 0.02, nb_states=2,
                                    cell_dims=(0.5,), dispatch_chunk=c,
                                    **CHUNK_KW) for c in (4, 10_000)]
    same = all(np.array_equal(runs[0].samples[k], runs[1].samples[k])
               for k in runs[0].samples)
    log(f"phase 13: sample_posterior on {sum(len(v) for v in tiny.values())}"
        f" tracks at dispatch_chunk 4 and 10000: samples bit-identical "
        f"{same} {'ok' if same else 'FAIL'}")
    if not same:
        fail("dispatch_chunk changed the samples on the card")

    # ---- brownian_frames at 2^20 x 10 frames -------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bf = dict(BROWNIAN)
    ms_bf = cuda_ms(lambda: simulate.brownian_frames(gen, **bf), 5)
    x, st = simulate.brownian_frames(gen, **bf)
    x = x.double()
    dx2 = ((x[:, 1:] - x[:, :-1]) ** 2).mean(-1)
    d2 = 2.0 * torch.tensor(bf["Ds"], dtype=torch.float64, device=dev) \
        * bf["dt"]
    stl = st.long()
    want = (d2[stl[:, :-1]] + d2[stl[:, 1:]]) / 2 + 2 * bf["loc_err"] ** 2
    occ = float(st.double().mean())
    switch = float((st[:, 1:] != st[:, :-1]).double().mean())
    ratio = float(dx2.mean() / want.mean())
    ok = (abs(occ - 0.5) < 0.005 and abs(switch - 0.1) < 0.003
          and abs(ratio - 1.0) < 0.01 and tuple(x.shape) == (
              bf["nb_tracks"], bf["track_len"], 2))
    log(f"phase 13: brownian_frames {bf['nb_tracks']} x {bf['track_len']} "
        f"frames {ms_bf:.3f} ms; state-1 share {occ:.4f} (0.5), switches "
        f"{switch:.4f} (0.1), displacement variance / model "
        f"{ratio:.4f} {'ok' if ok else 'FAIL'} [{card}]")
    if not ok:
        fail("brownian_frames moments")
    log(f"phase 13: {time.time() - t13:.1f} s")


def write_tracks_csv(path, tracks) -> int:
    """The track dict as a CSV in the columns ``io.readers.read_table``
    reads (TRACK_ID, POSITION_X, POSITION_Y, FRAME: tracks numbered in the
    dict's order, frames 0..L-1), through pandas; returns the rows."""
    import pandas as pd
    parts, tid = [], 0
    for k in sorted(tracks, key=int):
        arr = np.asarray(tracks[k])
        b, t = arr.shape[:2]
        parts.append(pd.DataFrame({
            "TRACK_ID": np.repeat(np.arange(tid, tid + b), t),
            "POSITION_X": arr[:, :, 0].ravel(),
            "POSITION_Y": arr[:, :, 1].ravel(),
            "FRAME": np.tile(np.arange(t), b)}))
        tid += b
    df = pd.concat(parts, ignore_index=True)
    df.to_csv(path, index=False)
    return len(df)


def counts_of(mods) -> dict:
    return {k: m.LAUNCHES for k, m in mods.items()}


def phase14(dev, card, reset_counts, plain_calls, tracks, fit3):
    """The user's entry points on the card, on phase 3's tracks (``tracks``)
    written to a CSV: the readers, ``pipeline.analyze``, the CLI in
    subprocesses, model selection, a headless GUI session and a profiler
    trace; ``fit3`` is phase 3's fit of the same tracks."""
    import tempfile
    from pathlib import Path

    import pandas as pd

    from extrack_tpu_torch import (auto_fitting, fit, gui, histograms,
                                   params, pipeline, predict, refine)
    from extrack_tpu_torch.io import readers
    from extrack_tpu_torch.ops import (forward_kernel, grad_kernel,
                                       hist_kernel, hvp_kernel,
                                       predict_kernel, refine_kernel)
    from extrack_tpu_torch.utils import observe
    t14 = time.time()
    mods = {"K1": forward_kernel, "K2": grad_kernel, "K3": hvp_kernel,
            "K4": predict_kernel, "K5": hist_kernel, "K6": refine_kernel}
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        csv = str(tmp / "tracks.csv")
        n_loc = write_tracks_csv(csv, tracks)
        n_tr = sum(len(v) for v in tracks.values())

        # ---- (a) the readers: native and pandas ---------------------------
        lengths = list(range(3, SIM["max_track_len"] + 1))
        read = {}
        for engine in ("native", "pandas"):
            t0 = time.time()
            read[engine] = readers.read_table(csv, lengths=lengths,
                                              engine=engine)
            read[engine] += (time.time() - t0,)
        (nt, nf, _, t_nat), (pt, pf, _, t_pan) = read["native"], \
            read["pandas"]
        same_keys = (list(nt) == list(pt) == list(nf)
                     and {k: len(v) for k, v in nt.items()}
                     == {k: len(v) for k, v in tracks.items() if len(v)})
        same_frames = same_keys and all(np.array_equal(nf[k], pf[k])
                                        for k in nf)
        pos_err = max(float(np.max(np.abs(nt[k] - pt[k])
                                   / np.maximum(np.abs(pt[k]), 1e-300)))
                      for k in nt) if same_keys else math.inf
        ok = same_keys and same_frames and pos_err <= TOL_NATIVE_REL
        log(f"phase 14: {n_tr} tracks, {n_loc} localizations in a CSV; "
            f"read_table native {t_nat:.3f} s, pandas {t_pan:.3f} s; keys, "
            f"track counts and frames identical {same_keys and same_frames},"
            f" positions max relative difference {pos_err:.3e} (<= "
            f"{TOL_NATIVE_REL:g}: the native parser's decimal conversion) "
            f"{'ok' if ok else 'FAIL'} [{card}]")
        if not ok:
            fail("the native and pandas readers disagree")

        # ---- (b) pipeline.analyze ------------------------------------------
        start = params.generate_params(
            nb_states=2, LocErr_type=1, LocErr_bounds=(0.005, 0.1),
            D_max=3.0, estimated_transition_rates=0.1)
        out_csv, out_xml = str(tmp / "analyzed.csv"), str(tmp / "an.xml")
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        res = pipeline.analyze(csv, dt=0.02, nb_states=2, cell_dims=(0.5,),
                               params=start, export_csv=out_csv,
                               export_xml=out_xml,
                               fit_kwargs={"max_iter": FIT_ITERS})
        torch.cuda.synchronize()
        t_an = time.time() - t0
        n_an, plain = counts_of(mods), plain_calls()
        rows = sum(1 for _ in open(out_csv)) - 1
        log(f"phase 14: pipeline.analyze {t_an:.2f} s ({res.fit.n_evals} "
            f"evals; " + ", ".join(f"{k} {v:.3f} s"
                                   for k, v in res.timings.items())
            + "; the export writes a CSV and an XML): launches " + ", ".join(
                f"{k} {v}" for k, v in n_an.items())
            + f", plain calls {plain}; exported CSV {rows} rows for "
            f"{n_loc} localizations [{card}]")
        if (plain or rows != n_loc
                or not all(n_an[k] > 0 for k in ("K2", "K4", "K5", "K6"))):
            fail("analyze did not run K2, K4, K5 and K6 alone, or its "
                 "export lost rows")
        values = res.fit.params.resolve()
        se = fit3.std_errors or {}
        ref3 = fit3.params.valuesdict()

        def gap(vals):
            """The largest difference from phase 3's fitted values, as a
            fraction of its limit (TOL_ANALYZE_FIT relative or a tenth of
            phase 3's standard error, whichever is larger)."""
            return max(abs(vals[k] - v) / max(TOL_ANALYZE_FIT * abs(v),
                                              0.1 * se.get(k, 0.0), 1e-300)
                       for k, v in ref3.items())
        worst = gap(res.fit.params.valuesdict())
        log("phase 14: analyze's fit " + ", ".join(
            f"{k}={res.fit.params[k].value:.6g} (phase 3: {p.value:.6g})"
            for k, p in fit3.params.items())
            + f"; largest difference {worst:.3f} of its limit (rel "
            f"{TOL_ANALYZE_FIT:g} or 0.1 standard error) "
            f"{'ok' if worst <= 1 else 'FAIL'}")
        if worst > 1:
            fail("analyze's fit differs from phase 3's fit of the tracks")
        # the drivers, called directly on the same tracks and values
        W = fit.default_window(2)
        Wr = refine.default_window(2, max(int(k) for k in res.tracks))
        preds = predict.predict_Bs(res.tracks, 0.02, values, nb_states=2,
                                   cell_dims=(0.5,), frame_len=W)
        hist = histograms.len_hist(res.tracks, values, 0.02,
                                   cell_dims=(0.5,), nb_states=2, window=7)
        loc_err, ds, Fs, tr = refine.refinement_args(values, 2, 0.02)
        mus, sigmas = refine.position_refinement(res.tracks, loc_err, ds, Fs,
                                                 tr, frame_len=Wr)

        def diff(a, b):
            return max(float(np.max(np.abs(np.asarray(a[k], np.float64)
                                           - np.asarray(b[k], np.float64))))
                       for k in b)
        e4, e6m, e6s = diff(res.preds, preds), diff(res.mus, mus), \
            diff(res.sigmas, sigmas)
        e5 = float(np.max(np.abs(res.hist - hist)))
        ok = (all(np.allclose(res.preds[k], preds[k], **TOL_K4_PREDS)
                  and np.allclose(res.mus[k], mus[k], **TOL_K6_MU)
                  and np.allclose(res.sigmas[k], sigmas[k], **TOL_K6_SIGMA)
                  for k in preds)
              and sorted(res.preds) == sorted(preds)
              and np.allclose(res.hist, hist, **TOL_K5))
        log(f"phase 14: analyze against the drivers (predict_Bs W={W}, "
            f"len_hist W=7, position_refinement W={Wr}) at its fitted "
            f"values: posteriors {e4:.3e}, histogram {e5:.3e}, refined "
            f"positions {e6m:.3e}, sigmas {e6s:.3e} (TOL_K4_PREDS, TOL_K5, "
            f"TOL_K6_MU, TOL_K6_SIGMA) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("analyze disagrees with the drivers")

        # ---- (c) the CLI in subprocesses ------------------------------------
        io_args = ["--dt", "0.02", "--min-len", "3", "--max-len",
                   str(SIM["max_track_len"]), "--cell-dims", "0.5"]

        def cli(*args):
            t0 = time.time()
            p = subprocess.run([sys.executable, "-m", "extrack_tpu_torch.cli",
                                "-v", "--device", "cuda", *args],
                               capture_output=True, text=True, cwd=root,
                               timeout=600)
            t = time.time() - t0
            if p.returncode != 0:
                log(p.stdout[-3000:] + p.stderr[-3000:])
                fail(f"the CLI's {args[0]} exited with {p.returncode}")
            line = [x for x in p.stdout.splitlines()
                    if x.startswith("kernel launches: ")][-1]
            n = json.loads(line[len("kernel launches: "):])
            return t, {k: v["launches"] for k, v in n.items()}, sum(
                v["plain_calls"] for v in n.values())

        fit_json = str(tmp / "fit.json")
        cli_t = {}
        cli_t["fit"], n_fit, pl = cli("fit", csv, *io_args, "-o", fit_json)
        d_fit = gap(json.load(open(fit_json))["values"])
        ok = (n_fit.get("K2", 0) > 0 and n_fit.get("K3", 0) > 0 and pl == 0
              and d_fit <= 1)
        log(f"phase 14: CLI fit {cli_t['fit']:.2f} s (a new process: torch "
            f"import, library load, read, fit with error bars): launches "
            + ", ".join(f"{k} {v}" for k, v in n_fit.items() if v)
            + f", plain calls {pl}; its values against phase 3's fit: "
            f"largest difference {d_fit:.3f} of its limit "
            f"{'ok' if ok else 'FAIL'} [{card}]")
        if not ok:
            fail("the CLI's fit did not run K2 and K3 or differs")
        pargs = ["--params", fit_json]
        cli_t["predict"], n_p, pl_p = cli(
            "predict", csv, *io_args, *pargs, "--window", str(W), "-o",
            str(tmp / "pred.csv"))
        pcols = ["PRED_0", "PRED_1"]
        got = pd.read_csv(tmp / "pred.csv")[pcols].to_numpy()
        want = pd.read_csv(out_csv)[pcols].to_numpy()
        cli_t["histogram"], n_h, pl_h = cli(
            "histogram", csv, *io_args, *pargs, "-o", str(tmp / "hist.csv"))
        h_cli = np.loadtxt(tmp / "hist.csv", delimiter=",")
        cli_t["refine"], n_r, pl_r = cli(
            "refine", csv, *io_args, *pargs, "-o", str(tmp / "ref.csv"))
        ref = pd.read_csv(tmp / "ref.csv")[["X_REFINED", "Y_REFINED"]]
        ref = ref.to_numpy()
        mus_all = np.concatenate([res.mus[k].reshape(-1, 2)
                                  for k in sorted(res.tracks, key=int)])
        same_shape = (got.shape == want.shape and ref.shape == mus_all.shape
                      and len(ref) == n_loc and h_cli.shape == res.hist.shape)
        e_pred = float(np.abs(got - want).max()) if same_shape else math.inf
        e_hist = float(np.abs(h_cli - res.hist).max()) if same_shape else \
            math.inf
        e_ref = float(np.abs(ref - mus_all).max()) if same_shape else \
            math.inf
        ok = (same_shape and np.allclose(got, want, **TOL_K4_PREDS)
              and np.allclose(h_cli, res.hist, **TOL_K5)
              and np.allclose(ref, mus_all, **TOL_K6_MU)
              and n_p.get("K4", 0) > 0 and n_h.get("K5", 0) > 0
              and n_r.get("K6", 0) > 0 and pl_p + pl_h + pl_r == 0)
        log(f"phase 14: CLI predict {cli_t['predict']:.2f} s (K4 "
            f"{n_p.get('K4')}), histogram {cli_t['histogram']:.2f} s (K5 "
            f"{n_h.get('K5')}), refine {cli_t['refine']:.2f} s (K6 "
            f"{n_r.get('K6')}), plain calls {pl_p + pl_h + pl_r}; against "
            f"analyze: posteriors {e_pred:.3e}, histogram {e_hist:.3e}, "
            f"refined positions {e_ref:.3e} {'ok' if ok else 'FAIL'} "
            f"[{card}]")
        if not ok:
            fail("the CLI's predict, histogram or refine disagrees")
        sub = {k: v[::SUBSET_STRIDE] for k, v in res.tracks.items()
               if len(v[::SUBSET_STRIDE])}
        sub_csv = str(tmp / "subset.csv")
        write_tracks_csv(sub_csv, sub)
        n_sub = sum(len(v) for v in sub.values())
        post = str(tmp / "post.npz")
        cli_t["sample"], n_s, pl_s = cli(
            "sample", sub_csv, *io_args, *pargs, "--window", str(W),
            *CLI_SAMPLE, "-o", post)
        draws = np.load(post)
        shape = draws["D1_minus_D0"].shape
        ok = (shape == (2, int(CLI_SAMPLE[1]))
              and np.isfinite(draws["D1_minus_D0"]).all()
              and n_s.get("K2", 0) > 0 and pl_s == 0)
        log(f"phase 14: CLI sample on {n_sub} tracks "
            f"{cli_t['sample']:.2f} s ({' '.join(CLI_SAMPLE)}, a warm-start "
            f"fit with error bars first): K2 {n_s.get('K2')}, K3 "
            f"{n_s.get('K3')}, plain calls {pl_s}; samples {shape}, "
            f"acceptance {float(draws['accept_rate']):.3f}, R-hat "
            f"{np.round(draws['rhat'], 3).tolist()} "
            f"{'ok' if ok else 'FAIL'} [{card}]")
        if not ok:
            fail("the CLI's sample failed")

        # ---- (d) model selection on the subset ------------------------------
        reset_counts()
        t0 = time.time()
        sel = auto_fitting.model_selection(sub, 0.02, state_range=(2, 3),
                                           cell_dims=(0.5,))
        t_sel = time.time() - t0
        n_sel, plain = counts_of(mods), plain_calls()
        ok = plain == 0 and n_sel["K2"] > 0 and sel.best_nb_states in (2, 3)
        log(f"phase 14: model_selection(state_range=(2, 3)) on {n_sub} "
            f"tracks {t_sel:.2f} s (windows 6 and 5, K = 64 and 243): K2 "
            f"{n_sel['K2']}, plain calls {plain}; best {sel.best_nb_states}"
            f" states {'ok' if ok else 'FAIL'} [{card}]\n"
            + sel.summary())
        if not ok:
            fail("model selection did not run on K2 alone")

        # ---- (e) a headless GUI session --------------------------------------
        out_dir = tmp / "gui"
        out_dir.mkdir()
        s = gui.Session(path=sub_csv, dt=0.02, min_len=3,
                        max_len=SIM["max_track_len"], nb_states=2,
                        cell_dims=(0.5,), nb_iters=1,
                        output_dir=str(out_dir))
        s.load()
        msgs = []
        times = {}
        reset_counts()
        for name, run in (("fit", gui.run_fitting),
                          ("labels", gui.run_predictions),
                          ("lifetime", gui.run_lifetime),
                          ("refine", gui.run_refinement)):
            t0 = time.time()
            run(s, progress=msgs.append)
            times[name] = time.time() - t0
        n_gui, plain = counts_of(mods), plain_calls()
        files = sorted(p.name for p in out_dir.iterdir())
        # the lifetime's PNG only where matplotlib is installed
        ok = (plain == 0 and {"extrack_fitted_params.json",
                              "extrack_predictions.csv",
                              "extrack_durations.csv",
                              "extrack_refined.csv"} <= set(files)
              and all(n_gui[k] > 0 for k in ("K2", "K3", "K4", "K5", "K6")))
        log(f"phase 14: GUI session on {n_sub} tracks, the four runners "
            + ", ".join(f"{k} {v:.2f} s" for k, v in times.items())
            + ": launches " + ", ".join(f"{k} {v}" for k, v in n_gui.items())
            + f", plain calls {plain}; wrote {files} "
            f"{'ok' if ok else 'FAIL'} [{card}]")
        if not ok:
            fail("the GUI session's runners did not run the kernels alone")

        # ---- (f) a profiler trace around predict_Bs ------------------------
        trace_dir = tmp / "trace"
        with observe.trace(str(trace_dir)):
            predict.predict_Bs(sub, 0.02, values, nb_states=2,
                               cell_dims=(0.5,), frame_len=W)
        events = json.load(open(trace_dir / "trace.json"))["traceEvents"]
        k4 = sorted({e["name"] for e in events
                     if e.get("cat") == "kernel"
                     and re.search(r"walk_\w+_kernel<[^>]*\btrue\b",
                                   e.get("name", ""))})
        n_kern = sum(1 for e in events if e.get("cat") == "kernel")
        log(f"phase 14: observe.trace around predict_Bs: {len(events)} "
            f"events, {n_kern} kernel events; K4's: {k4} "
            f"{'ok' if k4 else 'FAIL'}")
        if not k4:
            fail("the trace does not name K4's kernel")
    log(f"phase 14: done in {time.time() - t14:.1f} s [{card}]")


def _gap_free(vals, fit3) -> float:
    """The largest difference of ``vals`` from phase 3's fitted free
    parameters as a fraction of phase 14's limit (TOL_ANALYZE_FIT relative
    or a tenth of phase 3's standard error, whichever is larger); a
    parameter pinned at a bound (standard error 0) has no error bar and is
    not compared."""
    se = fit3.std_errors or {}
    return max(abs(vals[k] - fit3.params[k].value)
               / max(TOL_ANALYZE_FIT * abs(fit3.params[k].value),
                     0.1 * se[k], 1e-300)
               for k in fit3.params.free_names() if se.get(k, 0) > 0)


def _post15(tracks, values, sharded):
    """The three post-fit drivers on the card at ``values``: posteriors
    (frame_len 5), histogram (window 7), refinement (frame_len 7)."""
    from extrack_tpu_torch import histograms, predict, refine
    preds = predict.predict_Bs(tracks, 0.02, values, cell_dims=(0.5,),
                               nb_states=2, frame_len=5, sharded=sharded)
    hist = histograms.len_hist(tracks, values, 0.02, cell_dims=(0.5,),
                               nb_states=2, window=7, sharded=sharded)
    loc_err, ds, Fs, tr = refine.refinement_args(values, 2, 0.02)
    mus, sigmas = refine.position_refinement(tracks, loc_err, ds, Fs, tr,
                                             frame_len=7, sharded=sharded)
    return preds, hist, mus, sigmas


def _fit15_spec():
    from extrack_tpu_torch import params
    return params.generate_params(
        nb_states=2, LocErr_type=1, LocErr_bounds=(0.005, 0.1), D_max=3.0,
        estimated_transition_rates=0.1)


def _global15(tracks, max_len, dev):
    """This process's ``process_slice`` of the tracks as one batch (the
    dataset's time axis and censoring length), through ``global_batch``."""
    from extrack_tpu_torch import data
    from extrack_tpu_torch.parallel import multihost
    items = [(k, i) for k in sorted(tracks, key=int)
             for i in range(len(tracks[k]))]
    local = {}
    for k, i in items[multihost.process_slice(len(items))]:
        local.setdefault(k, []).append(tracks[k][i])
    batch = data.from_dict({k: np.asarray(v) for k, v in local.items()},
                           max_len=max_len, data_max=max_len, device=dev,
                           dtype=torch.float32)
    return multihost.global_batch(batch), len(items)


def phase15_rank(argv) -> int:
    """One process of phase 15's process groups: ``argv`` is (backend,
    rank, world size, port, job JSON).  It reads the job's CSV, keeps its
    ``process_slice`` through ``global_batch``, and runs the sharded
    objective at phase 3's optimum, ``fit.fit`` and (``post``) the three
    post-fit drivers, writing its results beside the job file."""
    import datetime
    from pathlib import Path

    import torch.distributed as dist

    from extrack_tpu_torch import fit
    from extrack_tpu_torch.io import readers
    from extrack_tpu_torch.ops import (grad_kernel, hist_kernel, hvp_kernel,
                                       predict_kernel, refine_kernel)
    backend, rank, world, port, job_path = argv
    rank, world = int(rank), int(world)
    job = json.load(open(job_path))
    mods = {"K2": grad_kernel, "K3": hvp_kernel, "K4": predict_kernel,
            "K5": hist_kernel, "K6": refine_kernel}
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=240))
    try:
        t0 = time.time()
        tracks, _, _ = readers.read_table(
            job["csv"], lengths=list(range(3, job["max_len"] + 1)))
        gb, n_items = _global15(tracks, job["max_len"], dev)
        for m in mods.values():
            m.LAUNCHES = m.PLAIN_CALLS = 0
        spec = _fit15_spec()
        neg = fit.make_objective(gb, spec, 0.02, 2, cell_dims=(0.5,),
                                 sharded=True)
        z = torch.tensor(job["z_fit"], dtype=torch.float32, device=dev,
                         requires_grad=True)
        v = neg(z)
        (g,) = torch.autograd.grad(v, z)
        t1 = time.time()
        res = fit.fit(gb, spec, 0.02, 2, cell_dims=(0.5,),
                      compute_errors=job["errors"], sharded=True,
                      max_iter=FIT_ITERS)
        torch.cuda.synchronize()
        t_fit = time.time() - t1
        out = {"rank": rank, "world": world, "backend": backend,
               "n_items": n_items, "rows": gb.batch_size,
               "min_len": neg.min_len, "value": float(v.detach()),
               "grad": g.tolist(), "logl": res.logl, "n_evals": res.n_evals,
               "values": res.params.valuesdict(),
               "std_errors": res.std_errors, "t_fit": t_fit}
        if job["post"]:
            t1 = time.time()
            preds, hist, mus, sigmas = _post15(tracks, job["values"], True)
            torch.cuda.synchronize()
            out["t_post"] = time.time() - t1
            if rank == 0:
                np.savez(Path(job_path).with_name("post.npz"), hist=hist,
                         **{f"preds_{k}": v for k, v in preds.items()},
                         **{f"mus_{k}": v for k, v in mus.items()},
                         **{f"sigmas_{k}": v for k, v in sigmas.items()})
        out["launches"] = counts_of(mods)
        out["plain_calls"] = sum(m.PLAIN_CALLS for m in mods.values())
        out["t_total"] = time.time() - t0
        Path(job_path).with_name(f"rank{rank}.json").write_text(
            json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def phase15(dev, card, reset_counts, plain_calls, tracks, fit3):
    """The sharded paths on the card (``parallel``): every driver with
    ``sharded=True`` on a mesh of the one card, bit for bit against the
    unsharded drivers; two gloo processes sharing the card, each with its
    ``process_slice`` of phase 3's tracks (``global_batch``), against
    phase 3; NCCL at world size 1 against the in-process sharded fit."""
    import socket
    import tempfile
    from pathlib import Path

    from extrack_tpu_torch import data, fit
    from extrack_tpu_torch.io import readers
    from extrack_tpu_torch.ops import (grad_kernel, hist_kernel, hvp_kernel,
                                       predict_kernel, refine_kernel)
    from extrack_tpu_torch.parallel import mesh as pmesh
    t15 = time.time()
    mods = {"K2": grad_kernel, "K3": hvp_kernel, "K4": predict_kernel,
            "K5": hist_kernel, "K6": refine_kernel}
    root = Path(__file__).resolve().parent
    max_len = SIM["max_track_len"]
    values = {k: p.value for k, p in fit3.params.items()}
    z_fit = fit3.params.to_unconstrained()

    def free_port():
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            return sock.getsockname()[1]

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        csv, sub_csv = str(tmp / "tracks.csv"), str(tmp / "subset.csv")
        write_tracks_csv(csv, tracks)
        sub = {k: v[::SUBSET_STRIDE] for k, v in tracks.items()
               if len(v[::SUBSET_STRIDE])}
        write_tracks_csv(sub_csv, sub)
        # (b) and (c) start first and run beside (a): three processes
        procs = []
        for name, backend, world, job in (
                ("gloo", "gloo", 2, dict(csv=csv, errors=True, post=True)),
                ("nccl", "nccl", 1, dict(csv=sub_csv, errors=False,
                                         post=False))):
            d = tmp / name
            d.mkdir()
            job.update(max_len=max_len, z_fit=z_fit.tolist(), values=values)
            (d / "job.json").write_text(json.dumps(job))
            port = str(free_port())
            for rank in range(world):
                procs.append((name, rank, subprocess.Popen(
                    [sys.executable, "-c", "import sys, chip_smoke; "
                     "sys.exit(chip_smoke.phase15_rank(sys.argv[1:]))",
                     backend, str(rank), str(world), port,
                     str(d / "job.json")], cwd=root, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)))
        t_start = time.time()

        # ---- (a) in process: a mesh of the one card ------------------------
        mesh = pmesh.make_mesh()
        log(f"phase 15: make_mesh(): devices {list(mesh.devices)}, group "
            f"{mesh.group}, size {mesh.size}")
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        res = fit.param_fitting(tracks, 0.02, nb_states=2, compute_errors=True,
                                max_iter=FIT_ITERS, verbose=0,
                                cell_dims=(0.5,), sharded=True)
        post = _post15(tracks, values, True)
        torch.cuda.synchronize()
        t_a = time.time() - t0
        n_a, plain_a = counts_of(mods), plain_calls()
        ref = _post15(tracks, values, False)
        same_fit = (res.logl == fit3.logl and res.n_evals == fit3.n_evals
                    and res.params.valuesdict() == fit3.params.valuesdict()
                    and res.std_errors == fit3.std_errors)
        same_post = (all(np.array_equal(post[i][k], ref[i][k])
                         for i in (0, 2, 3) for k in ref[i])
                     and set(post[0]) == set(ref[0])
                     and np.array_equal(post[1], ref[1]))
        ok = (same_fit and same_post and plain_a == 0
              and all(n_a[k] > 0 for k in mods))
        n_tr = sum(len(v) for v in tracks.values())
        log(f"phase 15: one-card mesh, sharded=True on {n_tr} "
            f"tracks: param_fitting(compute_errors=True) ({res.n_evals} "
            f"evals), predict_Bs, len_hist, position_refinement {t_a:.2f} s"
            f": launches " + ", ".join(f"{k} {v}" for k, v in n_a.items())
            + f", plain calls {plain_a}; fit bit-equal to phase 3's "
            f"{same_fit} (logL {res.logl:.4f}), posteriors, histogram and "
            f"refinement bit-equal to the unsharded drivers {same_post} "
            f"{'ok' if ok else 'FAIL'} [{card}]")
        if not ok:
            fail("the one-card sharded drivers differ from the unsharded "
                 "ones or did not run on the kernels alone")

        # the in-process sharded fit that NCCL at world size 1 must match
        sub_read, _, _ = readers.read_table(
            sub_csv, lengths=list(range(3, max_len + 1)))
        gb_sub, _ = _global15(sub_read, max_len, dev)
        res_sub = fit.fit(gb_sub, _fit15_spec(), 0.02, 2, cell_dims=(0.5,),
                          sharded=True, max_iter=FIT_ITERS)
        # the unsharded objective at phase 3's optimum, and the drivers on
        # the tracks as the processes read them
        read, _, _ = readers.read_table(csv,
                                        lengths=list(range(3, max_len + 1)))
        obj = fit.make_objective(
            data.from_dict_bucketed(read, max_buckets=4, device=dev,
                                    dtype=torch.float32),
            _fit15_spec(), 0.02, 2, cell_dims=(0.5,))
        z3 = torch.tensor(z_fit, dtype=torch.float32, device=dev,
                          requires_grad=True)
        v3 = obj(z3)
        (g3,) = torch.autograd.grad(v3, z3)
        ref_read = _post15(read, values, False)

        # ---- (b), (c): the processes' results --------------------------------
        outs = {}
        for name, rank, p in procs:
            try:
                text, _ = p.communicate(timeout=max(
                    10.0, 300 - (time.time() - t_start)))
            except subprocess.TimeoutExpired:
                for _, _, q in procs:
                    q.kill()
                fail(f"phase 15: {name} rank {rank} did not finish in 300 s")
            if p.returncode != 0:
                log(text[-4000:])
                for _, _, q in procs:
                    q.kill()
                fail(f"phase 15: {name} rank {rank} exited with "
                     f"{p.returncode}")
            outs[name, rank] = json.loads(
                (tmp / name / f"rank{rank}.json").read_text())
        t_procs = time.time() - t_start
        r0, r1 = outs["gloo", 0], outs["gloo", 1]
        agree = all(r0[k] == r1[k] for k in (
            "value", "grad", "logl", "n_evals", "values", "std_errors"))
        e_v = abs(r0["value"] - float(v3.detach()))
        g_r = torch.tensor(r0["grad"])
        g_u = g3.detach().cpu()
        ok_obj = (torch.allclose(torch.tensor(r0["value"]), v3.detach().cpu(),
                                 **TOL_K2_VALUE)
                  and torch.allclose(g_r, g_u, **TOL_Z_GRAD))
        worst = _gap_free(r0["values"], fit3)
        se3 = fit3.std_errors
        se_rel = max(abs(r0["std_errors"][k] - se3[k]) / se3[k]
                     for k in se3 if se3[k] > 0)
        post_np = np.load(tmp / "gloo" / "post.npz")
        e4 = max(float(np.abs(post_np[f"preds_{k}"] - ref_read[0][k]).max())
                 for k in ref_read[0])
        e5 = float(np.abs(post_np["hist"] - ref_read[1]).max())
        e6 = max(float(np.abs(post_np[f"mus_{k}"] - ref_read[2][k]).max())
                 for k in ref_read[2])
        e6s = max(float(np.abs(post_np[f"sigmas_{k}"] - ref_read[3][k]).max())
                  for k in ref_read[3])
        ok_post = (all(np.allclose(post_np[f"preds_{k}"], ref_read[0][k],
                                   **TOL_K4_PREDS)
                       and np.allclose(post_np[f"mus_{k}"], ref_read[2][k],
                                       **TOL_K6_MU)
                       and np.allclose(post_np[f"sigmas_{k}"],
                                       ref_read[3][k], **TOL_K6_SIGMA)
                       for k in ref_read[0])
                   and np.allclose(post_np["hist"], ref_read[1], **TOL_K5))
        launched = all(r["launches"][k] > 0 for r in (r0, r1) for k in mods)
        ok = (agree and ok_obj and worst <= 1 and se_rel <= TOL_STD_ERR
              and ok_post and launched
              and r0["plain_calls"] == r1["plain_calls"] == 0
              and r0["min_len"] == data.default_min_len(
                  np.array([int(k) for k in tracks if len(tracks[k])])))
        log(f"phase 15: two gloo processes on the one card, "
            f"{r0['n_items']} tracks ({r0['rows']} rows each): both ranks "
            f"bit-equal {agree}; objective at phase 3's optimum "
            f"{r0['value']:.4f} vs {float(v3.detach()):.4f} unsharded "
            f"(abs {e_v:.3e}, TOL_K2_VALUE), z-gradient max abs "
            f"{float((g_r - g_u).abs().max()):.3e} (TOL_Z_GRAD); fit "
            f"{r0['n_evals']} evals logL {r0['logl']:.4f} (phase 3 "
            f"{fit3.logl:.4f}), largest difference {worst:.3f} of phase "
            f"14's limit, standard errors max rel {se_rel:.2e} "
            f"(TOL_STD_ERR {TOL_STD_ERR}); posteriors {e4:.3e}, histogram "
            f"{e5:.3e}, refined positions {e6:.3e}, sigmas {e6s:.3e} "
            f"against the unsharded drivers; launches rank 0 "
            + ", ".join(f"{k} {v}" for k, v in r0["launches"].items())
            + ", rank 1 " + ", ".join(f"{k} {v}"
                                      for k, v in r1["launches"].items())
            + f", plain calls {r0['plain_calls'] + r1['plain_calls']} "
            f"{'ok' if ok else 'FAIL'}")
        log("phase 15: " + "; ".join(
            f"{k}={r0['values'][k]:.6g} (phase 3 {fit3.params[k].value:.6g})"
            f" +/- {r0['std_errors'].get(k, float('nan')):.4g}"
            for k in fit3.params.free_names()))
        log(f"phase 15: the two gloo processes' wall time (not a speed of "
            f"the sharded path: both share the one card, beside a third "
            f"process and this one): fit with error bars {r0['t_fit']:.2f} /"
            f" {r1['t_fit']:.2f} s, post-fit drivers {r0['t_post']:.2f} / "
            f"{r1['t_post']:.2f} s, each process's work {r0['t_total']:.2f}"
            f" / {r1['t_total']:.2f} s, {t_procs:.2f} s from their start "
            f"to their results [{card}]")
        if not ok:
            fail("the two gloo processes disagree with each other or with "
                 "phase 3")
        rn = outs["nccl", 0]
        nccl_equal = (rn["logl"] == res_sub.logl
                      and rn["n_evals"] == res_sub.n_evals
                      and rn["values"] == res_sub.params.valuesdict())
        gap_n = max(abs(rn["values"][k] - res_sub.params[k].value)
                    / max(TOL_ANALYZE_FIT * abs(res_sub.params[k].value),
                          1e-300)
                    for k in res_sub.params.free_names())
        ok = (gap_n <= 1 and rn["launches"]["K2"] > 0
              and rn["plain_calls"] == 0)
        log(f"phase 15: NCCL at world size 1 on {rn['n_items']} tracks: "
            f"fit {rn['n_evals']} evals logL {rn['logl']:.4f} vs the "
            f"in-process sharded fit {res_sub.n_evals} evals "
            f"{res_sub.logl:.4f}: bit-equal {nccl_equal}, largest "
            f"difference {gap_n:.3g} of TOL_ANALYZE_FIT; K2 "
            f"{rn['launches']['K2']}, plain calls {rn['plain_calls']}; its "
            f"work {rn['t_total']:.2f} s {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("the NCCL process's fit differs from the in-process one")
    log(f"phase 15: done in {time.time() - t15:.1f} s [{card}]")


if __name__ == "__main__":
    sys.exit(main())
