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
   ``value_and_table_grads_plain`` (torch autograd of the engine);
3. the fit main path on 10^5 simulated tracks: first the kernels against
   the plain version at the fit's own bucket shapes (each table cotangent
   per bucket, then the objective's value and each z-gradient component);
   then ``fit.param_fitting(compute_errors=True)`` (2 states, window 6,
   4 length buckets) with the K2 and K3 launch counts over it, and one
   value-only objective call (K1);
4. times at the fit benchmark shape (2 states, T=10, W=6, D=2, 2^20 tracks,
   lengths 3..10, length-bucketed, f32): K1 and K2 launched on prepared
   inputs and through their wrappers, against their plain versions,
   CUDA events, median of several reps after warm-up;
5. K3 (csrc/hvp.cu): every Hessian column of ``hessian_hvp_columns``
   against the same assembly on the plain double backward, at four
   register configurations with a forbidden transition; then the main
   path's Hessian and standard errors against ``hessian_chunked`` (plain
   second-order autograd) at the fitted parameters; K3's time for one
   tangent direction over the 2^20 bench tracks, launched on prepared
   inputs and through ``table_hvp``;
6. K4 (csrc/predict.cu): logL and posteriors against ``predict_plain`` at
   five configurations (T=2 rows, 0/1-frame rows, per-peak LocErr, a
   history in global scratch); then the annotation main path,
   ``predict.predict_Bs`` on the 10^5 tracks with the fitted parameters,
   with its K4 launch count, each bucket against the plain version, and
   the share of frames whose most probable state is the simulated one;
   K4's time at 2^20 tracks (T=10, W=5, S=2), launched on prepared inputs
   and through ``predict_kernel.predict``.

Every kernel's ``bound_ms`` is the larger of the bytes it must move (each
input read once, each output written once) over 3.35 TB/s and the
operations its walk does on this run's lengths (``walk_ops``) over
67 TFLOP/s f32 (one H100 SXM's published peaks at 700 W).

The line before the last is a JSON object describing each kernel: ``ms``
is the bare launches' time, ``wrapper_ms`` the same work through the
wrapper a caller uses (``forward``, ``value_and_table_grads``,
``table_hvp``, ``predict``), host work included; the last
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
SIM = dict(nb_tracks=100_000, max_track_len=20, min_track_len=3,
           Ds=(0.0, 0.08), LocErr=0.02, dt=0.02, pBL=0.1, cell_dims=(0.5,),
           seed=0)
FIT_ITERS = 200
BENCH_TRACKS = 1 << 20
PLAIN_CHUNK = 1 << 17         # tracks per plain autograd call (memory)
PLAIN_HVP_CHUNK = 1 << 15     # double backward keeps ~3x more per track
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
    the update at L-1, its history mix and the harvest."""
    L = np.asarray(lengths, dtype=np.int64)
    L = L[L >= 2]
    G = K // A
    step = K * (14 * D + 2) + G * (A * (5 + 4 * D) + 3 * D + 3) \
        + K * (D + 3)
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
    from extrack_tpu_torch import data, fit, params, predict, simulate
    from extrack_tpu_torch.core import tables
    from extrack_tpu_torch.ops import (cuda_lib, forward_kernel, grad_kernel,
                                       hvp_kernel, predict_kernel)

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
    # library_ms stays null
    kinfo = {
        "K1": entry("forward_loglik", "forward.cu",
                    "extrack_tpu/ops/pallas_engine.py:218"),
        "K2": entry("loglik_grad", "grad.cu",
                    "extrack_tpu/ops/pallas_grad.py:549"),
        "K3": entry("loglik_hvp", "hvp.cu",
                    "extrack_tpu/ops/pallas_hvp.py:78"),
        "K4": entry("posteriors", "predict.cu",
                    "extrack_tpu/ops/pallas_predict.py:65"),
    }
    errs = {k: [] for k in kinfo}

    def reset_counts():
        for m in (forward_kernel, grad_kernel, hvp_kernel, predict_kernel):
            m.LAUNCHES = m.PLAIN_CALLS = 0

    def plain_calls():
        return sum(m.PLAIN_CALLS for m in (forward_kernel, grad_kernel,
                                           hvp_kernel, predict_kernel))

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

    ms3, wms3 = cuda_ms(k3_run, 10), cuda_ms(k3_wrapped, 5)
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
        f"{kinfo['K3']['bound_ms']:.4f} ms ({kinfo['K3']['bound_by']}) "
        f"[{card}]")

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
