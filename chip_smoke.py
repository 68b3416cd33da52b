#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # every phase, one card

Phases (each prints its lines; a failed check exits non-zero):

0. toolchain: torch / CUDA versions, nvcc, the card's name and power limit,
   the kernel build time and nvcc's register / spill report;
1. K1 (csrc/forward.cu) against its plain version ``forward_plain`` in f32
   on the card, three register configurations, ~3000 tracks each;
2. K2 (csrc/grad.cu): value and every table gradient against
   ``value_and_table_grads_plain`` (torch autograd of the engine);
3. the main path: ``fit.param_fitting`` (5 L-BFGS-B iterations, 2 states)
   on 10^5 simulated tracks, with the kernels checked against the plain
   version at the fit's own bucket shapes first (each table cotangent per
   bucket, then the objective's value and each z-gradient component), the
   kernel launch counts over the fit, and one value-only objective call;
4. times at the fit benchmark shape (2 states, T=10, W=6, D=2, 2^20 tracks,
   lengths 3..10, length-bucketed, f32): K1 and K2 against their plain
   versions, CUDA events, median of several reps after warm-up.

The line before the last is a JSON object describing each kernel; the last
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
# (S, W, nb_substeps, D, B, T): the three fit configurations at ~3000
# tracks, then D = 1 and 3, a small ragged batch and a T = 2 batch
PARITY_CASES = [(2, 6, 1, 2, 3001, 10), (3, 5, 1, 2, 3001, 10),
                (2, 4, 2, 2, 3001, 10), (2, 5, 1, 1, 257, 6),
                (3, 3, 2, 3, 37, 12), (2, 3, 1, 2, 5, 2)]


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


def bench_buckets(dev, n_tracks=1 << 20, T=10, seed=0):
    """2-state random walks, lengths 3..T, length-bucketed on ``dev``."""
    from extrack_tpu_torch import data
    rng = np.random.default_rng(seed)
    lengths = rng.integers(3, T + 1, n_tracks)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from extrack_tpu_torch import fit, simulate
    from extrack_tpu_torch.ops import cuda_lib, forward_kernel, grad_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    kinfo = {
        "K1": {"name": "forward_loglik", "route": "cuda",
               "source": "extrack_tpu_torch/csrc/forward.cu",
               "replaces": "extrack_tpu/ops/pallas_engine.py:218",
               "launches": None, "max_abs_err": None, "ms": None,
               "plain_ms": None},
        "K2": {"name": "loglik_grad", "route": "cuda",
               "source": "extrack_tpu_torch/csrc/grad.cu",
               "replaces": "extrack_tpu/ops/pallas_grad.py:549",
               "launches": None, "max_abs_err": None, "ms": None,
               "plain_ms": None},
    }

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
    errs = {"K1": [], "K2": []}
    for S, W, n, D, B, T in PARITY_CASES:
        pos, lens, isbl, tb = parity_case(S, W, n, 100 + S * 10 + W + n, dev,
                                          B=B, T=T, D=D, per_peak=(S == 3))
        kw = dict(window=W, nb_substeps=n, min_len=2)
        tag = f"S={S} W={W} n={n} D={D} B={B} T={T}"
        errs["K1"].append(check_forward(f"phase 1: K1 {tag}", pos, lens,
                                        isbl, tb, **kw))
        errs["K2"].append(check_table_grads(f"phase 2: K2 {tag}", pos, lens,
                                            isbl, tb, **kw))

    # ---- phase 3: the main path ----------------------------------------
    from extrack_tpu_torch import data, params
    from extrack_tpu_torch.core import tables
    t0 = time.time()
    tracks, _, _ = simulate.sim_fov(
        nb_tracks=100_000, max_track_len=20, min_track_len=3,
        Ds=(0.0, 0.08), LocErr=0.02, dt=0.02, pBL=0.1,
        cell_dims=(0.5,), seed=0)
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

    evals = []
    forward_kernel.LAUNCHES = grad_kernel.LAUNCHES = 0
    forward_kernel.PLAIN_CALLS = grad_kernel.PLAIN_CALLS = 0
    t0 = time.time()
    res = fit.param_fitting(
        tracks, 0.02, nb_states=2, compute_errors=False, max_iter=5,
        verbose=0, cell_dims=(0.5,), device=dev,
        callback=lambda i, v, vals: evals.append(v))
    torch.cuda.synchronize()
    t_fit = time.time() - t0
    for i, v in enumerate(evals, 1):
        log(f"phase 3: eval {i}: logL {-v:.4f}")
    k2, plain = grad_kernel.LAUNCHES, (forward_kernel.PLAIN_CALLS
                                       + grad_kernel.PLAIN_CALLS)
    log(f"phase 3: fit {t_fit:.2f} s, {res.n_evals} evals, initial logL "
        f"{-evals[0]:.4f} -> final {res.logl:.4f}; K2 launches {k2}, "
        f"plain calls {plain}")
    log("phase 3: fitted " + ", ".join(
        f"{k}={p.value:.5g}" for k, p in res.params.items()))
    if not (res.logl > -evals[0] and math.isfinite(res.logl)):
        fail("the fit did not improve the log likelihood")
    if k2 == 0 or plain != 0:
        fail(f"main path K2 launches {k2}, plain calls {plain}")
    with torch.no_grad():
        v = obj(torch.tensor(spec.to_unconstrained(), dtype=torch.float32,
                             device=dev))
    k1 = forward_kernel.LAUNCHES
    plain = forward_kernel.PLAIN_CALLS + grad_kernel.PLAIN_CALLS
    log(f"phase 3: value-only objective {float(v):.4f}: K1 launches "
        f"{k1}, plain calls {plain}")
    v_ref = float(v_k.detach())
    if k1 == 0 or plain != 0 or abs(float(v) - v_ref) > 2e-5 * abs(v_ref):
        fail("value-only objective did not run K1 or disagrees")
    kinfo["K1"]["launches"] = k1
    kinfo["K2"]["launches"] = k2
    for k in kinfo:
        kinfo[k]["max_abs_err"] = max(errs[k])

    # ---- phase 4: times at the benchmark shape ---------------------------
    buckets = bench_buckets(dev)
    n_tr = sum(b.batch_size for b in buckets)
    f32 = dict(dtype=torch.float32, device=dev)
    tb = tables.build_tables(
        torch.tensor([0.0, 0.08], **f32), torch.tensor(0.02, **f32),
        torch.tensor([0.5, 0.5], **f32),
        torch.tensor([[0.0, 0.1], [0.1, 0.0]], **f32),
        torch.tensor(0.1, **f32), 0.02, cell_dims=(0.5,))
    kw = dict(window=6, nb_substeps=1, min_len=3)
    args4 = [forward_kernel.kernel_inputs(b.positions, b.lengths,
                                          b.is_bleached, tb, 6, 1)
             for b in buckets]
    args4 = [(d, [t.detach() for t in tabs]) for d, tabs in args4]

    def k1():
        for d, tabs in args4:
            forward_kernel.launch(d, tabs, 3)

    def p1():
        with torch.no_grad():
            for b in buckets:
                forward_kernel.forward_plain(b.positions, b.lengths,
                                             b.is_bleached, tb, **kw)

    def k2():
        for b in buckets:
            grad_kernel.value_and_table_grads(b.positions, b.lengths,
                                              b.is_bleached, tb, **kw)

    def p2():
        # autograd of the engine keeps ~3000 floats per track and step:
        # chunks of 2^17 tracks bound that to a few GB
        for b in buckets:
            for i in range(0, b.batch_size, 1 << 17):
                sl = slice(i, i + (1 << 17))
                grad_kernel.value_and_table_grads_plain(
                    b.positions[sl], b.lengths[sl], b.is_bleached[sl],
                    tb, **kw)

    ms = {"K1": cuda_ms(k1, 10), "K2": cuda_ms(k2, 5)}
    pms = {"K1": cuda_ms(p1, 3), "K2": cuda_ms(p2, 3)}
    for k in ("K1", "K2"):
        kinfo[k]["ms"], kinfo[k]["plain_ms"] = ms[k], pms[k]
        log(f"phase 4: {k} {n_tr} tracks ({len(buckets)} buckets): "
            f"kernel {ms[k]:.3f} ms = {n_tr / ms[k] * 1e3 / 1e6:.3f}M "
            f"tracks/s; plain {pms[k]:.3f} ms = "
            f"{n_tr / pms[k] * 1e3 / 1e6:.3f}M tracks/s [{card}]")

    log(card)
    log(json.dumps({"kernels": list(kinfo.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
