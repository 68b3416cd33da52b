#!/usr/bin/env python3
"""Where the walks of K1 (csrc/forward.cu), K4 (csrc/predict.cu), K5
(csrc/hist.cu) and K6 (csrc/refine.cu) spend their time, at
``chip_smoke.py``'s bench shape: 2^20 tracks of lengths 3..10 in four
length buckets, D=2, f32.  K1 runs a register of W=6 frames (K=64), K4
W=5 (K=32), K5 and K6 W=7 (K=128), each as ``chip_smoke.py`` times it;
``--states``/``--window`` change the register (e.g. 3 states at W=5),
``--mapping block|wide`` forces K4's, K5's or K6's mapping (a thread a
slot or a thread a fusion group; K1 has only the wide one), ``--lengths
LO:HI`` the track lengths (e.g. 15:20, the main path's longest bucket);
``--dt`` gives K5 per-track dt (the streamed table, as ``chip_smoke.py``
phase 10) and ``--substeps N`` N sub-steps a frame; ``--walks N`` and
``--dims D`` the number of random walks (2^20 unless given) and their
dimensions (2), e.g. K6's wide shapes on 2^10 walks as ``chip_smoke.py``
phase 18 times them.

    python3 tools/walk_profile.py [--kernel k1|k4|k5|k6|both]
    python3 tools/walk_profile.py --split [--kernel ...]
    python3 tools/walk_profile.py --kernel k5 [--dt] [--substeps N]
    python3 tools/walk_profile.py --split --kernel k6 --states 4 \
        --window 7 --walks 1024

Without ``--split`` it times REPS bare launches over the four buckets by
CUDA events, then prints nvcc's register and spill report of the chosen
kernels' instantiations.  With ``--split`` it builds the kernels with
their clock64 marks (``cuda_lib.enable_profile``), runs the same launches
and prints each section's share of the cycles that the tracks' lead
threads spent (summed over all tracks; the marks cost a little, so read
shares, not times; K6's wide mapping prints its scan kernel's and its
pair kernel's sections each as shares of that kernel's lead-thread cycles,
after each kernel's device time from ``torch.profiler``).  ``both`` is K5
and K6.  The last line is the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
REPS = 5
SECTIONS = {
    "forward": ["track set-up", "update and fusion", "closing", "", "",
                "barriers"],
    "predict": ["track set-up", "update and fusion", "closing",
                "fusion-weight stash", "harvest", "barriers"],
    # K6 past 1024 slots: the scan kernel's sections (the pair loop and
    # stash writes are the block mapping's), then the pair kernel's
    "refine": ["suffix scan (fusions)", "suffix stash writes",
               "prefix scan: forms and fusions", "pair loop",
               "finish reductions", "prefix scan: barriers",
               "pair kernel: tile waits", "pair kernel: pair loop",
               "pair kernel: block partial"],
    "hist": ["buffer zeroing and track set-up", "update and fusion",
             "run/hist transport", "the step's barrier",
             "harvest"],
}


def bench_tables(dev, S: int, dt=0.02, n: int = 1):
    """The bench shape's model tables at S states (chip_smoke.py's at 2),
    at ``dt`` (a bucket's per-track table or a constant) and n sub-steps
    a frame."""
    from extrack_tpu_torch.core import tables
    f32 = dict(dtype=torch.float32, device=dev)
    rates = torch.full((S, S), 0.1, **f32)
    rates.fill_diagonal_(0.0)
    return tables.build_tables(
        torch.linspace(0.0, 0.08, S, **f32), torch.tensor(0.02, **f32),
        torch.full((S,), 1.0 / S, **f32), rates, torch.tensor(0.1, **f32),
        dt, cell_dims=(0.5,), nb_substeps=n)


def mapping_kw(mapping):
    """The launch keyword that forces a mapping, where one is given (a
    checkout that predates the keyword takes none)."""
    return {} if mapping is None else {"mapping": mapping}


def k1_runner(smoke, bench, dev, S: int, W: int, mapping=None):
    """Bare K1 launches over the bench buckets (``chip_smoke.py`` phase 4
    at S=2, W=6)."""
    from extrack_tpu_torch.ops import forward_kernel
    tb = bench_tables(dev, S)
    args = []
    for b in bench:
        d, tabs = forward_kernel.kernel_inputs(b.positions, b.lengths,
                                               b.is_bleached, tb, W, 1)
        args.append((d, [t.detach() for t in tabs]))

    def run():
        for d, tabs in args:
            forward_kernel.launch(d, tabs, 3, **mapping_kw(mapping))
    return run


def k4_runner(smoke, bench, dev, S: int, W: int, mapping=None):
    """Bare K4 launches over the bench buckets (``chip_smoke.py`` phase 6
    at S=2, W=5)."""
    from extrack_tpu_torch.ops import forward_kernel, predict_kernel
    tb = bench_tables(dev, S)
    args = []
    for b in bench:
        d, tabs = forward_kernel.kernel_inputs(b.positions, b.lengths,
                                               b.is_bleached, tb, W, 1)
        args.append((d, [t.detach() for t in tabs]))

    def run():
        for d, tabs in args:
            predict_kernel.launch(d, tabs, 3, S, W, **mapping_kw(mapping))
    return run


def k5_runner(smoke, bench, dev, n: int = 1, S: int = 2, W: int = 7,
              mapping=None):
    """Bare K5 launches over the bench buckets (W sub-steps, S states, n
    a frame; with the buckets' per-track dt where they have one), as
    ``chip_smoke.py`` phases 7 and 10 time them at S=2, W=7."""
    from extrack_tpu_torch.ops import forward_kernel, hist_kernel
    args = []
    for b in bench:
        tb = bench_tables(dev, S, 0.02 if b.dt is None else b.dt, n)
        d, tabs = forward_kernel.kernel_inputs(b.positions, b.lengths,
                                               b.is_bleached, tb, W, n)
        args.append((d, [t.detach() for t in tabs]))

    def run():
        for d, tabs in args:
            hist_kernel.launch(d, tabs, 3, S, W, n, **mapping_kw(mapping))
    return run


def k6_runner(smoke, bench, dev, S: int, W: int, mapping=None):
    """Bare K6 launches over the bench buckets, as ``chip_smoke.py`` phase 8
    times them (S states, window W)."""
    from extrack_tpu_torch.core import tables
    from extrack_tpu_torch.ops import refine_kernel
    f32 = dict(dtype=torch.float32, device=dev)
    rates = torch.full((S, S), 0.1, **f32)
    rates.fill_diagonal_(0.0)
    lt = tables.cap_log(tables.transition_matrix(rates))
    sig2 = 2 * torch.linspace(0.0, 0.08, S, **f32) * 0.02
    fw = refine_kernel.build_refine_tables(lt, sig2, W)
    bw = refine_kernel.build_refine_tables(lt.T, sig2, W)
    tabs = [t.contiguous() for t in (fw[0], fw[1], bw[0], bw[1], fw[2])]
    l2 = torch.full((1, 1, 1), 0.02 ** 2, **f32)
    args = [(b.positions.contiguous(), b.lengths.contiguous(),
             l2.expand(b.positions.shape).contiguous()) for b in bench]

    def run():
        for pos, lens, l2_ in args:
            refine_kernel.launch(pos, lens, l2_, tabs, S,
                                 **mapping_kw(mapping))
    return run


def kernel_times(run):
    """(kernel name, device ms) of one pass of ``run`` under
    torch.profiler, longest first."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = []
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        if t and "extrack" in e.key:
            out.append((e.key.split("(")[0], t / 1e3))
    return sorted(out, key=lambda kt: -kt[1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--kernel", choices=("k1", "k4", "k5", "k6", "both"),
                    default="both")
    ap.add_argument("--states", type=int, default=2)
    ap.add_argument("--window", type=int, default=0,
                    help="K1 6, K4 5, K5 and K6 7 unless given")
    ap.add_argument("--lengths", default="3:10")
    ap.add_argument("--dt", action="store_true",
                    help="K5: per-track dt uniform in chip_smoke.BENCH_DT "
                         "(the streamed table)")
    ap.add_argument("--substeps", type=int, default=1,
                    help="K5: sub-steps a frame (W=7 sub-steps)")
    ap.add_argument("--walks", type=int, default=0,
                    help="random walks (chip_smoke.BENCH_TRACKS unless "
                         "given)")
    ap.add_argument("--dims", type=int, default=2)
    ap.add_argument("--mapping", choices=("block", "wide"),
                    help="force a block a track with a thread a slot or "
                         "a thread a fusion group (K4, K5, K6; K1 wide)")
    a = ap.parse_args()
    lo, hi = (int(v) for v in a.lengths.split(":"))
    from extrack_tpu_torch.ops import cuda_lib
    if a.split:
        cuda_lib.enable_profile()
    spec = importlib.util.spec_from_file_location("smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda", 0)
    lib_path = cuda_lib.build()
    cuda_lib.library()
    bench = smoke.bench_buckets(dev, T=hi, lo=lo,
                                dt_range=smoke.BENCH_DT if a.dt else None,
                                n=a.walks or smoke.BENCH_TRACKS, D=a.dims)
    runs = []
    if a.kernel == "k1":
        W = a.window or 6
        runs.append(("forward", f"K1 S={a.states} W={W} lengths {lo}..{hi}",
                     k1_runner(smoke, bench, dev, a.states, W,
                               a.mapping)))
    if a.kernel == "k4":
        W = a.window or 5
        runs.append(("predict", f"K4 S={a.states} W={W} lengths {lo}..{hi}",
                     k4_runner(smoke, bench, dev, a.states, W,
                               a.mapping)))
    if a.kernel in ("k5", "both"):
        W = a.window or 7
        runs.append(("hist", f"K5 S={a.states} W={W} n={a.substeps}"
                     + (" per-track dt" if a.dt else ""),
                     k5_runner(smoke, bench, dev, a.substeps, a.states, W,
                               a.mapping)))
    if a.kernel in ("k6", "both"):
        W = a.window or 7
        runs.append(("refine", f"K6 S={a.states} W={W} D={a.dims}, "
                     f"{a.walks or smoke.BENCH_TRACKS} walks of {lo}..{hi}",
                     k6_runner(smoke, bench, dev, a.states, W,
                               a.mapping)))
    for name, what, run in runs:
        if a.split:
            run()
            torch.cuda.synchronize()
            cuda_lib.profile_counters(name)
            ms = smoke.cuda_ms(run, REPS, warmup=0)
            cyc = cuda_lib.profile_counters(name)
            print(f"{what}, profile build: {ms:.3f} ms per pass (marks "
                  f"included); lead-thread cycles over {REPS} passes:")
            if name == "refine" and sum(cyc[6:9]):
                for kname, t in kernel_times(run):
                    print(f"  {t:10.3f} ms a pass  {kname}")
                groups = [range(0, 6), range(6, 9)]
            else:
                groups = [range(len(SECTIONS[name]))]
            for g in groups:
                total = max(sum(cyc[i] for i in g), 1)
                for i in g:
                    if SECTIONS[name][i]:
                        print(f"  {cyc[i] / total * 100:6.2f}%  "
                              f"{cyc[i]:16d}  {SECTIONS[name][i]}")
        else:
            ms = smoke.cuda_ms(run, REPS, warmup=2)
            print(f"{what}: {ms:.3f} ms per pass (CUDA events, median of "
                  f"{REPS})")
    if not a.split:
        keep = False
        # K1 and K4 are the walk kernels with PRED false and true
        names = {"k1": ("walk_", "Lb0E"), "k4": ("walk_", "Lb1E"),
                 "k5": ("hist_",), "k6": ("refine_",),
                 "both": ("hist_", "refine_")}[a.kernel]
        for line in lib_path.with_suffix(".log").read_text().splitlines():
            if "Compiling entry" in line:
                keep = (all(n in line for n in names) if a.kernel in
                        ("k1", "k4") else any(n in line for n in names))
            if keep and ("registers" in line or "spill" in line
                         or "Compiling entry" in line):
                print("  ptxas " + line.strip())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
