#!/usr/bin/env python3
"""Bare-launch times of K1 (csrc/forward.cu), K2 (csrc/grad.cu), K3
(csrc/hvp.cu, one tangent direction), K4 (csrc/predict.cu), K5
(csrc/hist.cu), K6 (csrc/refine.cu) and, where both checkouts have it, K7
(csrc/topk.cu) for two checkouts of the port, alternated on one card.

    python3 tools/kernel_ab.py PARENT_ROOT CHANGE_ROOT [--pairs N]
        [--k1 | --k4 | --wide | --deep | --refine]

Each side runs in a process of its own, importing ``extrack_tpu_torch``
from its root (and building that root's kernels there), at
``chip_smoke.py``'s bench shape: 2 states, W=6, D=2, 2^20 tracks of
lengths 3..10 in four length buckets, f32, and K2 also with 3 states at
W=5 (K=243, a 3-state fit's default window); K3 on tangents drawn from one
seed; K4 at W=5, and on the main path's 93,963 simulated tracks bare and
through ``predict_Bs``; K5 and K6 at W=7 (K=128) as ``chip_smoke.py``
times them (``tools/walk_profile.py``'s launches), K6 also with 3 states
at W=5 (K=243); K7 with a register of M=512 sequences, as
``chip_smoke.py`` times it, bare (``chip_smoke.topk_bare``: the fused
kernel where the checkout has it, else the kernel that writes
backpointers) and through
``segment_topk`` (with the decode), and both again on 2^20 tracks of
lengths 3..30 at M=128.  Over PAIRS
rounds, round i
runs the two sides in the order (parent, change) when i is even and
(change, parent) when it is odd, so a drift of the card's clock over the
call weighs on both.  Each
process prints the median of REPS timed passes (CUDA events, after two
warm-up passes); the script prints one line per process, then each side's
median over its rounds and the card's name and power limit.  Then it
compares the two builds' SASS (``cuobjdump -sass``, instructions without
addresses) function by function: every kernel instantiation both builds
have is named identical or different, and those only the change has are
listed (``--pairs 0``: the SASS alone, each side only built).  ``--k1``
times K1 alone (a check of a kernel whose source did not
change, without the other kernels' heat in the same process).  ``--k4``
times K4 alone: at the bench shape, on the main path's tracks bare, and
through ``predict_Bs`` (host work included, so more passes).  ``--wide``
times K2 and K3 alone on their wide mapping at 4 states, W=6 (K=4096)
and 3 states, W=7 (K=2187), on ``chip_smoke.py``'s phase-16 bench
(``WIDE16_TRACKS`` walks of lengths 3..10, D=2), at K=4096 with
per-track dt in ``BENCH_DT`` (the variable-dt instantiations), and at
6^5, 6^4 and 2^12.
``--deep`` times K2 and K3 past 2048 fusion groups (5^6, 4^7, 6^6, 4^8,
3^9, D=2) on ``chip_smoke.PAST4096_TRACKS`` walks of lengths 3..10, as
phases 17 and 19 time them, REPS_DEEP passes a side and round, each side
on its own plan.
``--refine`` times K6 alone on its wide mapping past 1024 slots
(REFINE_SHAPES: 6^4, 3^7, 4^6, 5^5 and, past 4096 slots, 4^7, 5^6, 3^8
and 2^14, each at D = 1..3, on random walks of lengths 3..10 as
``chip_smoke.py`` phases 11 and 18 time them), REPS_REFINE passes a side
and round, each side on its own plan; its SASS check then names every
differing function outside K6's wide mapping (``refine_*`` kernels other
than ``refine_kernel``, K6's block mapping) and fails on one.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
PAIRS = 5
REPS = 20
REPS_K6 = 5
REPS_K7 = 5


def load_module(name: str, path: Path):
    """A module of this checkout's scripts by path (they import
    ``extrack_tpu_torch`` lazily, so they use the package on sys.path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def k4_main_path(smoke, dev):
    """Two functions on the main path's tracks (``chip_smoke.SIM``, 93,963
    tracks in four length buckets, T = 5, 9, 14, 20): bare K4 launches over
    the buckets at W=5, and ``predict.predict_Bs`` (frame_len=5), the entry
    point, host work included."""
    import torch

    from extrack_tpu_torch import data, params, predict, simulate
    from extrack_tpu_torch.core import tables
    from extrack_tpu_torch.ops import forward_kernel, predict_kernel
    tracks, _, _ = simulate.sim_fov(**smoke.SIM)
    values = {"LocErr": 0.02, "D0": 0.0, "D1": 0.08, "F0": 0.5, "F1": 0.5,
              "p01": 0.1, "p10": 0.1, "pBL": 0.1}
    buckets = data.from_dict_bucketed(tracks, max_buckets=4, device=dev,
                                      dtype=torch.float32)
    Ds, Fs, rates, loc_err, pBL = params.extract_arrays(
        values, 2, device=dev, dtype=torch.float32)
    tb = tables.build_tables(Ds, loc_err, Fs, rates, pBL, 0.02,
                             cell_dims=(0.5,))
    min_len = data.default_min_len(
        np.concatenate([data.host_lengths(b) for b in buckets]))
    args = []
    for b in buckets:
        d, tabs = forward_kernel.kernel_inputs(b.positions, b.lengths,
                                               b.is_bleached, tb, 5, 1)
        args.append((d, [t.detach() for t in tabs]))

    def bare():
        for d, tabs in args:
            predict_kernel.launch(d, tabs, min_len, 2, 5)

    def entry():
        predict.predict_Bs(tracks, 0.02, values, cell_dims=(0.5,),
                           nb_states=2, frame_len=5)
    return bare, entry


WIDE_SHAPES = ((4, 6, False), (3, 7, False), (4, 6, True), (6, 5, False),
               (6, 4, False), (2, 12, False))
DEEP_SHAPES = ((5, 6, False), (4, 7, False), (6, 6, False), (4, 8, False),
               (3, 9, False))
REPS_DEEP = 5
# K6's wide shapes (S, W, walks), each at D = 1..3: 2^14 walks at 6^4 (as
# phase 11), 2^12 to 4096 slots, 2^10 past it (as phase 18), 2^9 at 2^14
# (twice 4^7's pairs a position)
REFINE_SHAPES = ((6, 4, 1 << 14), (3, 7, 1 << 12), (4, 6, 1 << 12),
                 (5, 5, 1 << 12), (4, 7, 1 << 10), (5, 6, 1 << 10),
                 (3, 8, 1 << 10), (2, 14, 1 << 9))
REPS_REFINE = 3


def refine_times(smoke, dev) -> dict:
    """K6's bare times (ms) at REFINE_SHAPES, D = 1..3: the model of
    ``chip_smoke.py``'s phase-18 timing (a 0.9 diagonal, the states'
    displacement variances (0.08 (s+1))^2, l2 = 4e-4)."""
    import torch

    from extrack_tpu_torch.core import tables
    from extrack_tpu_torch.ops import refine_kernel
    f32 = dict(dtype=torch.float32, device=dev)
    out = {}
    for S, W, n in REFINE_SHAPES:
        tr = np.full((S, S), 0.1 / (S - 1)) + np.eye(S) * (0.9 - 0.1
                                                           / (S - 1))
        lt = tables.cap_log(torch.tensor(tr, **f32))
        s2 = torch.tensor((0.08 * (1 + np.arange(S))) ** 2, **f32)
        tabs = [t.contiguous() for t in (
            *refine_kernel.build_refine_tables(lt, s2, W)[:2],
            *refine_kernel.build_refine_tables(lt.T, s2, W))]
        for D in (1, 2, 3):
            bench = smoke.bench_buckets(dev, n=n, D=D)
            prep = [(b.positions, b.lengths.to(torch.int32),
                     torch.full(b.positions.shape, 4e-4, **f32))
                    for b in bench]

            def run():
                for p_, l_, e_ in prep:
                    refine_kernel.launch(p_, l_, e_, tabs, S)
            out[f"K6 S={S} W={W} D={D}"] = smoke.cuda_ms(
                run, REPS_REFINE, warmup=1)
            del bench, prep
    return out


def wide_times(smoke, dev, deep: bool = False) -> dict:
    """K2's and K3's bare times (ms) on the wide mapping at WIDE_SHAPES:
    (S, W) = (4, 6) and (3, 7), as ``chip_smoke.py``'s phase 16 times
    them, (4, 6) with per-track dt, and 6^5, 6^4 and 2^12 (1296, 216 and
    2048 fusion groups); ``deep``: past 2048 fusion groups instead
    (DEEP_SHAPES, on ``chip_smoke.PAST4096_TRACKS`` walks, as phases 17
    and 19 time them)."""
    import torch

    from extrack_tpu_torch.core import tables
    from extrack_tpu_torch.ops import forward_kernel, grad_kernel, hvp_kernel
    f32 = dict(dtype=torch.float32, device=dev)
    n = smoke.PAST4096_TRACKS if deep else smoke.WIDE16_TRACKS
    reps = REPS_DEEP if deep else REPS
    benches = {False: smoke.bench_buckets(dev, n=n),
               True: smoke.bench_buckets(dev, n=n, dt_range=smoke.BENCH_DT)}
    out = {}
    for S, W, dt in DEEP_SHAPES if deep else WIDE_SHAPES:
        rates = torch.full((S, S), 0.1, **f32)
        rates.fill_diagonal_(0.0)
        gen = torch.Generator(device="cpu").manual_seed(S ** W)
        args = []
        for b in benches[dt]:
            tb = tables.build_tables(
                torch.linspace(0.0, 0.08, S, **f32),
                torch.tensor(0.02, **f32), torch.full((S,), 1.0 / S, **f32),
                rates, torch.tensor(0.1, **f32), b.dt if dt else 0.02,
                cell_dims=(0.5,))
            d, t = forward_kernel.kernel_inputs(b.positions, b.lengths,
                                                b.is_bleached, tb, W, 1)
            t = [x.detach() for x in t]
            args.append((d, t, [1e-3 * torch.randn(
                x.shape, generator=gen).to(dev) for x in t]))

        def k2():
            for d, t, _ in args:
                grad_kernel.launch(d, t, 3)

        def k3():
            for d, t, t_dot in args:
                hvp_kernel.launch(d, t, torch.zeros_like(d[1]), t_dot, 3)

        tag = f"S={S} W={W}" + (" dt" if dt else "")
        out[f"K2 {tag}"] = smoke.cuda_ms(k2, reps, warmup=2)
        out[f"K3 {tag}"] = smoke.cuda_ms(k3, reps, warmup=2)
    return out


def worker(root: str, only: str) -> None:
    """Time bare launches of every kernel of the package under ``root``
    (``only`` "--k1": K1 alone; "--k4": K4 alone, at the bench shape and
    on the main path, bare and through ``predict_Bs``)."""
    sys.path.insert(0, root)
    import torch

    from extrack_tpu_torch.core import tables
    from extrack_tpu_torch.ops import (cuda_lib, forward_kernel, grad_kernel,
                                       hvp_kernel)
    # chip_smoke's helpers import extrack_tpu_torch lazily, so they use the
    # package under ``root``
    smoke = load_module("smoke", HERE / "chip_smoke.py")
    assert Path(forward_kernel.__file__).resolve().is_relative_to(
        Path(root).resolve()), forward_kernel.__file__
    cuda_lib.library()
    dev = torch.device("cuda", 0)
    if only == "--refine":
        print(json.dumps({**refine_times(smoke, dev),
                          "lib": str(cuda_lib.library_path())}), flush=True)
        return
    if only in ("--wide", "--deep"):
        print(json.dumps({**wide_times(smoke, dev, only == "--deep"),
                          "lib": str(cuda_lib.library_path())}), flush=True)
        return
    f32 = dict(dtype=torch.float32, device=dev)
    tb = tables.build_tables(
        torch.tensor([0.0, 0.08], **f32), torch.tensor(0.02, **f32),
        torch.tensor([0.5, 0.5], **f32),
        torch.tensor([[0.0, 0.1], [0.1, 0.0]], **f32),
        torch.tensor(0.1, **f32), 0.02, cell_dims=(0.5,))
    args = []
    bench = smoke.bench_buckets(dev)
    for b in bench:
        d, tabs = forward_kernel.kernel_inputs(b.positions, b.lengths,
                                               b.is_bleached, tb, 6, 1)
        args.append((d, [t.detach() for t in tabs]))

    def k1():
        for d, tabs in args:
            forward_kernel.launch(d, tabs, 3)

    lib = str(cuda_lib.library_path())
    if only == "--lib":
        print(json.dumps({"lib": lib}), flush=True)
        return
    if only == "--k1":
        print(json.dumps({"K1": smoke.cuda_ms(k1, 2 * REPS, warmup=5),
                          "lib": lib}), flush=True)
        return
    walk = load_module("walk", HERE / "tools" / "walk_profile.py")
    if only == "--k4":
        bare, entry = k4_main_path(smoke, dev)
        print(json.dumps({
            "K4": smoke.cuda_ms(walk.k4_runner(smoke, bench, dev, 2, 5),
                                2 * REPS, warmup=5),
            "K4 main path": smoke.cuda_ms(bare, 2 * REPS, warmup=5),
            "predict_Bs": smoke.cuda_ms(entry, REPS, warmup=3),
            "lib": lib}), flush=True)
        return

    def k2():
        for d, tabs in args:
            grad_kernel.launch(d, tabs, 3)

    gen = torch.Generator(device="cpu").manual_seed(5)
    dots = [[1e-3 * torch.randn(t.shape, generator=gen).to(dev)
             for t in tabs] for _, tabs in args]

    def k3():
        for (d, tabs), dt in zip(args, dots):
            hvp_kernel.launch(d, tabs, torch.zeros_like(d[1]), dt, 3)

    rates3 = torch.full((3, 3), 0.1, **f32)
    rates3.fill_diagonal_(0.0)
    tb3 = tables.build_tables(
        torch.linspace(0.0, 0.08, 3, **f32), torch.tensor(0.02, **f32),
        torch.full((3,), 1.0 / 3, **f32), rates3, torch.tensor(0.1, **f32),
        0.02, cell_dims=(0.5,))
    args3 = []
    for b in bench:
        d, tabs = forward_kernel.kernel_inputs(b.positions, b.lengths,
                                               b.is_bleached, tb3, 5, 1)
        args3.append((d, [t.detach() for t in tabs]))

    def k2_243():
        for d, tabs in args3:
            grad_kernel.launch(d, tabs, 3)

    out = {"K1": smoke.cuda_ms(k1, REPS, warmup=2),
           "K2": smoke.cuda_ms(k2, REPS, warmup=2),
           "K2 S=3 W=5": smoke.cuda_ms(k2_243, REPS, warmup=2),
           "K3": smoke.cuda_ms(k3, REPS, warmup=2)}
    del args3
    out["K4"] = smoke.cuda_ms(walk.k4_runner(smoke, bench, dev, 2, 5), REPS,
                              warmup=2)
    bare, entry = k4_main_path(smoke, dev)
    out["K4 main path"] = smoke.cuda_ms(bare, REPS, warmup=2)
    out["predict_Bs"] = smoke.cuda_ms(entry, REPS_K7, warmup=1)
    out["K5"] = smoke.cuda_ms(walk.k5_runner(smoke, bench, dev), REPS,
                              warmup=2)
    out["K6"] = smoke.cuda_ms(walk.k6_runner(smoke, bench, dev, 2, 7), REPS_K6,
                              warmup=1)
    out["K6 S=3 W=5"] = smoke.cuda_ms(walk.k6_runner(smoke, bench, dev, 3, 5),
                                      REPS_K6, warmup=1)
    if (Path(root) / "extrack_tpu_torch" / "ops" / "topk_kernel.py").exists():
        out["K7"] = smoke.cuda_ms(smoke.topk_bare(bench, tb, 512, dev),
                                  REPS_K7)
        out["K7+decode"] = smoke.cuda_ms(smoke.topk_wrapped(bench, tb, 512),
                                         REPS_K7)
        del bench, args
        bench30 = smoke.bench_buckets(dev, T=30)
        out["K7 T=30"] = smoke.cuda_ms(smoke.topk_bare(bench30, tb, 128, dev),
                                       REPS_K7)
        out["K7+decode T=30"] = smoke.cuda_ms(
            smoke.topk_wrapped(bench30, tb, 128), REPS_K7)
    out["lib"] = lib
    print(json.dumps(out), flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], (sys.argv[3:4] or [""])[0])
        return 0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--pairs", type=int, default=PAIRS)
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--k1", action="store_true")
    only.add_argument("--k4", action="store_true")
    only.add_argument("--wide", action="store_true")
    only.add_argument("--deep", action="store_true")
    only.add_argument("--refine", action="store_true")
    a = ap.parse_args()
    sides = {"parent": a.parent, "change": a.change}
    times = {"parent": [], "change": []}
    libs = {}
    for i in range(a.pairs):
        for side in (("parent", "change") if i % 2 == 0
                     else ("change", "parent")):
            out = subprocess.run(
                [sys.executable, __file__, "--worker", sides[side],
                 *(["--k1"] if a.k1 else ["--k4"] if a.k4 else
                   ["--wide"] if a.wide else ["--deep"] if a.deep else
                   ["--refine"] if a.refine else [])],
                capture_output=True, text=True)
            if out.returncode != 0:
                print(out.stdout + out.stderr, file=sys.stderr)
                return 1
            t = json.loads(out.stdout.strip().splitlines()[-1])
            libs[side] = t.pop("lib", None)
            times[side].append(t)
            print(f"round {i} {side}: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in t.items()), flush=True)
    for side, ts in times.items():
        for k in (ts[0] if ts else ()):
            xs = sorted(t[k] for t in ts)
            print(f"{side} {k}: median {xs[len(xs) // 2]:.4f} ms, range "
                  f"{xs[0]:.4f}-{xs[-1]:.4f} ms over {len(xs)} processes")
    for k in (times["change"][0] if a.pairs else ()):
        lower = sum(c[k] < p[k] for p, c in zip(times["parent"],
                                                times["change"]))
        print(f"{k}: change lower in {lower} of {a.pairs} pairs")
    for side, root in sides.items():
        if side not in libs:            # --pairs 0: build for the SASS only
            out = subprocess.run(
                [sys.executable, __file__, "--worker", root, "--lib"],
                capture_output=True, text=True)
            if out.returncode != 0:
                print(out.stdout + out.stderr, file=sys.stderr)
                return 1
            libs[side] = json.loads(out.stdout.strip().splitlines()[-1])[
                "lib"]
    same, differ, new, gone = compare_sass(libs["parent"], libs["change"])
    print(f"SASS: {len(same)} kernel functions of both builds identical, "
          f"{len(differ)} differ, {len(new)} only in the change, "
          f"{len(gone)} only in the parent")
    for name in differ:
        print(f"  differs: {name}")
    for name in new:
        print(f"  new: {name}")
    for name in gone:
        print(f"  gone: {name}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip())
    if a.refine:
        # K6's wide mapping: the refine_* kernels but the block mapping's
        outside = [d for d in differ if not (
            d.startswith("_ZN7extrack") and "refine_" in d.split("I")[0]
            and "13refine_kernel" not in d.split("I")[0])]
        print(f"SASS outside K6's wide mapping: {len(outside)} differ")
        return 1 if outside else 0
    return 0


def kernel_sass(lib: str) -> dict:
    """Every kernel function of a built library: its mangled name and its
    instructions, without addresses, encodings and padding (``cuobjdump
    -sass``); a call's target, an address that moves with the other
    functions of the library, reads "<callee>"."""
    sys.path.insert(0, str(HERE))
    from extrack_tpu_torch.ops import cuda_lib
    tool = Path(cuda_lib.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for body in text.split("Function : ")[1:]:
        name, _, rest = body.partition("\n")
        out[name.strip()] = [
            re.sub(r"(CALL\.\S*) \S+", r"\1 <callee>",
                   " ".join(line.split("*/")[1].split(";")[0].split()))
            for line in rest.splitlines()
            if line.strip().startswith("/*") and "*/" in line
            and line.split("*/")[1].split(";")[0].strip()]
    return out


def compare_sass(parent_lib: str, change_lib: str):
    """(names identical in both builds, names that differ, names only in
    the change, names only in the parent), each sorted: every
    instantiation both builds have is held to its instructions."""
    a, b = kernel_sass(parent_lib), kernel_sass(change_lib)
    common = sorted(set(a) & set(b))
    differ = []
    for n in common:
        if a[n] != b[n]:
            first = next((i for i, (x, y) in enumerate(zip(a[n], b[n]))
                          if x != y), min(len(a[n]), len(b[n])))
            at = slice(first, first + 1)
            differ.append(f"{n} ({len(a[n])} / {len(b[n])} instructions; "
                          f"first difference at {first}: {a[n][at]} / "
                          f"{b[n][at]})")
    return ([n for n in common if a[n] == b[n]], differ,
            sorted(set(b) - set(a)), sorted(set(a) - set(b)))


if __name__ == "__main__":
    sys.exit(main())
