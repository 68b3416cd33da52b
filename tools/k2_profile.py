#!/usr/bin/env python3
"""Where K2's time goes (csrc/grad.cuh), at ``chip_smoke.py``'s bench shape:
2 states, W=6 (K=64), D=2, 2^20 tracks of lengths 3..10 in four length
buckets, f32 (``--states``/``--window`` change the register; ``--hvp``
times K3 on tangents drawn from one seed instead).

    python3 tools/k2_profile.py [--mapping block|warp] [--stash smem|global]
    python3 tools/k2_profile.py --split [--mapping ...] [--stash ...]

Without ``--split`` it times REPS bare launches over the four buckets by
CUDA events and splits one pass's device time between the walk and the
partial reduction by ``torch.profiler``, then prints nvcc's register and
spill report of every kernel (K2's and K3's instantiations among them).  With ``--split`` it builds
the kernels with their clock64 marks (``cuda_lib.enable_profile``), runs
the same launches and prints each section's share of the cycles that the
tracks' lead threads spent (a cycle count summed over all tracks; the
marks themselves cost a little, so read shares, not times).
``--mapping``/``--stash`` force K2's mapping and where its carry history
lives; by default the wrapper chooses.  The last line is the card's name
and power limit.
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
REPS = 10
SECTIONS = ["forward: carry history writes", "forward: update and fusion",
            "forward: closing", "backward: carry history reads",
            "backward: update recomputed", "backward: closing pullback",
            "backward: fusion pullback", "backward: prep_bwd and l2 sums",
            "initial register sums", "partial writes", "", ""]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--mapping", choices=("block", "warp"))
    ap.add_argument("--stash", choices=("smem", "global"))
    ap.add_argument("--states", type=int, default=2)
    ap.add_argument("--window", type=int, default=6)
    ap.add_argument("--hvp", action="store_true",
                    help="time K3 (one tangent direction) instead of K2")
    a = ap.parse_args()
    from extrack_tpu_torch.core import tables
    from extrack_tpu_torch.ops import (cuda_lib, forward_kernel, grad_kernel,
                                       hvp_kernel)
    if a.split:
        cuda_lib.enable_profile()
    spec = importlib.util.spec_from_file_location("smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda", 0)
    lib_path = cuda_lib.build()
    cuda_lib.library()
    f32 = dict(dtype=torch.float32, device=dev)
    S = a.states
    rates = torch.full((S, S), 0.1, **f32)
    rates.fill_diagonal_(0.0)
    tb = tables.build_tables(
        torch.linspace(0.0, 0.08, S, **f32), torch.tensor(0.02, **f32),
        torch.full((S,), 1.0 / S, **f32), rates, torch.tensor(0.1, **f32),
        0.02, cell_dims=(0.5,))
    args = []
    gen = torch.Generator(device="cpu").manual_seed(5)
    for b in smoke.bench_buckets(dev):
        d, tabs = forward_kernel.kernel_inputs(b.positions, b.lengths,
                                               b.is_bleached, tb, a.window,
                                               1)
        tabs = [t.detach() for t in tabs]
        dots = [1e-3 * torch.randn(t.shape, generator=gen).to(dev)
                for t in tabs]
        args.append((d, tabs, dots))
    opts = {k: v for k, v in (("mapping", a.mapping), ("stash", a.stash))
            if v is not None}

    def run():
        for d, tabs, dots in args:
            if a.hvp:
                hvp_kernel.launch(d, tabs, torch.zeros_like(d[1]), dots, 3,
                                  **opts)
            else:
                grad_kernel.launch(d, tabs, 3, **opts)

    what = (f"{'K3' if a.hvp else 'K2'} S={S} W={a.window}, mapping "
            f"{a.mapping or 'default'}, carry history "
            f"{a.stash or 'default'}")
    if a.split:
        run()
        torch.cuda.synchronize()
        cuda_lib.profile_counters("grad")
        ms = smoke.cuda_ms(run, REPS, warmup=0)
        cyc = cuda_lib.profile_counters("grad")
        total = sum(cyc)
        print(f"{what}, profile build: {ms:.3f} ms per pass (marks "
              f"included); lead-thread cycles over {REPS} passes:")
        for name, c in zip(SECTIONS, cyc):
            if c:
                print(f"  {c / total * 100:6.2f}%  {c:16d}  {name}")
    else:
        ms = smoke.cuda_ms(run, REPS, warmup=2)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        print(f"{what}: {ms:.3f} ms per pass (CUDA events, median of "
              f"{REPS}); one pass by torch.profiler:")
        for e in sorted(prof.key_averages(),
                        key=lambda e: -e.self_device_time_total):
            if e.self_device_time_total > 0:
                print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
                      f"{e.count:4d}x  {e.key[:90]}")
        for line in lib_path.with_suffix(".log").read_text().splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                print("  ptxas " + line.strip())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
