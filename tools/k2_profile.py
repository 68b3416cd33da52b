#!/usr/bin/env python3
"""Where K2's time goes (csrc/grad.cuh), at ``chip_smoke.py``'s bench shape:
2 states, W=6 (K=64), D=2, 2^20 tracks of lengths 3..10 in four length
buckets, f32 (``--states``/``--window`` change the register; ``--hvp``
times K3 on tangents drawn from one seed instead).

    python3 tools/k2_profile.py [--mapping block|warp|wide]
        [--stash smem|global] [--tracks N]
    python3 tools/k2_profile.py --split [--mapping ...] [--stash ...]
    python3 tools/k2_profile.py --mappings block,wide [--states S
        --window W] [--hvp]

Without ``--split`` it times REPS bare launches over the four buckets by
CUDA events and splits one pass's device time between the walk and the
partial reduction by ``torch.profiler``, then prints nvcc's register and
spill report of every kernel (K2's and K3's instantiations among them).  With ``--split`` it builds
the kernels with their clock64 marks (``cuda_lib.enable_profile``), runs
the same launches and prints each section's share of the cycles that the
tracks' lead threads spent (a cycle count summed over all tracks; the
marks themselves cost a little, so read shares, not times).
``--mapping``/``--stash`` force K2's mapping ("wide:8": the wide mapping
with 8 blocks a cluster) and where its carry history (the wide mapping:
its exchange of carry cotangents) lives; by default the wrapper chooses.
``--mappings`` times two or more mappings of the same launches against
each other in one process, in turns (A, B, B, A over ROUNDS rounds), and
prints each one's median.  ``--tracks`` takes fewer
random walks than the bench's 2^20.  The last line is the card's name
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
ROUNDS = 4
SECTIONS = ["forward: carry history writes", "forward: update and fusion",
            "forward: closing", "backward: carry history reads",
            "backward: update recomputed", "backward: closing pullback",
            "backward: fusion pullback", "backward: prep_bwd and l2 sums",
            "initial register sums", "partial writes", "", ""]
# the wide mapping's sections (csrc/grad.cuh kPw*)
WIDE_SECTIONS = ["forward: fusion steps", "forward: fusion barriers",
                 "forward: closing", "backward: exchange reads",
                 "backward: fusion weights recomputed",
                 "backward: members' pullbacks and writes",
                 "backward: closing pullback",
                 "backward: l2 sums, stream rows, barriers",
                 "backward: barrier before the exchange is reused",
                 "set-up and partial rows", "", ""]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--mapping", help="block, warp, wide or wide:C (C "
                    "blocks a cluster)")
    ap.add_argument("--mappings", help="comma-separated mappings to time "
                    "against each other, in turns")
    ap.add_argument("--tracks", type=int, default=1 << 20)
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
    for b in smoke.bench_buckets(dev, n=a.tracks):
        d, tabs = forward_kernel.kernel_inputs(b.positions, b.lengths,
                                               b.is_bleached, tb, a.window,
                                               1)
        tabs = [t.detach() for t in tabs]
        dots = [1e-3 * torch.randn(t.shape, generator=gen).to(dev)
                for t in tabs]
        args.append((d, tabs, dots))
    def forced(mapping):
        """The launch options that force ``mapping`` ("wide:C": the wide
        mapping with C blocks a cluster) and ``--stash``."""
        name, _, size = (mapping or "").partition(":")
        return {k: v for k, v in (("mapping", name or None),
                                  ("stash", a.stash),
                                  ("cluster", int(size) if size else None))
                if v is not None}

    opts = forced(a.mapping)

    def run():
        for d, tabs, dots in args:
            if a.hvp:
                hvp_kernel.launch(d, tabs, torch.zeros_like(d[1]), dots, 3,
                                  **opts)
            else:
                grad_kernel.launch(d, tabs, 3, **opts)

    if a.mappings:
        names = a.mappings.split(",")
        times = {m: [] for m in names}
        kernel = 'K3' if a.hvp else 'K2'
        for r in range(ROUNDS):
            for m in (names if r % 2 == 0 else names[::-1]):
                opts = forced(m)
                times[m].append(smoke.cuda_ms(run, REPS, warmup=2))
        for m in names:
            print(f"{kernel} S={S} W={a.window} (K={S ** a.window}) D=2, "
                  f"{a.tracks} tracks of lengths 3..10, {m} mapping: "
                  f"{sorted(times[m])[len(times[m]) // 2]:.3f} ms per pass "
                  f"(median of {ROUNDS} rounds of {REPS}; rounds "
                  + ", ".join(f"{t:.3f}" for t in times[m]) + ")")
    what = (f"{'K3' if a.hvp else 'K2'} S={S} W={a.window}, mapping "
            f"{a.mapping or 'default'}, carry history "
            f"{a.stash or 'default'}")
    if a.mappings:
        pass
    elif a.split:
        run()
        torch.cuda.synchronize()
        unit = "hvp" if a.hvp else "grad"
        cuda_lib.profile_counters(unit)
        ms = smoke.cuda_ms(run, REPS, warmup=0)
        cyc = cuda_lib.profile_counters(unit)
        total = sum(cyc)
        wide = (a.mapping.startswith("wide") if a.mapping
                else S ** a.window > grad_kernel.BLOCK_MAX_K)
        print(f"{what}, profile build: {ms:.3f} ms per pass (marks "
              f"included); lead-thread cycles over {REPS} passes:")
        for name, c in zip(WIDE_SECTIONS if wide else SECTIONS, cyc):
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
