#!/usr/bin/env python3
"""Bare-launch times of K1 (csrc/forward.cu) and K2 (csrc/grad.cu) for two
checkouts of the port, alternated on one card.

    python3 tools/kernel_ab.py PARENT_ROOT CHANGE_ROOT

Each side runs in a process of its own, importing ``extrack_tpu_torch``
from its root (and building that root's kernels there), at
``chip_smoke.py``'s bench shape: 2 states, W=6, D=2, 2^20 tracks of
lengths 3..10 in four length buckets, f32.  Over PAIRS rounds, round i
runs the two sides in the order (parent, change) when i is even and
(change, parent) when it is odd, so a drift of the card's clock over the
call weighs on both.  Each
process prints the median of REPS timed passes (CUDA events, after two
warm-up passes); the script prints one line per process, then each side's
median over its rounds and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
PAIRS = 5
REPS = 20


def worker(root: str) -> None:
    """Time bare K1 and K2 launches of the package under ``root``."""
    sys.path.insert(0, root)
    import torch

    from extrack_tpu_torch.core import tables
    from extrack_tpu_torch.ops import cuda_lib, forward_kernel, grad_kernel
    # chip_smoke's helpers import extrack_tpu_torch lazily, so they use the
    # package under ``root``
    spec = importlib.util.spec_from_file_location("smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert Path(forward_kernel.__file__).resolve().is_relative_to(
        Path(root).resolve()), forward_kernel.__file__
    cuda_lib.library()
    dev = torch.device("cuda", 0)
    f32 = dict(dtype=torch.float32, device=dev)
    tb = tables.build_tables(
        torch.tensor([0.0, 0.08], **f32), torch.tensor(0.02, **f32),
        torch.tensor([0.5, 0.5], **f32),
        torch.tensor([[0.0, 0.1], [0.1, 0.0]], **f32),
        torch.tensor(0.1, **f32), 0.02, cell_dims=(0.5,))
    args = []
    for b in smoke.bench_buckets(dev):
        d, tabs = forward_kernel.kernel_inputs(b.positions, b.lengths,
                                               b.is_bleached, tb, 6, 1)
        args.append((d, [t.detach() for t in tabs]))

    def k1():
        for d, tabs in args:
            forward_kernel.launch(d, tabs, 3)

    def k2():
        for d, tabs in args:
            grad_kernel.launch(d, tabs, 3)

    print(json.dumps({"K1": smoke.cuda_ms(k1, REPS, warmup=2),
                      "K2": smoke.cuda_ms(k2, REPS, warmup=2)}), flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2])
        return 0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    a = ap.parse_args()
    sides = {"parent": a.parent, "change": a.change}
    times = {"parent": [], "change": []}
    for i in range(PAIRS):
        for side in (("parent", "change") if i % 2 == 0
                     else ("change", "parent")):
            out = subprocess.run(
                [sys.executable, __file__, "--worker", sides[side]],
                capture_output=True, text=True)
            if out.returncode != 0:
                print(out.stdout + out.stderr, file=sys.stderr)
                return 1
            t = json.loads(out.stdout.strip().splitlines()[-1])
            times[side].append(t)
            print(f"round {i} {side}: K1 {t['K1']:.4f} ms, K2 "
                  f"{t['K2']:.4f} ms", flush=True)
    for side, ts in times.items():
        for k in ("K1", "K2"):
            xs = sorted(t[k] for t in ts)
            print(f"{side} {k}: median {xs[len(xs) // 2]:.4f} ms, range "
                  f"{xs[0]:.4f}-{xs[-1]:.4f} ms over {len(xs)} processes")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
