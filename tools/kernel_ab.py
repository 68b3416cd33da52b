#!/usr/bin/env python3
"""Bare-launch times of K1 (csrc/forward.cu), K2 (csrc/grad.cu), K3
(csrc/hvp.cu, one tangent direction) and, where both checkouts have it, K7
(csrc/topk.cu) for two checkouts of the port, alternated on one card.

    python3 tools/kernel_ab.py PARENT_ROOT CHANGE_ROOT [--pairs N] [--k1]

Each side runs in a process of its own, importing ``extrack_tpu_torch``
from its root (and building that root's kernels there), at
``chip_smoke.py``'s bench shape: 2 states, W=6, D=2, 2^20 tracks of
lengths 3..10 in four length buckets, f32, and K2 also with 3 states at
W=5 (K=243, a 3-state fit's default window); K3 on tangents drawn from one
seed; K7 with a register of M=512 sequences, as ``chip_smoke.py`` times
it, bare (``chip_smoke.topk_bare``: the fused kernel where the checkout
has it, else the kernel that writes backpointers) and through
``segment_topk`` (with the decode), and both again on 2^20 tracks of
lengths 3..30 at M=128.  Over PAIRS
rounds, round i
runs the two sides in the order (parent, change) when i is even and
(change, parent) when it is odd, so a drift of the card's clock over the
call weighs on both.  Each
process prints the median of REPS timed passes (CUDA events, after two
warm-up passes); the script prints one line per process, then each side's
median over its rounds and the card's name and power limit.  ``--k1``
times K1 alone (a check of a kernel whose source did not change, without
the other kernels' heat in the same process) and then compares
``forward_kernel<2>``'s SASS in the two builds (``cuobjdump -sass``).
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
REPS_K7 = 5


def worker(root: str, k1_only: bool) -> None:
    """Time bare K1, K2, K3 and K7 launches of the package under
    ``root`` (K1 alone with ``k1_only``)."""
    sys.path.insert(0, root)
    import torch

    from extrack_tpu_torch.core import tables
    from extrack_tpu_torch.ops import (cuda_lib, forward_kernel, grad_kernel,
                                       hvp_kernel)
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
    bench = smoke.bench_buckets(dev)
    for b in bench:
        d, tabs = forward_kernel.kernel_inputs(b.positions, b.lengths,
                                               b.is_bleached, tb, 6, 1)
        args.append((d, [t.detach() for t in tabs]))

    def k1():
        for d, tabs in args:
            forward_kernel.launch(d, tabs, 3)

    if k1_only:
        print(json.dumps({"K1": smoke.cuda_ms(k1, 2 * REPS, warmup=5),
                          "lib": str(cuda_lib.library_path())}), flush=True)
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
    print(json.dumps(out), flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], sys.argv[3:4] == ["--k1"])
        return 0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--pairs", type=int, default=PAIRS)
    ap.add_argument("--k1", action="store_true")
    a = ap.parse_args()
    sides = {"parent": a.parent, "change": a.change}
    times = {"parent": [], "change": []}
    libs = {}
    for i in range(a.pairs):
        for side in (("parent", "change") if i % 2 == 0
                     else ("change", "parent")):
            out = subprocess.run(
                [sys.executable, __file__, "--worker", sides[side],
                 *(["--k1"] if a.k1 else [])],
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
        for k in ts[0]:
            xs = sorted(t[k] for t in ts)
            print(f"{side} {k}: median {xs[len(xs) // 2]:.4f} ms, range "
                  f"{xs[0]:.4f}-{xs[-1]:.4f} ms over {len(xs)} processes")
    for k in times["change"][0]:
        lower = sum(c[k] < p[k] for p, c in zip(times["parent"],
                                                times["change"]))
        print(f"{k}: change lower in {lower} of {a.pairs} pairs")
    if a.k1:
        sass = {side: forward_sass(lib) for side, lib in libs.items()}
        print(f"forward_kernel<2> SASS: {len(sass['parent'])} and "
              f"{len(sass['change'])} instructions, identical: "
              f"{sass['parent'] == sass['change']}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip())
    return 0


def forward_sass(lib: str) -> list:
    """The instructions of forward_kernel<2> in a built library, without
    addresses and encodings."""
    sys.path.insert(0, str(HERE))
    from extrack_tpu_torch.ops import cuda_lib
    tool = Path(cuda_lib.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    body = next((b for b in text.split("Function : ")
                 if b.startswith("_ZN7extrack14forward_kernelILi2E")), "")
    return [line.split("*/")[1].strip() for line in body.splitlines()
            if line.strip().startswith("/*") and "*/" in line
            and line.split("*/")[1].strip()]


if __name__ == "__main__":
    sys.exit(main())
