#!/usr/bin/env python3
"""Where the time of ``topk_kernel.segment_topk`` (K7 and the backpointer
decode) goes on one chunk of 32768 tracks, by ``torch.profiler``.

    python3 tools/topk_profile.py

At ``chip_smoke.py``'s two K7 bench shapes (2 states, D=2, f32: lengths
3..10 at M=512, lengths 3..30 at M=128) it takes the first 32768 tracks
of the largest length bucket, runs ``segment_topk`` twice to warm up,
then profiles REPS calls and prints, per call, the total device time,
the aten operators' device time (their kernels' included) and the
kernels' own, the largest first, with the card's name and power limit.
"""
from __future__ import annotations

import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
REPS = 3
ROWS = 18


def main() -> int:
    from extrack_tpu_torch import data
    from extrack_tpu_torch.core import tables
    from extrack_tpu_torch.histograms import TOPK_CHUNK
    from extrack_tpu_torch.ops import topk_kernel
    from torch.profiler import ProfilerActivity, profile

    spec = importlib.util.spec_from_file_location("smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda", 0)
    f32 = dict(dtype=torch.float32, device=dev)
    tb = tables.build_tables(
        torch.tensor([0.0, 0.08], **f32), torch.tensor(0.02, **f32),
        torch.tensor([0.5, 0.5], **f32),
        torch.tensor([[0.0, 0.1], [0.1, 0.0]], **f32),
        torch.tensor(0.1, **f32), 0.02, cell_dims=(0.5,))
    for T, M in ((10, 512), (30, 128)):
        b = max(smoke.bench_buckets(dev, T=T), key=lambda x: x.max_len)
        args = (b.positions[:TOPK_CHUNK], b.lengths[:TOPK_CHUNK],
                b.is_bleached[:TOPK_CHUNK], tb)

        def run():
            return topk_kernel.segment_topk(*args, max_nb_states=M,
                                            min_len=3)
        for _ in range(2):
            run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                run()
            torch.cuda.synchronize()
        events = prof.key_averages()
        total = sum(e.self_device_time_total for e in events) / REPS / 1e3
        print(f"T={b.max_len} M={M}, {args[0].shape[0]} tracks: device time "
              f"{total:.3f} ms per call; aten operators by device time "
              f"(their kernels' included, per call), then kernels by their "
              f"own:")
        ops = [e for e in events if e.key.startswith("aten::")]
        kernels = [e for e in events if e.self_device_time_total > 0]
        for rows, attr in ((ops, "device_time_total"),
                           (kernels, "self_device_time_total")):
            for e in sorted(rows, key=lambda e: -getattr(e, attr))[:ROWS]:
                print(f"  {getattr(e, attr) / REPS / 1e3:9.3f} ms "
                      f"{e.count // REPS:5d}x  {e.key[:100]}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
