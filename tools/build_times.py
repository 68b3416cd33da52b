#!/usr/bin/env python3
"""Wall seconds of each kernel source's nvcc when all are started together,
as ``cuda_lib.build`` starts them, to find the build's critical path.

    python3 tools/build_times.py

Compiles ``extrack_tpu_torch/csrc/*.cu`` with ``cuda_lib.NVCC_FLAGS`` into
a temporary directory (the library in ``_build/`` is left alone), prints
each source's finishing time in order, the children's CPU seconds, and
the card's name and power limit.  Needs nvcc (the GPU machine).
"""
from __future__ import annotations

import resource
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    from extrack_tpu_torch.ops import cuda_lib
    nvcc = cuda_lib.find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        procs = {src.stem: subprocess.Popen(
            [nvcc, *cuda_lib.NVCC_FLAGS, "-c", "-o",
             str(Path(tmp) / f"{src.stem}.o"), str(src)],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            for src in sorted(cuda_lib.CSRC.glob("*.cu"))}
        done = {}
        while len(done) < len(procs):
            for name, p in procs.items():
                if name not in done and p.poll() is not None:
                    done[name] = (time.time() - t0, p.returncode)
            time.sleep(0.2)
    for name, (t, rc) in sorted(done.items(), key=lambda x: x[1][0]):
        print(f"{name}.cu: {t:.1f} s (rc {rc})")
    cpu = resource.getrusage(resource.RUSAGE_CHILDREN).ru_utime
    print(f"nvcc CPU seconds, all sources: {cpu:.1f}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip())
    return 0 if all(rc == 0 for _, rc in done.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
