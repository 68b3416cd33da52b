"""One intra-op thread for the port's CPU tests.

PyTorch starts one intra-op thread per core in every process.  The tier-1
run puts several pytest-xdist workers on the same cores, and the port's
CPU tests run the plain engine on small tensors, where those threads only
contend: a sampler run took 32 s on one thread and 362 s on eight beside
another busy worker.  Every ``tests/test_torch_*.py`` imports this module
for its effect, so a worker's torch work runs on one thread whatever file
it starts with.
"""
import torch

torch.set_num_threads(1)
