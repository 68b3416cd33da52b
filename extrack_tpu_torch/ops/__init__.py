"""Hand-written CUDA kernels for Hopper and their host-side wrappers."""
