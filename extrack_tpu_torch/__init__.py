"""extrack-tpu-torch: the PyTorch / CUDA port of extrack-tpu.

Single-particle-tracking state inference on the ExTrack model: maximum
likelihood fitting of multi-state diffusion models on localization tracks,
with Fisher error bars, and per-frame state annotation.  The likelihood,
its gradient, its Hessian-vector products and the posteriors are
hand-written CUDA kernels for NVIDIA Hopper (``ops/``); a plain PyTorch
engine (``core.engine``) serves CPU tensors and checks the kernels.  Imports neither JAX nor the
JAX package.
"""
from extrack_tpu_torch.version import __version__  # noqa: F401

_SUBMODULES = {
    "data": "extrack_tpu_torch.data",
    "fit": "extrack_tpu_torch.fit",
    "params": "extrack_tpu_torch.params",
    "predict": "extrack_tpu_torch.predict",
    "simulate": "extrack_tpu_torch.simulate",
    "engine": "extrack_tpu_torch.core.engine",
    "tables": "extrack_tpu_torch.core.tables",
    "forward_kernel": "extrack_tpu_torch.ops.forward_kernel",
    "grad_kernel": "extrack_tpu_torch.ops.grad_kernel",
    "hvp_kernel": "extrack_tpu_torch.ops.hvp_kernel",
    "predict_kernel": "extrack_tpu_torch.ops.predict_kernel",
}


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib
        return importlib.import_module(_SUBMODULES[name])
    raise AttributeError(
        f"module 'extrack_tpu_torch' has no attribute {name!r}")
