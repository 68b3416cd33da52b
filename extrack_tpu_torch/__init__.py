"""extrack-tpu-torch: the PyTorch / CUDA port of extrack-tpu.

Single-particle-tracking state inference on the ExTrack model: maximum
likelihood fitting of multi-state diffusion models on localization tracks,
with Fisher error bars, HMC posterior samples, per-frame state annotation,
state-duration histograms, position refinement and track simulation (on
the host, or on the card), with readers and exporters of track files, the
end-to-end ``pipeline.analyze``, automated fitting, a CLI
(``extrack-tpu-torch``), a Tk GUI, and data parallelism over tracks on
``torch.distributed`` (``parallel``: every driver's ``sharded``).  The likelihood, its gradient, its
Hessian-vector products, the posteriors, the histograms (window and
top-K) and the refinement are hand-written CUDA kernels for NVIDIA Hopper
(``ops/``);
plain PyTorch versions (``core.engine``, ``histograms``, ``refine``) serve
CPU tensors and check the kernels.  Imports neither JAX nor the JAX
package.
"""
from extrack_tpu_torch.version import __version__  # noqa: F401

_SUBMODULES = {
    "data": "extrack_tpu_torch.data",
    "fit": "extrack_tpu_torch.fit",
    "histograms": "extrack_tpu_torch.histograms",
    "params": "extrack_tpu_torch.params",
    "predict": "extrack_tpu_torch.predict",
    "refine": "extrack_tpu_torch.refine",
    "sample": "extrack_tpu_torch.sample",
    "simulate": "extrack_tpu_torch.simulate",
    "tracking": "extrack_tpu_torch.tracking",
    "pipeline": "extrack_tpu_torch.pipeline",
    "auto_fitting": "extrack_tpu_torch.auto_fitting",
    "visualization": "extrack_tpu_torch.visualization",   # matplotlib
    "gui": "extrack_tpu_torch.gui",                       # tkinter in Tk
    "cli": "extrack_tpu_torch.cli",
    "io": "extrack_tpu_torch.io",
    "readers": "extrack_tpu_torch.io.readers",
    "exporters": "extrack_tpu_torch.io.exporters",
    "observe": "extrack_tpu_torch.utils.observe",
    "parallel": "extrack_tpu_torch.parallel",
    "engine": "extrack_tpu_torch.core.engine",
    "gaussian": "extrack_tpu_torch.core.gaussian",
    "tables": "extrack_tpu_torch.core.tables",
    # the reference's module names (extrack/__init__.py:1-10)
    "refined_localization": "extrack_tpu_torch.refine",
    "simulate_tracks": "extrack_tpu_torch.simulate",
    "forward_kernel": "extrack_tpu_torch.ops.forward_kernel",
    "grad_kernel": "extrack_tpu_torch.ops.grad_kernel",
    "hvp_kernel": "extrack_tpu_torch.ops.hvp_kernel",
    "predict_kernel": "extrack_tpu_torch.ops.predict_kernel",
    "hist_kernel": "extrack_tpu_torch.ops.hist_kernel",
    "refine_kernel": "extrack_tpu_torch.ops.refine_kernel",
    "topk_kernel": "extrack_tpu_torch.ops.topk_kernel",
}


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib
        return importlib.import_module(_SUBMODULES[name])
    raise AttributeError(
        f"module 'extrack_tpu_torch' has no attribute {name!r}")
