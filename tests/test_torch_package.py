"""The port stands alone: importing it pulls in neither JAX nor the JAX
package, and its public entry points resolve."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import extrack_tpu_torch as e\n"
        "from extrack_tpu_torch import (data, fit, histograms, params, "
        "predict, refine, simulate)\n"
        "from extrack_tpu_torch.core import engine, tables\n"
        "from extrack_tpu_torch.ops import (cuda_lib, forward_kernel, "
        "grad_kernel, hist_kernel, hvp_kernel, predict_kernel, "
        "refine_kernel, topk_kernel)\n"
        "assert e.fit is fit and e.grad_kernel is grad_kernel\n"
        "assert e.predict is predict and e.hvp_kernel is hvp_kernel\n"
        "assert e.predict_kernel is predict_kernel\n"
        "assert e.histograms is histograms and e.refine is refine\n"
        "assert e.hist_kernel is hist_kernel\n"
        "assert e.refine_kernel is refine_kernel\n"
        "assert e.topk_kernel is topk_kernel\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'extrack_tpu' or m.startswith('extrack_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_kernel_sources_present():
    from extrack_tpu_torch.ops import cuda_lib
    names = sorted(p.name for p in cuda_lib.CSRC.glob("*.cu*"))
    assert names == ["common.cuh", "dual.cuh", "forward.cu", "grad.cu",
                     "grad.cuh", "hist.cu", "hvp.cu", "predict.cu",
                     "refine.cu", "topk.cu"]
    # every C entry point the wrappers call has a ctypes signature
    assert set(cuda_lib._SIGNATURES) == {
        "extrack_forward", "extrack_grad", "extrack_hvp", "extrack_predict",
        "extrack_hist", "extrack_refine", "extrack_topk",
        "extrack_grad_occupancy", "extrack_hvp_occupancy"}
    assert "sm_90a" in " ".join(cuda_lib.NVCC_FLAGS)
    assert cuda_lib.library_path().parent == cuda_lib.BUILD_DIR
