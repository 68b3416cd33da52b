"""The port stands alone: importing it pulls in neither JAX nor the JAX
package (nor tkinter, which only the GUI's windows import), no source
file of it names either in an import, and its public entry points
resolve."""
import subprocess
import sys
from pathlib import Path
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)

ROOT = Path(__file__).resolve().parent.parent


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import extrack_tpu_torch as e\n"
        "from extrack_tpu_torch import (data, fit, histograms, params, "
        "predict, refine, sample, simulate, tracking)\n"
        "from extrack_tpu_torch.core import engine, gaussian, tables\n"
        "from extrack_tpu_torch import (auto_fitting, cli, gui, io, "
        "pipeline, visualization)\n"
        "from extrack_tpu_torch.io import exporters, native, readers\n"
        "from extrack_tpu_torch.utils import observe\n"
        "from extrack_tpu_torch.parallel import mesh, multihost\n"
        "from extrack_tpu_torch import baselines\n"
        "assert e.parallel.mesh is mesh\n"
        "assert e.pipeline is pipeline and e.auto_fitting is auto_fitting\n"
        "assert e.cli is cli and e.gui is gui and e.io is io\n"
        "assert e.visualization is visualization and e.observe is observe\n"
        "assert e.readers is readers and e.exporters is exporters\n"
        "assert 'tkinter' not in sys.modules\n"
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
        "assert e.tracking is tracking and e.gaussian is gaussian\n"
        "assert e.refined_localization is refine\n"
        "assert e.simulate_tracks is simulate and e.sample is sample\n"
        "assert simulate.sim_noBias is simulate.sim_nobias\n"
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
                     "grad.cuh", "hist.cu", "hist.cuh", "hist_block.cuh",
                     "hist_vdt.cu", "hist_wide.cu", "hvp.cu", "predict.cu",
                     "refine.cu", "topk.cu", "walk.cuh"]
    # every C entry point the wrappers call has a ctypes signature
    assert set(cuda_lib._SIGNATURES) == {
        "extrack_forward", "extrack_grad", "extrack_hvp", "extrack_predict",
        "extrack_hist", "extrack_refine", "extrack_refine_wide",
        "extrack_topk",
        "extrack_topk_wide", "extrack_forward_occupancy", "extrack_grad_occupancy",
        "extrack_hvp_occupancy", "extrack_predict_occupancy",
        "extrack_predict_layout", "extrack_hist_layout",
        "extrack_refine_layout", "extrack_grad_layout",
        "extrack_forward_layout", "extrack_grad_cluster_occupancy",
        "extrack_hvp_cluster_occupancy"}
    assert "sm_90a" in " ".join(cuda_lib.NVCC_FLAGS)
    assert cuda_lib.library_path().parent == cuda_lib.BUILD_DIR


def test_no_source_imports_jax():
    """Every module of the package and chip_smoke.py, scanned for an
    import of ``jax`` or of ``extrack_tpu`` (the JAX package), at any
    depth of the code (functions import lazily)."""
    import ast
    bad = []
    files = sorted((ROOT / "extrack_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 30
    assert ROOT / "extrack_tpu_torch" / "baselines.py" in files
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if n.split(".")[0] in ("jax",
                                                          "extrack_tpu")]
    assert not bad, bad
