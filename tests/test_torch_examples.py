"""The port's examples and tutorial notebook run end to end on the CPU:
``examples/torch_tutorial.py``, ``torch_fitting_methods.py`` and
``torch_automated_fitting.py`` with ``--small --device cpu`` (in this
process, as ``python script.py`` would run them), and
``notebooks/Tutorial_ExTrack_TPU_torch.ipynb``'s code cells in order in
one namespace, shrunk as tests/test_notebook.py shrinks the JAX package's
tutorial.  None of them imports JAX."""
import os
import runpy
import sys
import warnings

import matplotlib

matplotlib.use("Agg")

import pytest  # noqa: E402

import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
EXAMPLES = ["torch_tutorial.py", "torch_fitting_methods.py",
            "torch_automated_fitting.py"]


def _jax_imports(before):
    return sorted(m for m in set(sys.modules) - before
                  if m == "jax" or m.startswith("jax.")
                  or m == "extrack_tpu" or m.startswith("extrack_tpu."))


@pytest.mark.parametrize("script", EXAMPLES)
def test_example_runs_small_on_the_cpu(script, tmp_path, monkeypatch,
                                       capsys):
    path = os.path.join(ROOT, "examples", script)
    argv = [path, "--small", "--device", "cpu"]
    if script != "torch_fitting_methods.py":
        argv += ["--outdir", str(tmp_path)]
    monkeypatch.setattr(sys, "argv", argv)
    monkeypatch.setattr(sys, "path", list(sys.path))
    before = set(sys.modules)
    runpy.run_path(path, run_name="__main__")
    out = capsys.readouterr().out
    assert not _jax_imports(before)
    if script == "torch_tutorial.py":
        assert "state labeling accuracy" in out and "model selection" in out
        assert {"annotated.csv", "annotated.xml"} <= set(os.listdir(tmp_path))
    elif script == "torch_fitting_methods.py":
        assert out.count("logL=") == 7
    else:
        assert "Exp0:" in out and "Exp1:" in out
        assert os.path.exists(tmp_path / "summary.json")


NB_PATH = os.path.join(ROOT, "notebooks", "Tutorial_ExTrack_TPU_torch.ipynb")
# keep the tutorial fast on the f64 CPU rig: fewer tracks, same pipeline
SHRINK = [
    ("nb_tracks=2000", "nb_tracks=300"),
    ("max_track_len=12", "max_track_len=10"),
]


def test_tutorial_notebook_runs(tmp_path, monkeypatch):
    nbformat = pytest.importorskip("nbformat")
    monkeypatch.chdir(tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        nb = nbformat.read(NB_PATH, as_version=4)
    ns = {"__name__": "__tutorial__"}
    before = set(sys.modules)
    for idx, cell in enumerate(nb.cells):
        if cell.cell_type != "code":
            continue
        src = cell.source
        for old, new in SHRINK:
            src = src.replace(old, new)
        try:
            exec(compile(src, f"<cell {idx}>", "exec"), ns)
        except Exception as exc:  # pragma: no cover - diagnostic
            pytest.fail(f"notebook cell {idx} failed: {exc!r}\n--- source:\n"
                        f"{src}")
        matplotlib.pyplot.close("all")
    assert not _jax_imports(before)
    assert ns["DEVICE"] == "cpu"
    # the fit cell must have recovered sane parameters
    fitted = ns["model_fit"].params.valuesdict()
    assert 0.15 < fitted["D1"] < 0.4
    assert fitted["D0"] < 0.05
    # the annotation cell computed an agreement fraction
    assert ns["agree"] / ns["n_tot"] > 0.75
