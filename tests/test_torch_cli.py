"""The port's CLI (``python -m extrack_tpu_torch.cli``), one subprocess
per subcommand with ``--device cpu`` on a few hundred simulated tracks,
its outputs held to the JAX package's drivers on the same file (float64
on the CPU): the fit's values at rtol 1e-6, the posteriors, histogram
and refined positions at 1e-8.  Also: ``--device cuda`` raises where
there is no card, and the two warnings that replace silent behaviours of
the JAX CLI (a loaded value outside its bounds; the warm-start fit before
sampling)."""
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pandas as pd
import pytest
import torch

from extrack_tpu import fit as jfit, histograms as jhist, predict as jpred
from extrack_tpu import refine as jrefine, simulate as jsim
from extrack_tpu.core import tables as jtables
from extrack_tpu.io import exporters as jexp, readers as jread
from extrack_tpu_torch import cli, params as tparams
from extrack_tpu_torch.io import exporters as texp
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-8, atol=1e-10)
IO = ["--dt", "0.02", "--min-len", "3", "--max-len", "8", "--cell-dims",
      "0.5"]


def _run(args, cwd, device="cpu"):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    pre = ["--device", device] if device else []
    return subprocess.run(
        [sys.executable, "-m", "extrack_tpu_torch.cli"] + pre + args,
        capture_output=True, text=True, env=env, cwd=cwd, timeout=600)


def _ok(proc):
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """A simulated CSV (the ``simulate`` subcommand's), its tracks as the
    JAX reader gives them, and a fixed params JSON."""
    d = tmp_path_factory.mktemp("cli")
    sim = _ok(_run(["simulate", "--n-tracks", "200", "--max-len", "8",
                    "--min-len", "3", "--Ds", "0.0", "0.08", "--seed", "1",
                    "-o", str(d / "sim.csv")], str(d), device=None))
    tracks, frames, _ = jread.read_table(str(d / "sim.csv"),
                                         lengths=np.arange(3, 9))
    spec = tparams.generate_params(nb_states=2, estimated_Ds=[0.0, 0.08],
                                   estimated_LocErr=0.02)
    texp.save_params(spec, str(d), file_name="params")
    return d, tracks, frames, spec.resolve(), sim


def test_cli_simulate(work):
    d, tracks, _, _, sim = work
    want, _, _ = jsim.sim_fov(nb_tracks=200, max_track_len=8,
                              min_track_len=3, LocErr=0.02, Ds=[0.0, 0.08],
                              TrMat=np.array([[0.9, 0.1], [0.1, 0.9]]),
                              dt=0.02, pBL=0.1, cell_dims=(0.5, None, None),
                              seed=1)
    assert "wrote" in sim.stdout
    assert {k: len(v) for k, v in tracks.items()} == {
        k: len(v) for k, v in want.items() if len(v)}
    for k in tracks:
        np.testing.assert_allclose(tracks[k], want[k], rtol=1e-12)


def test_cli_fit(work):
    d = work[0]
    _ok(_run(["fit", str(d / "sim.csv"), *IO, "--window", "3", "-o",
              str(d / "fit.json")], str(d)))
    got = json.loads((d / "fit.json").read_text())
    tracks = work[1]
    want = jfit.param_fitting(tracks, 0.02, nb_states=2, frame_len=3,
                              cell_dims=(0.5,), verbose=0)
    assert got["success"] == want.success
    for k, v in want.params.valuesdict().items():
        np.testing.assert_allclose(got["values"][k], v, rtol=1e-6,
                                   atol=1e-9)
    assert set(got["std_errors"]) == set(want.params.free_names())
    assert all(np.isfinite(v) for v in got["std_errors"].values())


def test_cli_predict(work):
    d, tracks, _, values, _ = work
    _ok(_run(["predict", str(d / "sim.csv"), *IO, "--window", "4",
              "--params", str(d / "params.json"), "-o",
              str(d / "pred.csv")], str(d)))
    got = pd.read_csv(d / "pred.csv")
    preds = jpred.predict_Bs(tracks, 0.02, values, cell_dims=(0.5,),
                             nb_states=2, frame_len=4)
    jexp.save_extrack_2_CSV(str(d / "jpred.csv"), tracks, preds, 0.02,
                            all_frames=work[2])
    want = pd.read_csv(d / "jpred.csv")
    assert list(got.columns) == list(want.columns)
    np.testing.assert_allclose(got.to_numpy(np.float64),
                               want.to_numpy(np.float64), **TOL)


def test_cli_histogram(work):
    d, tracks, _, values, _ = work
    _ok(_run(["histogram", str(d / "sim.csv"), *IO, "--window", "4",
              "--params", str(d / "params.json"), "--plot", "-o",
              str(d / "hist.csv")], str(d)))
    got = np.loadtxt(d / "hist.csv", delimiter=",")
    want = jhist.len_hist(tracks, values, 0.02, cell_dims=(0.5,),
                          nb_states=2, window=4)
    np.testing.assert_allclose(got, want, **TOL)
    assert (d / "hist.png").stat().st_size > 0


def test_cli_refine(work):
    d, tracks, frames, values, _ = work
    _ok(_run(["refine", str(d / "sim.csv"), *IO, "--window", "4",
              "--params", str(d / "params.json"), "-o",
              str(d / "ref.csv")], str(d)))
    got = pd.read_csv(d / "ref.csv")
    from extrack_tpu import params as jparams
    Ds, _, rates, loc_err, _ = jparams.extract_arrays(values, 2)
    mus, sigmas = jrefine.position_refinement(
        tracks, float(np.asarray(loc_err).ravel()[0]),
        np.sqrt(2.0 * np.asarray(Ds) * 0.02), None,
        np.asarray(jtables.transition_matrix(rates)), frame_len=4)
    order = list(tracks)
    np.testing.assert_allclose(
        got[["X_REFINED", "Y_REFINED"]].to_numpy(),
        np.concatenate([mus[k].reshape(-1, 2) for k in order]), **TOL)
    np.testing.assert_allclose(
        got["SIGMA"], np.concatenate([sigmas[k].ravel() for k in order]),
        **TOL)
    np.testing.assert_array_equal(
        got["FRAME"], np.concatenate([frames[k].ravel() for k in order]))


def test_cli_sample_warns_of_its_fit_and_of_clamped_values(work):
    """``sample`` warns before its warm-start fit, and ``--params`` values
    outside the free parameters' bounds warn that they start at the
    bound (D1_minus_D0 = 5 past D_max = 3)."""
    d = work[0]
    texp.save_params({**work[3], "D1_minus_D0": 5.0}, str(d),
                     file_name="outside")
    out = _ok(_run(["sample", str(d / "sim.csv"), *IO, "--window", "3",
                    "--samples", "4", "--warmup", "4", "--chains", "2",
                    "--n-leapfrog", "2", "--params",
                    str(d / "outside.json"), "-o", str(d / "post.npz")],
                   str(d)))
    assert "running a full fit with error bars first" in out.stderr
    assert "D1_minus_D0=5 [0, 3] lie outside their bounds" in out.stderr
    post = np.load(d / "post.npz")
    assert post["D1_minus_D0"].shape == (2, 4)
    assert np.isfinite(post["D1_minus_D0"]).all()
    # --no-precondition skips the fit and its warning (in process)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        cli.main(["--device", "cpu", "sample", str(d / "sim.csv"), *IO,
                  "--window", "3", "--samples", "2", "--warmup", "2",
                  "--n-leapfrog", "1", "--no-precondition", "-o",
                  str(d / "p2.npz")])
    assert not [w for w in seen if "running a full fit" in str(w.message)]
    assert np.load(d / "p2.npz")["D1_minus_D0"].shape == (2, 2)


def test_cli_warmup_and_device(work):
    d = work[0]
    out = _ok(_run(["warmup", "--n-tracks", "60", "--max-len", "5",
                    "--window", "3"], str(d)))
    assert "warmup done" in out.stdout and "device: cpu" in out.stdout
    if not torch.cuda.is_available():
        # the card is the default, and the flag is taken before or after
        # the subcommand (in process)
        for argv in (["warmup"], ["--device", "cuda", "fit",
                                  str(d / "sim.csv"), "--dt", "0.02"],
                     ["fit", str(d / "sim.csv"), "--dt", "0.02",
                      "--device", "cuda"]):
            with pytest.raises(RuntimeError, match="needs a CUDA device"):
                cli.main(argv)
    with pytest.raises(FileNotFoundError):
        cli.main(["--device", "cpu", "fit", str(d / "missing.csv"), "--dt",
                  "0.02"])


def test_cli_sharded_fit_in_a_torchrun_group(work):
    """``--sharded`` under torchrun's environment variables: two processes
    join one gloo group on the CPU, each fits its part of every bucket
    with one all-reduce an evaluation, both print the same fit and only
    rank 0 writes ``-o``; the values are the JAX package's fit of the
    file within 1e-5."""
    import socket
    d = work[0]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, OMP_NUM_THREADS="1", WORLD_SIZE="2",
               MASTER_ADDR="localhost", MASTER_PORT=port,
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    outs = [str(d / f"sharded{r}.json") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "extrack_tpu_torch.cli", "--device", "cpu",
         "fit", str(d / "sim.csv"), *IO, "--window", "3", "--sharded", "-o",
         outs[r]], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=str(d), env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
        for r in range(2)]
    try:
        res = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, res):
        assert p.returncode == 0, err[-3000:]
    fit_lines = [[ln for ln in out.splitlines() if ln.startswith(
        ("FitResult", "  "))] for out, _ in res]
    assert fit_lines[0] and fit_lines[0] == fit_lines[1]
    assert os.path.exists(outs[0]) and not os.path.exists(outs[1])
    got = json.loads(open(outs[0]).read())
    want = jfit.param_fitting(work[1], 0.02, nb_states=2, frame_len=3,
                              cell_dims=(0.5,), verbose=0)
    for k, v in want.params.valuesdict().items():
        np.testing.assert_allclose(got["values"][k], v, rtol=1e-5,
                                   atol=1e-9)
