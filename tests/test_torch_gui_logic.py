"""The port's GUI logic (display-free) against the JAX package's: the
parameter editor's rows, the analysis option schemas and their seeding
and parsing are equal; the four runners on a headless ``Session``
(``device="cpu"``) write their files, and the fit and posteriors agree
with the JAX runners' (values rtol 1e-6, posteriors 1e-6)."""
import json
import os

import numpy as np
import pandas as pd
import pytest

from extrack_tpu import gui as jgui, params as jparams, simulate as jsim
from extrack_tpu.io import exporters as jexp
from extrack_tpu_torch import gui as tgui, params as tparams
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)

SESSION = dict(dt=0.02, min_len=4, max_len=9, nb_states=2, cell_dims=(0.5,),
               frame_len_fit=3, frame_len_label=4, nb_iters=1)


@pytest.fixture(scope="module")
def csv_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("gui")
    tracks, states, _ = jsim.sim_fov(
        nb_tracks=150, max_track_len=9, min_track_len=4, LocErr=0.02,
        Ds=(0.0, 0.08), TrMat=np.array([[0.9, 0.1], [0.1, 0.9]]), dt=0.02,
        pBL=0.05, cell_dims=(0.5, None, None), seed=13)
    p = str(d / "tracks.csv")
    jexp.save_extrack_2_CSV(p, tracks, {k: np.eye(2)[states[k]]
                                        for k in states}, 0.02)
    return p


@pytest.mark.parametrize("S", [2, 3])
def test_rows_and_options_match_jax(S, csv_path):
    kw = dict(nb_states=S, LocErr_type=1, D_max=1.0)
    trows = tgui.spec_rows(tparams.generate_params(**kw))
    jrows = jgui.spec_rows(jparams.generate_params(**kw))
    assert trows == [tuple(r) for r in jrows]
    edited = [(n, v * 1.1, mn, mx, not vy) for n, v, mn, mx, vy, _ in trows]
    tout = tgui.apply_rows(tparams.generate_params(**kw), edited)
    jout = jgui.apply_rows(jparams.generate_params(**kw), edited)
    assert tgui.spec_rows(tout) == [tuple(r) for r in jgui.spec_rows(jout)]
    assert tgui.ANALYSIS_OPTIONS == jgui.ANALYSIS_OPTIONS
    assert set(tgui.ANALYSIS_OPTIONS) == set(tgui._ANALYSES)
    raw = {"nb_iters": "2", "frame_len": "5", "steady_state": "true",
           "first_method": "powell", "compute_errors": "0",
           "long_tracks": "on"}
    ts, js = (g.Session(path=csv_path, **dict(SESSION, nb_states=S))
              for g in (tgui, jgui))
    for analysis in tgui.ANALYSIS_OPTIONS:
        assert tgui.default_options(analysis) == jgui.default_options(
            analysis)
        assert tgui.parse_options(analysis, raw) == jgui.parse_options(
            analysis, raw)
        assert tgui.seeded_options(analysis, ts) == jgui.seeded_options(
            analysis, js)
    assert ts.load() == js.load()
    assert tgui.seeded_options("Position Refinement", ts) == \
        jgui.seeded_options("Position Refinement", js)
    assert tgui.spec_rows(ts.spec()) == [tuple(r)
                                         for r in jgui.spec_rows(js.spec())]


def test_state_labeling_seeded_options_at_3_states_fit_k4():
    """The State Labeling window seeds frame_len 10 (ExTrack_GUI.py:1207):
    3^10 = 59049 slots at 3 states, inside K4's envelope (65536); at 4
    states (4^10) the card raises, naming K4 and the largest frame_len
    that fits."""
    from extrack_tpu_torch.ops import forward_kernel
    ts, js = tgui.Session(nb_states=3), jgui.Session(nb_states=3)
    got = tgui.seeded_options("State Labeling", ts)
    assert got == jgui.seeded_options("State Labeling", js)
    W = int(got["frame_len"])
    assert 3 ** W == 59049
    forward_kernel.check_envelope(int(ts.max_len), 2, 3, W, 1,
                                  what="the GUI's labeling", kernel="K4")
    with pytest.raises(NotImplementedError,
                       match="the GUI's labeling.*K4 maps at most 65536.*"
                             "window that fits is 8"):
        forward_kernel.check_envelope(int(ts.max_len), 2, 4, W, 1,
                                      what="the GUI's labeling",
                                      kernel="K4")


def test_session_runs_the_four_analyses(csv_path, tmp_path):
    tdir, jdir = tmp_path / "t", tmp_path / "j"
    tdir.mkdir()
    jdir.mkdir()
    ts = tgui.Session(path=csv_path, output_dir=str(tdir), device="cpu",
                      **SESSION)
    js = jgui.Session(path=csv_path, output_dir=str(jdir), **SESSION)
    assert ts.load() == js.load() > 50
    msgs = []
    got = tgui.run_fitting(ts, progress=msgs.append)
    # the JAX fit without its error bars (a Hessian compile): the same
    # evaluations
    want = jgui.run_fitting(js, progress=lambda *_: None,
                            options={"compute_errors": False})
    assert got.std_errors and want.std_errors is None
    assert got.n_evals == want.n_evals
    for k, v in want.params.valuesdict().items():
        np.testing.assert_allclose(ts.params_values[k], v, rtol=1e-6,
                                   atol=1e-9)
    saved = json.loads((tdir / "extrack_fitted_params.json").read_text())
    assert set(saved) == {"values", "std_errors", "logL"}
    preds = tgui.run_predictions(ts, progress=msgs.append)
    jpreds = jgui.run_predictions(js, progress=lambda *_: None)
    for k in jpreds:
        np.testing.assert_allclose(preds[k], np.asarray(jpreds[k]),
                                   rtol=1e-6, atol=1e-8)
    hists = tgui.run_lifetime(ts, progress=msgs.append,
                              options={"frame_len": 5})
    assert hists.shape[1] == 2 and np.isfinite(hists).all()
    tgui.run_refinement(ts, progress=msgs.append, options={"frame_len": 4})
    for name in ("extrack_predictions.csv", "extrack_durations.csv",
                 "extrack_durations.png", "extrack_refined.csv"):
        assert os.path.getsize(tdir / name) > 0
    refined = pd.read_csv(tdir / "extrack_refined.csv")
    assert len(refined) == sum(int(k) * len(v) for k, v in ts.tracks.items())
    assert len(msgs) >= 5
    # a params JSON seeds a new session's spec (values, fixed)
    s2 = tgui.Session(path=csv_path, params_values=saved["values"],
                      **SESSION)
    s2.load()
    assert s2.spec()["D1"].value == pytest.approx(ts.params_values["D1"])


def test_session_device_defaults_to_the_card(csv_path, tmp_path):
    s = tgui.Session(path=csv_path, output_dir=str(tmp_path), **SESSION)
    s.load()
    assert s.device is None
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            tgui.run_predictions(s, progress=lambda *_: None)
