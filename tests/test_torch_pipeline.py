"""The port's ``pipeline.analyze`` against the JAX package's, and against
the port's own drivers, on tests/test_pipeline.py's 60 tracks (float64 on
the CPU).

The fit takes the same evaluations and lands on the same values at rtol
1e-6; posteriors, histogram and refinement agree within 1e-8.  On the
card (``device`` left at its default) the same call runs K2, K4, K5 and
K6: tests/test_torch_cuda.py and ``chip_smoke.py`` phase 14 hold it there.
"""
import numpy as np
import pandas as pd
import pytest
import torch

from extrack_tpu import pipeline as jpipe, refine as jrefine, simulate as jsim
from extrack_tpu.io import exporters as jexp
from extrack_tpu_torch import histograms, pipeline, predict, refine
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)

TOL = dict(rtol=1e-8, atol=1e-10)
KW = dict(dt=0.02, nb_states=2, cell_dims=(0.5, None, None), window=5,
          hist_window=5, refine_frame_len=5, verbose=0)


@pytest.fixture(scope="module")
def tracks():
    tracks, _, _ = jsim.sim_fov(
        nb_tracks=60, max_track_len=9, min_track_len=4, LocErr=0.02,
        Ds=(0.0, 0.08), TrMat=np.array([[0.9, .1], [.15, .85]]), dt=0.02,
        pBL=0.05, cell_dims=(0.5, None, None), seed=3)
    return tracks


@pytest.fixture(scope="module")
def results(tracks, tmp_path_factory):
    d = tmp_path_factory.mktemp("analyze")
    got = pipeline.analyze(tracks, export_csv=str(d / "t.csv"),
                           export_xml=str(d / "t.xml"), device="cpu", **KW)
    want = jpipe.analyze(tracks, export_csv=str(d / "j.csv"), **KW)
    return got, want, d


def _dicts_close(a, b):
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_allclose(a[k], np.asarray(b[k]), **TOL)


def test_analyze_matches_jax(results):
    got, want, d = results
    assert (got.fit.n_evals, got.fit.message) == (want.fit.n_evals,
                                                  want.fit.message)
    assert list(got.fit.params) == list(want.fit.params)
    for k, p in want.fit.params.items():
        np.testing.assert_allclose(got.fit.params[k].value, float(p.value),
                                   rtol=1e-6, atol=1e-9)
    _dicts_close(got.preds, want.preds)
    # JAX pads its buckets to canonical lengths (canonical_shapes, not
    # ported): its histogram's rows past the longest track are zeros
    T = got.hist.shape[0]
    assert T == max(int(k) for k in got.preds)
    np.testing.assert_allclose(got.hist, want.hist[:T], **TOL)
    assert not np.asarray(want.hist)[T:].any()
    _dicts_close(got.mus, want.mus)
    _dicts_close(got.sigmas, want.sigmas)
    csv_t, csv_j = pd.read_csv(d / "t.csv"), pd.read_csv(d / "j.csv")
    assert list(csv_t.columns) == list(csv_j.columns)
    np.testing.assert_allclose(csv_t.to_numpy(np.float64),
                               csv_j.to_numpy(np.float64), **TOL)


def test_analyze_matches_the_drivers(results, tracks):
    """analyze's stages equal the dict drivers at the fitted values."""
    got, _, d = results
    values = got.fit.params.resolve()
    cpu = dict(device="cpu")
    _dicts_close(got.preds, predict.predict_Bs(
        tracks, 0.02, values, nb_states=2, cell_dims=(0.5, None, None),
        frame_len=5, **cpu))
    h = histograms.len_hist(tracks, values, 0.02, nb_states=2,
                            cell_dims=(0.5, None, None), window=5, **cpu)
    np.testing.assert_allclose(got.hist[:h.shape[0]], h, **TOL)
    loc_err, ds, Fs, tr = refine.refinement_args(values, 2, 0.02)
    mus, sigmas = refine.position_refinement(tracks, loc_err, ds, Fs, tr,
                                             frame_len=5, **cpu)
    _dicts_close(got.mus, mus)
    _dicts_close(got.sigmas, sigmas)
    assert list(got.timings) == ["batch", "fit", "predict", "hist",
                                 "refine", "export"]
    assert all(t >= 0 for t in got.timings.values())
    n_locs = sum(int(k) * len(v) for k, v in tracks.items())
    assert sum(1 for _ in open(d / "t.csv")) - 1 == n_locs
    from extrack_tpu_torch.io import readers
    back, _, _ = readers.read_trackmate_xml(str(d / "t.xml"),
                                            lengths=range(4, 10),
                                            dist_th=np.inf,
                                            remove_no_disp=False)
    assert sum(len(v) for v in back.values()) == sum(
        len(v) for v in tracks.values())


def test_analyze_csv_path_and_default_windows(tracks, tmp_path):
    """From a CSV path at the fit's default window, two iterations, no
    histogram or refinement: the same as ``analyze`` on the reader's dict
    (held to JAX's above), with the reader's frames; the refinement's
    default window is JAX's ``pallas_window`` at D = 2."""
    from extrack_tpu_torch.io import readers
    path = str(tmp_path / "in.csv")
    jexp.save_extrack_2_CSV(path, tracks, {k: np.full(v.shape[:2] + (2,),
                                                      0.5)
                                           for k, v in tracks.items()}, 0.02)
    kw = dict(dt=0.02, nb_states=2, do_hist=False, do_refine=False,
              fit_kwargs={"max_iter": 2}, device="cpu")
    got = pipeline.analyze(path, lengths=list(range(4, 10)), **kw)
    read, frames, _ = readers.read_table(path, lengths=list(range(4, 10)))
    want = pipeline.analyze(read, **kw)
    assert got.hist is None and got.mus is None
    assert list(got.timings) == ["read", "batch", "fit", "predict"]
    assert got.fit.n_evals == want.fit.n_evals
    assert set(got.preds) == set(got.tracks) == set(tracks)
    _dicts_close(got.frames, frames)
    _dicts_close(got.preds, want.preds)
    # the refinement's default window: JAX's pallas_window at D = 2
    for S, T in ((2, 9), (3, 9), (3, 20), (4, 12), (5, 30)):
        assert refine.default_window(S, T) == jrefine.pallas_window(S, T)


def test_analyze_refuses(tracks):
    # sharded=True on the CPU: one shard, the unsharded analysis bit for bit
    kw = dict(window=3, hist_window=3, refine_frame_len=3,
              fit_kwargs=dict(max_iter=3), device="cpu")
    want = pipeline.analyze(tracks, 0.02, **kw)
    got = pipeline.analyze(tracks, 0.02, sharded=True, **kw)
    assert (got.fit.logl, got.fit.n_evals) == (want.fit.logl,
                                               want.fit.n_evals)
    assert np.array_equal(got.hist, want.hist)
    for k in want.preds:
        assert np.array_equal(got.preds[k], want.preds[k])
        assert np.array_equal(got.mus[k], want.mus[k])
    with pytest.raises(ValueError, match="do_predict"):
        pipeline.analyze(tracks, 0.02, do_predict=False, export_csv="x.csv",
                         device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            pipeline.analyze(tracks, 0.02)
