"""The port's drivers with ``sharded``: ``predict_Bs`` / ``predict_batch``,
``len_hist`` / ``hist_batch`` (the top-K engine warns and runs unsharded),
``position_refinement``, ``pipeline.analyze`` and ``sample_posterior``,
on eight CPU shards against the JAX package's sharded drivers on its
8-device mesh (tests/test_sharded_postfit.py's tolerances), and on one
shard bit for bit against the port's unsharded drivers."""
import warnings

import numpy as np
import pytest
import torch

from extrack_tpu import histograms as jhist, params as jparams, \
    predict as jpredict, refine as jrefine
from extrack_tpu_torch import data as tdata, histograms as thist, \
    params as tparams, pipeline, predict as tpredict, refine as trefine, \
    sample as tsample
from extrack_tpu_torch.parallel import mesh as pmesh
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)

MESH8 = pmesh.make_mesh(devices=["cpu"] * 8)
TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def tracks():
    rng = np.random.default_rng(9)
    return {"5": np.cumsum(rng.normal(0, 0.05, (9, 5, 2)), axis=1),
            "7": np.cumsum(rng.normal(0, 0.05, (6, 7, 2)), axis=1)}


def _dicts_equal(a, b, **tol):
    assert set(a) == set(b)
    for k in a:
        if tol:
            np.testing.assert_allclose(a[k], b[k], **tol)
        else:
            np.testing.assert_array_equal(a[k], b[k])


def test_sharded_predict_Bs_matches_jax(tracks):
    kw = dict(nb_states=2, frame_len=5)
    want = jpredict.predict_Bs(tracks, 0.02,
                               jparams.generate_params(nb_states=2,
                                                       D_max=1.0),
                               sharded=True, **kw)
    p = tparams.generate_params(nb_states=2, D_max=1.0)
    got = tpredict.predict_Bs(tracks, 0.02, p, sharded=MESH8, device="cpu",
                              **kw)
    _dicts_equal(got, want, **TOL)
    one = tpredict.predict_Bs(tracks, 0.02, p, sharded=True, device="cpu",
                              **kw)
    _dicts_equal(one, tpredict.predict_Bs(tracks, 0.02, p, device="cpu",
                                          **kw))
    batch = tdata.from_dict(tracks, device="cpu")
    logl, preds = tpredict.predict_batch(batch, p, 0.02, 2, window=5,
                                         sharded=MESH8)
    logl1, preds1 = tpredict.predict_batch(batch, p, 0.02, 2, window=5)
    assert preds.shape == preds1.shape
    torch.testing.assert_close(logl, logl1, **TOL)
    torch.testing.assert_close(preds, preds1, **TOL)


def test_sharded_len_hist_matches_jax(tracks):
    p_j = jparams.generate_params(nb_states=2, D_max=1.0)
    p_t = tparams.generate_params(nb_states=2, D_max=1.0)
    want = jhist.len_hist(tracks, p_j, 0.02, nb_states=2, window=5,
                          sharded=True)
    got = thist.len_hist(tracks, p_t, 0.02, nb_states=2, window=5,
                         sharded=MESH8, device="cpu")
    np.testing.assert_allclose(got, want, **TOL)
    one = thist.len_hist(tracks, p_t, 0.02, nb_states=2, window=5,
                         sharded=True, device="cpu")
    assert np.array_equal(one, thist.len_hist(tracks, p_t, 0.02, nb_states=2,
                                              window=5, device="cpu"))


def test_sharded_hist_batch_chunks_and_substeps(tracks):
    """The chunk bound is per shard (gchunk = chunk x shards) and the
    sub-steps reach every shard (tests/test_sharded_postfit.py's
    regressions), against the JAX package's sharded hist_batch."""
    values = {"LocErr": 0.02, "D0": 0.0, "D1": 0.1, "F0": 0.4, "F1": 0.6,
              "p01": 0.1, "p10": 0.15, "pBL": 0.1}
    batch = tdata.from_dict(tracks, device="cpu")
    from extrack_tpu import data as jdata
    jb = jdata.from_dict(tracks)
    for kw in (dict(window=4, chunk=2), dict(window=3, nb_substeps=2)):
        kw.update(cell_dims=(0.8, None, None), nb_states=2)
        want = jhist.hist_batch(jb, values, 0.02, sharded=True,
                                engine="xla" if "chunk" in kw else "window",
                                **kw)
        got = thist.hist_batch(batch, values, 0.02, sharded=MESH8, **kw)
        one = thist.hist_batch(batch, values, 0.02, **kw)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(got, one, rtol=1e-10, atol=1e-12)


def test_sharded_topk_warns_and_runs_unsharded(tracks):
    values = {"LocErr": 0.02, "D0": 0.0, "D1": 0.1, "F0": 0.4, "F1": 0.6,
              "p01": 0.1, "p10": 0.15, "pBL": 0.1}
    batch = tdata.from_dict(tracks, device="cpu")
    kw = dict(cell_dims=(0.8, None, None), nb_states=2, max_nb_states=128)
    for engine in ("topk", "topk_pallas"):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            h = thist.hist_batch(batch, values, 0.02, engine=engine,
                                 sharded=MESH8, **kw)
        assert any("sharded" in str(x.message) for x in w)
        assert np.array_equal(h, thist.hist_batch(batch, values, 0.02,
                                                  engine=engine, **kw))
    with pytest.warns(RuntimeWarning, match="single device"):
        thist.len_hist(tracks, values, 0.02, engine="topk", sharded=True,
                       device="cpu", **kw)


def test_sharded_position_refinement_matches_jax(tracks):
    ds, Fs = np.array([0.02, 0.1]), np.array([0.5, 0.5])
    tr = np.array([[0.9, 0.1], [0.2, 0.8]])
    mus_j, sigs_j = jrefine.position_refinement(tracks, 0.02, ds, Fs, tr,
                                                frame_len=5, sharded=True)
    mus, sigs = trefine.position_refinement(tracks, 0.02, ds, Fs, tr,
                                            frame_len=5, sharded=MESH8,
                                            device="cpu")
    _dicts_equal(mus, mus_j, **TOL)
    _dicts_equal(sigs, sigs_j, **TOL)
    mus1, sigs1 = trefine.position_refinement(tracks, 0.02, ds, Fs, tr,
                                              frame_len=5, sharded=True,
                                              device="cpu")
    mus0, sigs0 = trefine.position_refinement(tracks, 0.02, ds, Fs, tr,
                                              frame_len=5, device="cpu")
    _dicts_equal(mus1, mus0)
    _dicts_equal(sigs1, sigs0)


def test_sharded_analyze(tracks):
    """pipeline.analyze(sharded=...): on one shard the unsharded analysis
    bit for bit; on eight the same fit and outputs within rounding."""
    kw = dict(nb_states=2, window=4, hist_window=4, refine_frame_len=4,
              cell_dims=(0.5,), fit_kwargs=dict(max_iter=15), device="cpu")
    base = pipeline.analyze(tracks, 0.02, **kw)
    one = pipeline.analyze(tracks, 0.02, sharded=True, **kw)
    assert one.fit.logl == base.fit.logl
    assert one.fit.n_evals == base.fit.n_evals
    _dicts_equal(one.preds, base.preds)
    assert np.array_equal(one.hist, base.hist)
    _dicts_equal(one.mus, base.mus)
    eight = pipeline.analyze(tracks, 0.02, sharded=MESH8, **kw)
    np.testing.assert_allclose(eight.fit.logl, base.fit.logl, rtol=1e-8)
    for name, p in base.fit.params.items():
        np.testing.assert_allclose(eight.fit.params[name].value, p.value,
                                   rtol=1e-5, atol=1e-9)
    _dicts_equal(eight.preds, base.preds, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(eight.hist, base.hist, rtol=1e-5, atol=1e-7)
    _dicts_equal(eight.mus, base.mus, rtol=1e-5, atol=1e-7)


def test_sharded_sample_posterior(tracks):
    """On one shard the samples equal the unsharded ones bit for bit; on
    eight shards the same chains within rounding."""
    kw = dict(nb_states=2, num_samples=4, num_warmup=2, num_chains=2,
              n_leapfrog=2, window=4, cell_dims=(0.5,), seed=5,
              max_buckets=1, device="cpu")
    base = tsample.sample_posterior(tracks, 0.02, **kw)
    one = tsample.sample_posterior(tracks, 0.02, sharded=True, **kw)
    assert set(one.samples) == set(base.samples)
    for k in base.samples:
        np.testing.assert_array_equal(one.samples[k], base.samples[k])
    assert (one.accept_rate, one.step_size) == (base.accept_rate,
                                                base.step_size)
    eight = tsample.sample_posterior(tracks, 0.02, sharded=MESH8, **kw)
    for k in base.samples:
        np.testing.assert_allclose(eight.samples[k], base.samples[k],
                                   rtol=1e-6, atol=1e-9)
