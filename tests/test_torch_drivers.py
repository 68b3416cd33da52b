"""The port's drivers take the JAX package's parameters, by the same names
in the same order and of the same kinds, so that a call means the same in
both; the port's keyword-only extras (``device``, ``dtype``) follow them.
The batch drivers return what the JAX package's return: ``refine_batch``
(mu, sigma, B) and ``hist_batch`` the histogram, as numpy arrays.  Also
the validation of the JAX package's ``compute_engine`` option in the
port, and its ``sharded`` option giving the unsharded results (one CPU
shard bit for bit, three shards within rounding)."""
import inspect

import numpy as np
import pytest
import torch

from extrack_tpu import fit as jfit, histograms as jhist, \
    predict as jpredict, refine as jrefine, sample as jsample, \
    simulate as jsim
from extrack_tpu_torch import data as tdata, device as tdevice, \
    fit as tfit, histograms as thist, predict as tpredict, \
    refine as trefine, sample as tsample, simulate as tsim
from extrack_tpu_torch.parallel import mesh as pmesh
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)

DRIVERS = [(jfit, tfit, "fit"), (jfit, tfit, "param_fitting"),
           (jrefine, trefine, "position_refinement"),
           (jrefine, trefine, "refine_batch"),
           (jrefine, trefine, "default_window"),
           (jpredict, tpredict, "predict_Bs"),
           (jpredict, tpredict, "predict_batch"),
           (jhist, thist, "len_hist"), (jhist, thist, "hist_batch"),
           (jfit, tfit, "make_objective"), (jfit, tfit, "hessian_hvp_exact"),
           (jsample, tsample, "sample_posterior"),
           (jsim, tsim, "sim_fov_batch"), (jsim, tsim, "sim_nobias")]


def _params(fn):
    return list(inspect.signature(fn).parameters.values())


@pytest.mark.parametrize("jmod,tmod,name", DRIVERS,
                         ids=[d[2] for d in DRIVERS])
def test_driver_signature_matches_jax(jmod, tmod, name):
    want = [(p.name, p.kind) for p in _params(getattr(jmod, name))]
    extras = {"device", "dtype"}
    got = [(p.name, p.kind) for p in _params(getattr(tmod, name))
           if p.name not in extras]
    assert got == want
    extra = [p for p in _params(getattr(tmod, name)) if p.name in extras]
    assert all(p.kind == p.KEYWORD_ONLY for p in extra)


def test_compute_engine_validation():
    for engine in tdevice.COMPUTE_ENGINES:
        tdevice.check_compute_engine(engine, "cpu", "x")
    for engine in ("auto", "pallas"):
        tdevice.check_compute_engine(engine, "cuda", "x")
    with pytest.raises(NotImplementedError, match="no CUDA counterpart"):
        tdevice.check_compute_engine("xla", "cuda", "x")
    with pytest.raises(ValueError, match="unknown compute_engine"):
        tdevice.check_compute_engine("tpu", "cpu", "x")


@pytest.fixture(scope="module")
def tracks():
    rng = np.random.default_rng(3)
    return {str(L): rng.normal(0, 0.05, (n, L, 2)).cumsum(1)
            for L, n in ((3, 6), (5, 4), (7, 3))}


def test_refine_batch_engines_on_the_cpu(tracks):
    """On the CPU every compute_engine runs the plain version (the same
    numbers); a positional string lands in compute_engine, not sharded."""
    batch = tdata.from_dict(tracks, device="cpu")
    ds, tr = np.array([0.02, 0.1]), np.array([[0.9, 0.1], [0.2, 0.8]])
    mu, sig, _ = trefine.refine_batch(batch, 0.02, ds, tr, 4)
    for engine in ("pallas", "xla"):
        mu2, sig2, _ = trefine.refine_batch(batch, 0.02, ds, tr, 4, engine)
        assert np.array_equal(mu, mu2) and np.array_equal(sig, sig2)
    with pytest.raises(ValueError, match="unknown compute_engine"):
        trefine.refine_batch(batch, 0.02, ds, tr, 4, "tpu")
    # sharded: one CPU shard bit for bit, three shards within rounding
    mu1, sig1, n = trefine.refine_batch(batch, 0.02, ds, tr, 4, "auto", True)
    assert n == batch.batch_size
    assert np.array_equal(mu, mu1) and np.array_equal(sig, sig1)
    mu3, sig3, _ = trefine.refine_batch(batch, 0.02, ds, tr, 4, "auto",
                                        pmesh.make_mesh(devices=["cpu"] * 3))
    np.testing.assert_allclose(mu3, mu, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(sig3, sig, rtol=1e-12, atol=1e-14)


def test_batch_driver_returns_match_jax(tracks):
    """refine_batch and hist_batch return the JAX package's arity and
    types on the same batch: numpy arrays, and the track count an int."""
    from extrack_tpu import data as jdata, params as jparams
    from extrack_tpu_torch import params as tparams
    jb = jdata.from_dict(tracks)
    tb = tdata.from_dict(tracks, device="cpu")
    ds, tr = np.array([0.02, 0.1]), np.array([[0.9, 0.1], [0.2, 0.8]])
    want = jrefine.refine_batch(jb, 0.02, ds, tr, 4, "xla")
    got = trefine.refine_batch(tb, 0.02, ds, tr, 4)
    assert len(got) == len(want) == 3
    assert [type(v) for v in got] == [type(v) for v in want] == [
        np.ndarray, np.ndarray, int]
    assert got[2] == want[2] == tb.batch_size
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, np.asarray(w, np.float64), rtol=1e-7,
                                   atol=1e-9)
    hw = jhist.hist_batch(jb, jparams.generate_params(nb_states=2), 0.02,
                          cell_dims=(0.5,), window=4)
    hg = thist.hist_batch(tb, tparams.generate_params(nb_states=2), 0.02,
                          cell_dims=(0.5,), window=4)
    assert type(hg) is type(hw) is np.ndarray
    assert hg.shape == hw.shape
    np.testing.assert_allclose(hg, hw, rtol=1e-7, atol=1e-9)


def test_objective_and_hessian_reject_sharded_and_unknown_engines(tracks):
    from extrack_tpu_torch import params as tparams
    batch = tdata.from_dict(tracks, device="cpu")
    spec = tparams.generate_params(nb_states=2)
    with pytest.raises(ValueError, match="unknown compute_engine"):
        tfit.make_objective(batch, spec, 0.02, 2, compute_engine="tpu")
    # the TPU knobs are accepted and change nothing
    z = torch.tensor(spec.to_unconstrained())
    a = tfit.make_objective(batch, spec, 0.02, 2, window=4)(z)
    # sharded objectives: one CPU shard bit for bit, three within rounding
    assert torch.equal(tfit.make_objective(batch, spec, 0.02, 2, window=4,
                                           sharded=True)(z), a)
    mesh3 = pmesh.make_mesh(devices=["cpu"] * 3)
    torch.testing.assert_close(tfit.make_objective(
        batch, spec, 0.02, 2, window=4, sharded=mesh3)(z), a, rtol=1e-12,
        atol=0)
    b = tfit.make_objective(batch, spec, 0.02, 2, window=4, pallas_block=256,
                            compute_engine="xla")(z)
    assert torch.equal(a, b)
    kw = dict(cell_dims=(0.5,), window=3, min_len=3)
    H = tfit.hessian_hvp_exact([batch], spec, z.numpy(), 0.02, 2, **kw)
    H2 = tfit.hessian_hvp_exact([batch], spec, z.numpy(), 0.02, 2,
                                pallas_flags=[False], has_len2s=[True],
                                block=128, **kw)
    np.testing.assert_array_equal(H, H2)
    np.testing.assert_array_equal(tfit.hessian_hvp_exact(
        [batch], spec, z.numpy(), 0.02, 2, sharded=True, **kw), H)
    np.testing.assert_allclose(tfit.hessian_hvp_exact(
        [batch], spec, z.numpy(), 0.02, 2, sharded=mesh3, **kw), H,
        rtol=1e-10, atol=1e-8)


def test_fit_rejects_sharded_and_unknown_engines(tracks):
    from extrack_tpu_torch import params as tparams
    batch = tdata.from_dict(tracks, device="cpu")
    spec = tparams.generate_params(nb_states=2)
    # sharded fits on one CPU shard: the unsharded fits bit for bit
    kw = dict(window=4, max_iter=8)
    want = tfit.fit(batch, spec, 0.02, 2, **kw)
    got = tfit.fit(batch, spec, 0.02, 2, sharded=True, **kw)
    assert (got.logl, got.n_evals, got.history) == (
        want.logl, want.n_evals, want.history)
    with pytest.raises(ValueError, match="unknown compute_engine"):
        tfit.fit(batch, spec, 0.02, 2, compute_engine="tpu")
    kw = dict(nb_states=2, frame_len=4, max_iter=8, verbose=0, device="cpu")
    want = tfit.param_fitting(tracks, 0.02, **kw)
    got = tfit.param_fitting(tracks, 0.02, sharded=True, **kw)
    assert (got.logl, got.n_evals) == (want.logl, want.n_evals)
    assert got.params.valuesdict() == want.params.valuesdict()
    with pytest.raises(ValueError, match="unknown compute_engine"):
        tpredict.predict_batch(batch, spec, 0.02, 2, compute_engine="tpu")
