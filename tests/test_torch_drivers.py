"""The port's drivers take the JAX package's parameters, by the same names
in the same order, so that a positional call means the same in both; the
port's keyword-only extras (``device``, ``dtype``) follow them.  Also the
validation of the JAX package's ``compute_engine`` and ``sharded`` options
in the port."""
import inspect

import numpy as np
import pytest
import torch

from extrack_tpu import fit as jfit, histograms as jhist, \
    predict as jpredict, refine as jrefine
from extrack_tpu_torch import data as tdata, device as tdevice, \
    fit as tfit, histograms as thist, predict as tpredict, \
    refine as trefine

DRIVERS = [(jfit, tfit, "fit"), (jfit, tfit, "param_fitting"),
           (jrefine, trefine, "position_refinement"),
           (jrefine, trefine, "refine_batch"),
           (jrefine, trefine, "default_window"),
           (jpredict, tpredict, "predict_Bs"),
           (jpredict, tpredict, "predict_batch"),
           (jhist, thist, "len_hist"), (jhist, thist, "hist_batch")]


def _params(fn):
    return list(inspect.signature(fn).parameters.values())


@pytest.mark.parametrize("jmod,tmod,name", DRIVERS,
                         ids=[d[2] for d in DRIVERS])
def test_driver_signature_matches_jax(jmod, tmod, name):
    want = [(p.name, p.kind) for p in _params(getattr(jmod, name))]
    got = [(p.name, p.kind) for p in _params(getattr(tmod, name))
           if p.kind != p.KEYWORD_ONLY]
    assert got == want
    extra = {p.name for p in _params(getattr(tmod, name))
             if p.kind == p.KEYWORD_ONLY}
    assert extra <= {"device", "dtype"}


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
    mu, sig = trefine.refine_batch(batch, 0.02, ds, tr, 4)
    for engine in ("pallas", "xla"):
        mu2, sig2 = trefine.refine_batch(batch, 0.02, ds, tr, 4, engine)
        assert torch.equal(mu, mu2) and torch.equal(sig, sig2)
    with pytest.raises(ValueError, match="unknown compute_engine"):
        trefine.refine_batch(batch, 0.02, ds, tr, 4, "tpu")
    with pytest.raises(NotImplementedError, match=r"port \(ROADMAP Queue 1\)"):
        trefine.refine_batch(batch, 0.02, ds, tr, 4, "auto", True)


def test_fit_rejects_sharded_and_unknown_engines(tracks):
    from extrack_tpu_torch import params as tparams
    batch = tdata.from_dict(tracks, device="cpu")
    spec = tparams.generate_params(nb_states=2)
    with pytest.raises(NotImplementedError, match=r"port \(ROADMAP Queue 1\)"):
        tfit.fit(batch, spec, 0.02, 2, sharded=True)
    with pytest.raises(ValueError, match="unknown compute_engine"):
        tfit.fit(batch, spec, 0.02, 2, compute_engine="tpu")
    with pytest.raises(NotImplementedError, match=r"port \(ROADMAP Queue 1\)"):
        tfit.param_fitting(tracks, 0.02, nb_states=2, sharded=True,
                           device="cpu")
    with pytest.raises(ValueError, match="unknown compute_engine"):
        tpredict.predict_batch(batch, spec, 0.02, 2, compute_engine="tpu")
