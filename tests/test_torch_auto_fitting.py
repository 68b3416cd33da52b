"""The port's automated fitting (extrack_tpu_torch/auto_fitting.py) against
the JAX package's, float64 on the CPU: the heuristics equal, and small
``auto_fit``, ``model_selection`` and ``fit_2states`` runs take the same
evaluations to the same values (rtol 1e-6) and likelihoods (1e-9)."""
import itertools

import numpy as np
import pytest
import torch

from extrack_tpu import auto_fitting as jauto
from extrack_tpu import simulate as jsim
from extrack_tpu_torch import auto_fitting as tauto, params as tparams
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)

CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def tracks():
    tracks, _, _ = jsim.sim_fov(
        nb_tracks=60, max_track_len=6, min_track_len=3, LocErr=0.02,
        Ds=(0.0, 0.08), TrMat=np.array([[0.9, 0.1], [0.1, 0.9]]), dt=0.02,
        pBL=0.05, cell_dims=(0.5, None, None), seed=21)
    return tracks


def _same_fit(got, want):
    assert (got.n_evals, got.message) == (want.n_evals, want.message)
    assert list(got.params) == list(want.params)
    for k, p in want.params.items():
        np.testing.assert_allclose(got.params[k].value, float(p.value),
                                   rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got.logl, want.logl, rtol=1e-9)


@pytest.mark.parametrize("S", [2, 3, 4, 5])
def test_choose_hyperparams_matches_jax(S):
    """Every branch of the DLR schedule, the sub-step switch and the
    S**frame_len <= 1024 cap."""
    for d_max, loc, rate in itertools.product(
            (0.001, 0.02, 0.05, 0.2, 1.0), (0.01, 0.03), (0.05, 0.4)):
        values = {f"D{s}": d_max * s / max(S - 1, 1) for s in range(S)}
        values.update({f"p{i}{j}": rate for i in range(S) for j in range(S)
                       if i != j})
        values.update(LocErr=loc, pBL=0.1)
        got = tauto.choose_hyperparams(values, 0.02, S)
        assert got == jauto.choose_hyperparams(values, 0.02, S)
        assert S ** got["frame_len"] <= 1024


def test_split_state_params_matches_jax():
    spec = tparams.generate_params(nb_states=2, estimated_Ds=[0.0, 0.08])
    got = tauto.split_state_params(spec.valuesdict(), 2)
    want = jauto.split_state_params(spec.valuesdict(), 2)
    assert isinstance(got, tparams.Parameters)
    assert got.valuesdict() == pytest.approx(want.valuesdict(), rel=1e-12)
    assert got.free_names() == want.free_names()


def test_auto_fit_matches_jax(tracks):
    kw = dict(nb_states=2, cell_dims=(0.5,), n_iterations=2, max_iter=2)
    got = tauto.auto_fit(tracks, 0.02, **CPU, **kw)
    want = jauto.auto_fit(tracks, 0.02, **kw)
    assert got.hyper == want.hyper
    assert len(got.stages) == len(want.stages) == 2
    for g, w in zip(got.stages, want.stages):
        _same_fit(g, w)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            tauto.auto_fit(tracks, 0.02, **kw)


def test_model_selection_matches_jax(tracks):
    kw = dict(state_range=(2, 3), cell_dims=(0.5,), frame_lens={2: 3, 3: 2},
              max_iter=4)
    got = tauto.model_selection(tracks, 0.02, **CPU, **kw)
    want = jauto.model_selection(tracks, 0.02, **kw)
    assert got.best_nb_states == want.best_nb_states
    for s in (2, 3):
        _same_fit(got.fits[s], want.fits[s])
        np.testing.assert_allclose([got.bic[s], got.aic[s]],
                                   [want.bic[s], want.aic[s]], rtol=1e-9)
    assert got.summary().splitlines()[0] == want.summary().splitlines()[0]


def test_fit_2states_matches_jax(tracks):
    """The hands-off workflow: auto_fit from estimated values with LocErr
    fixed, then the posteriors at frame_len 9 (K4's 512 slots)."""
    kw = dict(cell_dims=(0.5,), estimated_vals={"LocErr": 0.02, "D1": 0.05},
              vary_params={"LocErr": False})
    got, preds = tauto.fit_2states(tracks, 0.02, **CPU, **kw)
    want, jpreds = jauto.fit_2states(tracks, 0.02, **kw)
    _same_fit(got, want)
    assert got.params["LocErr"].value == 0.02
    assert sorted(preds) == sorted(jpreds)
    for k in jpreds:
        np.testing.assert_allclose(preds[k], np.asarray(jpreds[k]),
                                   rtol=1e-6, atol=1e-8)
