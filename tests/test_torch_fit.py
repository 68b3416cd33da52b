"""The port's fit objective and fit loop against the JAX package's.

Same simulated tracks (numpy, fixed seed) and the same Parameters go to
both packages, in float64 on the CPU.  Tolerances: 1e-9 relative on the
objective value and its z-gradient (the engines agree to ~1e-12 per
track; the sum over a few hundred tracks and the parameter chain add
round-off); 1e-6 on the free parameters after three L-BFGS-B iterations
(both fit loops run scipy on gradients that differ only by round-off).
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from extrack_tpu import data as jdata, fit as jfit, params as jparams
from extrack_tpu import simulate as jsim
from extrack_tpu_torch import data as tdata, fit as tfit, params as tparams


@pytest.fixture(scope="module")
def dataset():
    tracks, _, _ = jsim.sim_fov(
        nb_tracks=150, max_track_len=7, min_track_len=2, LocErr=0.02,
        Ds=(0.0, 0.08), dt=0.02, pBL=0.1, cell_dims=(0.5, None, None),
        seed=4)
    jspec = jparams.generate_params(nb_states=2, D_max=1.0,
                                    estimated_Ds=[0.001, 0.05])
    tspec = tparams.Parameters.from_records(
        [(p.name, p.value, p.min, p.max, p.vary, p.expr)
         for p in jspec._params.values()])
    return tracks, jspec, tspec


def _objectives(dataset, **kw):
    tracks, jspec, tspec = dataset
    jb = jdata.from_dict_bucketed(tracks, max_buckets=2)
    tb = tdata.from_dict_bucketed(tracks, max_buckets=2, dtype=torch.float64)
    jo = jfit.make_objective(jb, jspec, 0.02, 2, cell_dims=(0.5,),
                             compute_engine="xla", **kw)
    to = tfit.make_objective(tb, tspec, 0.02, 2, cell_dims=(0.5,), **kw)
    return jo, to


@pytest.mark.parametrize("kw", [{}, {"window": 3, "nb_substeps": 2}])
def test_objective_value_and_gradient(dataset, kw):
    jo, to = _objectives(dataset, **kw)
    z0 = dataset[1].to_unconstrained() + np.random.default_rng(0).normal(
        0, 0.3, len(dataset[1].free_names()))
    v_ref, g_ref = jax.value_and_grad(jo)(jnp.asarray(z0))
    z = torch.tensor(z0, requires_grad=True)
    v = to(z)
    (g,) = torch.autograd.grad(v, z)
    np.testing.assert_allclose(float(v.detach()), float(v_ref), rtol=1e-9)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-9,
                               atol=1e-9 * float(np.abs(g_ref).max()))


def test_three_iteration_fit_reaches_same_z(dataset):
    tracks, jspec, tspec = dataset
    jb = jdata.from_dict_bucketed(tracks, max_buckets=2)
    tb = tdata.from_dict_bucketed(tracks, max_buckets=2, dtype=torch.float64)
    jr = jfit.fit(jb, jspec, 0.02, 2, cell_dims=(0.5,), max_iter=3,
                  compute_engine="xla")
    evals = []
    tr = tfit.fit(tb, tspec, 0.02, 2, cell_dims=(0.5,), max_iter=3,
                  callback=lambda i, v, vals: evals.append(v))
    assert tr.n_evals == jr.n_evals == len(evals)
    np.testing.assert_allclose(tr.params.to_unconstrained(),
                               jr.params.to_unconstrained(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tr.logl, jr.logl, rtol=1e-9)
    assert tr.logl > -evals[0]


def test_fit_options(dataset, tmp_path):
    tracks, _, tspec = dataset
    res_e = tfit.param_fitting(tracks, 0.02, params=tspec, verbose=0,
                               max_iter=2, cell_dims=(0.5,),
                               compute_errors=True, device="cpu")
    assert list(res_e.std_errors) == tspec.free_names()
    assert all(np.isfinite(v) for v in res_e.std_errors.values())
    assert "+/-" in repr(res_e)
    ckpt = tmp_path / "fit.json"
    res = tfit.param_fitting(tracks, 0.02, params=tspec, verbose=0,
                             max_iter=2, cell_dims=(0.5,),
                             checkpoint_path=str(ckpt), n_starts=2,
                             device="cpu")
    saved = json.loads(ckpt.read_text())
    assert saved["objective"] == pytest.approx(-res.logl, rel=1e-9)
    assert np.isfinite(res.logl) and "FitResult" in repr(res)
    # gradient-free branch: value-only evaluations
    res_p = tfit.param_fitting(tracks, 0.02, params=tspec, verbose=0,
                               max_iter=1, method="Powell",
                               cell_dims=(0.5,), device="cpu")
    assert np.isfinite(res_p.logl) and res_p.n_evals > 1
    assert tfit.default_window(2) == 6 and tfit.default_window(5) == 3
    assert tfit.default_window(5, nb_substeps=3) == 4
    # the entry point runs on the card unless told otherwise
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            tfit.param_fitting(tracks, 0.02, params=tspec, max_iter=1)
