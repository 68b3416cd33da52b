"""The port's chunked Hessian, Fisher errors and fit(compute_errors=True)
against the JAX package's.

Same simulated tracks (numpy, fixed seed) and the same Parameters go to
both packages, in float64 on the CPU.  Tolerances: rtol 1e-8 on Hessians
(exact second-order derivatives of the same engine, summed in another
order); 1e-10 relative on standard errors from one Hessian (the same
inverse and Jacobian in numpy); 1e-5 on the standard errors of two
three-iteration fits (their optima agree to ~1e-7, test_torch_fit.py).
"""
import numpy as np
import pytest
import torch

from extrack_tpu import data as jdata, fit as jfit
from extrack_tpu_torch import data as tdata, fit as tfit
from tests.test_torch_hvp import _dataset


@pytest.fixture(scope="module")
def two_state():
    return _dataset(2, 60, 7, 4)


def test_hessian_chunked_matches_jax(two_state):
    tracks, jspec, tspec, z = two_state
    jb = jdata.from_dict_bucketed(tracks, max_buckets=2)
    tb = tdata.from_dict_bucketed(tracks, max_buckets=2, dtype=torch.float64)
    kw = dict(cell_dims=(0.5,), window=4, min_len=2)
    H_ref = jfit.hessian_chunked(jb, jspec, z, 0.02, 2, **kw)
    H = tfit.hessian_chunked(tb, tspec, z, 0.02, 2, chunk=16, **kw)
    np.testing.assert_allclose(H, H_ref, rtol=1e-8,
                               atol=1e-12 * np.abs(H_ref).max())
    # the table-HVP assembly gives the same Hessian
    np.testing.assert_allclose(
        tfit.hessian_hvp_exact(tb, tspec, z, 0.02, 2, **kw), H, rtol=1e-8,
        atol=1e-12 * np.abs(H).max())


def test_fisher_errors_from_hessian_matches_jax(two_state):
    _, jspec, tspec, z = two_state
    rng = np.random.default_rng(3)
    M = rng.normal(0, 1, (len(z), len(z)))
    H = M @ M.T + len(z) * np.eye(len(z))
    e_ref = jfit.fisher_errors_from_hessian(H, jspec, z)
    e = tfit.fisher_errors_from_hessian(H, tspec, z)
    assert list(e) == list(e_ref)
    np.testing.assert_allclose(list(e.values()), list(e_ref.values()),
                               rtol=1e-10)
    # a singular Hessian takes the pseudo-inverse, as the JAX package does
    H[0] = H[:, 0] = 0.0
    np.testing.assert_allclose(
        list(tfit.fisher_errors_from_hessian(H, tspec, z).values()),
        list(jfit.fisher_errors_from_hessian(H, jspec, z).values()),
        rtol=1e-10)


def test_fisher_errors_of_objective(two_state):
    tracks, _, tspec, z = two_state
    tb = tdata.from_dict_bucketed(tracks, max_buckets=2, dtype=torch.float64)
    to = tfit.make_objective(tb, tspec, 0.02, 2, cell_dims=(0.5,), window=4)
    H = tfit.hessian_chunked(tb, tspec, z, 0.02, 2, cell_dims=(0.5,),
                             window=4, min_len=to.min_len)
    want = tfit.fisher_errors_from_hessian(H, tspec, z)
    got = tfit.fisher_errors(to, tspec, z)
    np.testing.assert_allclose(list(got.values()), list(want.values()),
                               rtol=1e-8)


def test_fit_compute_errors_matches_jax(two_state):
    tracks, jspec, tspec, _ = two_state
    jb = jdata.from_dict_bucketed(tracks, max_buckets=2)
    tb = tdata.from_dict_bucketed(tracks, max_buckets=2, dtype=torch.float64)
    jr = jfit.fit(jb, jspec, 0.02, 2, cell_dims=(0.5,), max_iter=3,
                  compute_errors=True, compute_engine="xla")
    tr = tfit.fit(tb, tspec, 0.02, 2, cell_dims=(0.5,), max_iter=3,
                  compute_errors=True)
    assert list(tr.std_errors) == list(jr.std_errors)
    np.testing.assert_allclose(list(tr.std_errors.values()),
                               list(jr.std_errors.values()), rtol=1e-5)
    assert all(np.isfinite(v) and v > 0 for v in tr.std_errors.values())
