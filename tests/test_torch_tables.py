"""Parity of the PyTorch port's model tables with the JAX package.

Inputs are made from a seed with numpy and handed to both packages; the
port computes in float64 on the CPU.  Tolerance: 1e-12 absolute / relative
on every ModelTables field, 1e-10 on gradients (float64 round-off through
expm and the 1000-point FOV grid).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from extrack_tpu.core import tables as jtables
from extrack_tpu_torch.core import tables as ttables
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)

F64 = dict(dtype=torch.float64)


def _inputs(seed, S=3, D=2, dt_shape=()):
    rng = np.random.default_rng(seed)
    rates = rng.uniform(0.02, 0.3, (S, S))
    rates[0, 1] = 0.0                       # forbidden transition: log floor
    Fs = rng.dirichlet(np.ones(S))
    dt = rng.uniform(0.01, 0.04, dt_shape) if dt_shape else 0.02
    return dict(Ds=np.linspace(0.0, 0.2, S),
                loc_err=rng.uniform(0.01, 0.04, D),
                Fs=Fs, rates=rates, pBL=0.07, dt=dt)


def _both(inp, **kw):
    j = jtables.build_tables(*(jnp.asarray(inp[k]) for k in
                               ("Ds", "loc_err", "Fs", "rates", "pBL",
                                "dt")), **kw)
    t = ttables.build_tables(*(torch.tensor(np.asarray(inp[k]), **F64) for k in
                               ("Ds", "loc_err", "Fs", "rates", "pBL")),
                             torch.tensor(np.asarray(inp["dt"]), **F64), **kw)
    return j, t


@pytest.mark.parametrize("matrix_type", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("nb_substeps", [1, 2])
def test_model_tables_match(matrix_type, nb_substeps):
    j, t = _both(_inputs(matrix_type), cell_dims=(0.6, None),
                 nb_substeps=nb_substeps, matrix_type=matrix_type)
    for f in ttables.ModelTables._fields:
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)),
                                   rtol=1e-12, atol=1e-12, err_msg=f)


@pytest.mark.parametrize("dt_shape", [(5,), (4, 5)])
def test_model_tables_variable_dt(dt_shape):
    """Per-step / per-track dt: sig2 rows and the median-dt survival."""
    j, t = _both(_inputs(11, dt_shape=dt_shape), cell_dims=(0.6,))
    for f in ttables.ModelTables._fields:
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)),
                                   rtol=1e-12, atol=1e-12, err_msg=f)


@pytest.mark.parametrize("matrix_type", [1, 2, 4])
def test_build_tables_gradient_matches_jax(matrix_type):
    """Autograd through build_tables equals jax.grad of the same scalar."""
    inp = _inputs(5, S=2)
    rng = np.random.default_rng(6)
    theta0 = np.array([0.01, 0.15, 0.1, 0.2, 0.03, 0.08, 0.35])
    shapes = [(2, 2), (2,), (1, 4), (2,), (2,), (1, 1, 1)]
    weights = [rng.normal(size=s) for s in shapes]

    def build(th, xp, mk):
        Ds = xp.stack([th[0], th[1]])
        zero = 0.0 * th[2]
        rates = xp.stack([xp.stack([zero, th[2]]), xp.stack([th[3], zero])])
        Fs = xp.stack([th[6], 1.0 - th[6]])
        return mk(Ds, th[4], Fs, rates, th[5], inp["dt"], cell_dims=(0.6,),
                  matrix_type=matrix_type)

    def jf(th):
        tb = build(th, jnp, jtables.build_tables)
        return sum(jnp.sum(jnp.asarray(w) * getattr(tb, f))
                   for w, f in zip(weights, jtables.ModelTables._fields))

    th = torch.tensor(theta0, **F64, requires_grad=True)
    tb = build(th, torch, ttables.build_tables)
    val = sum((torch.tensor(w, **F64) * getattr(tb, f)).sum()
              for w, f in zip(weights, ttables.ModelTables._fields))
    (g,) = torch.autograd.grad(val, th)
    v_ref, g_ref = jax.value_and_grad(jf)(jnp.asarray(theta0))
    np.testing.assert_allclose(float(val.detach()), float(v_ref),
                               rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-10,
                               atol=1e-10)


def test_helpers_and_tables_from_numpy():
    np.testing.assert_array_equal(ttables.state_codes(3, 4),
                                  jtables.state_codes(3, 4))
    tr = np.array([[0.9, 0.1, 0.0], [0.2, 0.7, 0.1], [0.0, 0.3, 0.7]])
    np.testing.assert_allclose(ttables.stationary_fractions(tr),
                               jtables.stationary_fractions(tr), rtol=1e-12)
    j, _ = _both(_inputs(3), cell_dims=(0.6,))
    t = ttables.tables_from_numpy(
        {f: np.asarray(getattr(j, f)) for f in j._fields}, "cpu",
        torch.float32)
    assert t.nb_states == 3
    for f in ttables.ModelTables._fields:
        assert getattr(t, f).dtype == torch.float32
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), rtol=1e-6)
    lt = torch.tensor(np.asarray(j.log_trans))
    for n in (1, 2):
        np.testing.assert_allclose(
            ttables.branch_log_trans(lt, n).numpy(),
            np.asarray(jtables.branch_log_trans(j.log_trans, n)), rtol=1e-12)
        np.testing.assert_allclose(
            ttables.init_log_prob(lt, torch.tensor(np.asarray(j.log_frac)),
                                  n).numpy(),
            np.asarray(jtables.init_log_prob(j.log_trans, j.log_frac, n)),
            rtol=1e-12)
