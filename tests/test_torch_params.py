"""Parity of the PyTorch port's parameter system with the JAX package.

Both packages get the same Parameters (through records) and the same
unconstrained vector z, made from a seed with numpy.  Tolerance: 1e-12 on
values, bijections and model arrays (float64); 1e-10 on gradients through
the steady-state solve.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from extrack_tpu import params as jparams
from extrack_tpu_torch import params as tparams
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)


def _records(jp):
    return [(p.name, p.value, p.min, p.max, p.vary, p.expr)
            for p in jp._params.values()]


def _spec_pairs():
    yield "2-state", jparams.generate_params(nb_states=2, D_max=1.0)
    yield "3-state LocErr2", jparams.generate_params(
        nb_states=3, LocErr_type=2, nb_dims=2)
    yield "3-state LocErr3", jparams.generate_params(
        nb_states=3, LocErr_type=3, nb_dims=3)
    yield "2-state steady", jparams.generate_params(nb_states=2,
                                                    steady_state=True)
    yield "3-state steady", jparams.generate_params(nb_states=3,
                                                    steady_state=True)
    yield "4-state steady", jparams.generate_params(nb_states=4,
                                                    steady_state=True)
    yield "get_params", jparams.get_params(
        nb_states=3, estimated_vals={"LocErr": 0.02, "D0": 0.001,
                                     "D1": 0.05, "D2": 0.3, "F0": 0.3,
                                     "F1": 0.3, "p01": 0.1, "p02": 0.05,
                                     "p10": 0.1, "p12": 0.02, "p20": 0.03,
                                     "p21": 0.04, "pBL": 0.05})


SPECS = dict(_spec_pairs())


def _close(a, b, tol=1e-12):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("name", list(SPECS))
def test_resolve_bijections_extract(name):
    jp = SPECS[name]
    tp = tparams.Parameters.from_records(_records(jp))
    assert tp.free_names() == jp.free_names()
    _close(tp.to_unconstrained(), jp.to_unconstrained())
    # stored values
    jv, tv = jp.resolve(), tp.resolve()
    assert list(jv) == list(tv)
    for k in jv:
        _close(float(tv[k]), float(jv[k]))
    # at a random unconstrained point
    z = np.random.default_rng(len(name)).normal(0, 1.0, len(jp.free_names()))
    jv = jp.resolve(jp.from_unconstrained(jnp.asarray(z)))
    tv = tp.resolve(tp.from_unconstrained(torch.tensor(z)))
    for k in jv:
        _close(float(tv[k]), float(jv[k]))
    S = sum(1 for k in jv if k[0] == "D" and k[1:].isdigit())
    for a, b in zip(tparams.extract_arrays(tv, S),
                    jparams.extract_arrays(jv, S)):
        _close(a.numpy(), b)


def test_records_round_trip():
    for jp in SPECS.values():
        tp = tparams.Parameters.from_records(_records(jp))
        back = tparams.Parameters.from_records(tp.to_records())
        assert back.to_records() == tp.to_records()
        assert back.steady_state_n == jp.steady_state_n
        for k, v in tp.resolve().items():
            _close(float(back.resolve()[k]), float(v))


def test_steady_state_solve_and_gradient():
    """4-state stationary fractions: pi Q = 0, sum 1, and the gradient
    through the solve matches jax.grad."""
    jp = SPECS["4-state steady"]
    tp = tparams.Parameters.from_records(_records(jp))
    z0 = np.random.default_rng(3).normal(0, 0.5, len(jp.free_names()))

    def jfun(z):
        v = jp.resolve(jp.from_unconstrained(z))
        return sum((s + 1.0) * v[f"F{s}"] for s in range(4))

    z = torch.tensor(z0, requires_grad=True)
    v = tp.resolve(tp.from_unconstrained(z))
    pi = torch.stack([v[f"F{s}"] for s in range(4)])
    Q = torch.tensor([[0.0 if i == j else float(v[f"p{i}{j}"])
                       for j in range(4)] for i in range(4)],
                     dtype=torch.float64)
    Q = Q - torch.diag(Q.sum(1))
    _close(float(pi.sum()), 1.0)
    _close((pi.detach() @ Q).numpy(), np.zeros(4))
    (g,) = torch.autograd.grad(sum((s + 1.0) * v[f"F{s}"] for s in range(4)),
                               z)
    np.testing.assert_allclose(g.numpy(),
                               np.asarray(jax.grad(jfun)(jnp.asarray(z0))),
                               rtol=1e-10, atol=1e-10)


def test_expr_guards_and_funcs():
    p = tparams.Parameters()
    p.add("a", 0.5, 0.0, 1.0)
    p.add("b", expr="exp(a) + sqrt(a) - log(a) + min(a, 0.2) + abs(-a)")
    v = p.resolve({"a": torch.tensor(0.3, dtype=torch.float64)})
    _close(float(v["b"]), np.exp(0.3) + np.sqrt(0.3) - np.log(0.3) + 0.2
           + 0.3)
    with pytest.raises(ValueError):
        p.add("c", expr="__import__('os')")
