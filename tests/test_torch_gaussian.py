"""The port's Gaussian-product primitives (extrack_tpu_torch/core/gaussian.py)
against the JAX package's (extrack_tpu/core/gaussian.py) on the same
numpy inputs from a seed, float64 on the CPU, to 1e-12; and, as
tests/test_gaussian.py holds the JAX package's, against numerical
quadrature and pointwise products of densities."""
import numpy as np
import pytest
import torch
from scipy import integrate
from scipy.stats import norm

from extrack_tpu.core import gaussian as jgauss
from extrack_tpu_torch.core import gaussian as tgauss
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)

TOL = dict(rtol=1e-12, atol=1e-12)
# leading shapes of the inputs, the spatial dimension last
SHAPES = [(3,), (4, 2), (2, 5, 3), (6, 1, 2)]


def _pos(rng, shape):
    return rng.uniform(0.01, 0.3, shape)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 1])
def test_propagate_and_final_integral_match_jax(shape, seed):
    rng = np.random.default_rng(seed)
    x, m = rng.normal(size=(2,) + shape)
    l2, sig2, s2 = (_pos(rng, shape) for _ in range(3))
    got = tgauss.propagate(*map(torch.tensor, (x, l2, sig2, m, s2)))
    want = jgauss.propagate(x, l2, sig2, m, s2)
    assert got[2].shape == shape[:-1]
    for g, w in zip(got, want):
        _close(g, w)
    _close(tgauss.final_integral(*map(torch.tensor, (x, l2, m, s2))),
           jgauss.final_integral(x, l2, m, s2))
    gm, gs2 = tgauss.first_convolve(*map(torch.tensor, (x, l2, sig2)))
    wm, ws2 = jgauss.first_convolve(x, l2, sig2)
    _close(gm, wm)
    _close(gs2, ws2)


@pytest.mark.parametrize("shape", SHAPES)
def test_products_match_jax(shape):
    rng = np.random.default_rng(len(shape))
    mu1, mu2, mu3 = rng.normal(size=(3,) + shape)
    s1, s2, s3 = (np.sqrt(_pos(rng, shape)) for _ in range(3))
    t = [torch.tensor(a) for a in (s1, s2, mu1, mu2)]
    for g, w in zip(tgauss.product_2(*t), jgauss.product_2(s1, s2, mu1,
                                                           mu2)):
        _close(g, w)
    t = [torch.tensor(a) for a in (s1, s2, s3, mu1, mu2, mu3)]
    for g, w in zip(tgauss.product_3(*t),
                    jgauss.product_3(s1, s2, s3, mu1, mu2, mu3)):
        _close(g, w)


def _pdf(x, mu, sig):
    return norm.pdf(x, loc=mu, scale=sig)


def test_propagate_matches_quadrature():
    rng = np.random.default_rng(0)
    x, m = rng.normal(size=2)
    l2, sig2, s2 = 0.03, 0.08, 0.05

    def integrand(r1, r0):
        return (_pdf(x, r1, np.sqrt(l2)) * _pdf(r0 - r1, 0, np.sqrt(sig2))
                * _pdf(r1, m, np.sqrt(s2)))

    new_m, new_s2, log_c = tgauss.propagate(
        *(torch.tensor([v], dtype=torch.float64)
          for v in (x, l2, sig2, m, s2)))
    for r0 in [-0.7, 0.1, 1.3]:
        num, _ = integrate.quad(integrand, -6, 6, args=(r0,), limit=400,
                                points=(float(new_m[0]), m, x))
        ana = _exp(log_c) * _pdf(r0, float(new_m[0]),
                                 np.sqrt(float(new_s2[0])))
        assert num == pytest.approx(ana, rel=1e-9)


def _exp(t):
    return float(torch.exp(t))


@pytest.mark.parametrize("n", [2, 3])
def test_products_match_pointwise(n):
    rng = np.random.default_rng(n)
    mu = rng.normal(size=(n, 2))
    sigs = [0.2, 0.4, 0.3][:n]
    args = ([torch.full((2,), s, dtype=torch.float64) for s in sigs]
            + [torch.tensor(m) for m in mu])
    sig, m, log_c = (tgauss.product_2 if n == 2 else tgauss.product_3)(*args)
    for x in [-0.5, 0.25]:
        lhs = np.prod([_pdf(x, mu[i], sigs[i]) for i in range(n)])
        rhs = _exp(log_c) * np.prod(_pdf(x, m.numpy(), sig.numpy()))
        assert lhs == pytest.approx(rhs, rel=1e-9)
