"""The port's posterior sampler against the JAX package's.

Float64 on the CPU, inputs from numpy seeds.  Deterministic pieces are
held to the JAX package's at fixed tolerances: the bijections'
log-Jacobian and its gradient at 1e-12 in every bound case, the HMC
potential (-logL - log-Jacobian) and its z-gradient at rel 1e-9, the
leapfrog integrator at rel 1e-9, R-hat and ESS at 1e-12.  The chains draw
from ``torch.Generator``s, so they are held to the moments of their
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)
targets (the tolerances of ``tests/test_sample.py``); the samples are
identical for any ``dispatch_chunk``.  The end-to-end comparison with the
JAX package's posterior is ``tests/test_torch_sample_posterior.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from extrack_tpu import data as jdata, fit as jfit, params as jparams
from extrack_tpu import sample as jsample, simulate as jsim
from extrack_tpu_torch import data as tdata, fit as tfit
from extrack_tpu_torch import params as tparams, sample as tsample

SIM = dict(max_track_len=5, min_track_len=3, LocErr=0.02, Ds=(0.0, 0.08),
           TrMat=np.array([[0.9, 0.1], [0.1, 0.9]]), dt=0.02, pBL=0.05,
           cell_dims=(0.5, None, None))


def _port_spec(jspec):
    return tparams.Parameters.from_records(
        [(p.name, p.value, p.min, p.max, p.vary, p.expr)
         for p in jspec._params.values()])


# ---- the bijections' log-Jacobian ----------------------------------------

def test_log_jacobian_matches_jax_in_every_bound_case():
    """Both bounds infinite, lower only, upper only, both finite; z far
    enough out that the sigmoid's 1e-14 clips act on either side."""
    jspec = jparams.Parameters()
    jspec.add("free", 0.3)
    jspec.add("lower", 0.5, min=0.1)
    jspec.add("upper", -0.2, max=1.0)
    jspec.add("both", 0.4, min=0.0, max=2.0)
    jspec.add("fixed", 0.1, vary=False)
    tspec = _port_spec(jspec)
    assert tspec.free_names() == jspec.free_names()
    rng = np.random.default_rng(0)
    for zb in (-3.0, -0.2, 0.7, 4.0, 40.0, -40.0):
        z = rng.normal(0, 2, 4)
        z[3] = zb
        want, g_want = jax.value_and_grad(jspec.unconstrained_log_jacobian)(
            jnp.asarray(z))
        zt = torch.tensor(z, requires_grad=True)
        got = tspec.unconstrained_log_jacobian(zt)
        (g,) = torch.autograd.grad(got, zt)
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(g.numpy(), np.asarray(g_want),
                                   rtol=1e-12, atol=1e-12)
        for i, n in enumerate(tspec.free_names()):
            p = tspec[n]
            np.testing.assert_allclose(
                float(tparams._logdet_from_z(zt[i].detach(), p.min, p.max)),
                float(jparams._logdet_from_z(jnp.asarray(z[i]), p.min,
                                             p.max)), rtol=1e-12, atol=1e-12)


# ---- the potential and the integrator ------------------------------------

@pytest.fixture(scope="module", params=[2, 3], ids=["2 states", "3 states"])
def potentials(request):
    """The HMC potential U(z) = -logL(z) - log|dtheta/dz| of both packages
    on the same tracks and Parameters, and a z near the start."""
    S = request.param
    kw = dict(SIM, nb_tracks=80, seed=31)
    if S == 3:
        kw.update(Ds=(0.0, 0.02, 0.1),
                  TrMat=np.full((3, 3), 0.05) + np.eye(3) * 0.85)
    tracks, _, _ = jsim.sim_fov(**kw)
    jspec = jparams.generate_params(nb_states=S, nb_dims=2, LocErr_type=1,
                                    D_max=1.0)
    tspec = _port_spec(jspec)
    jo = jfit.make_objective(jdata.from_dict_bucketed(tracks, max_buckets=2),
                             jspec, 0.02, S, cell_dims=(0.5,), window=3,
                             compute_engine="xla")
    to = tfit.make_objective(
        tdata.from_dict_bucketed(tracks, max_buckets=2, device="cpu"),
        tspec, 0.02, S, cell_dims=(0.5,), window=3)
    jvg = jax.jit(jax.value_and_grad(
        lambda z, data: jo(z, data) - jspec.unconstrained_log_jacobian(z)))

    def tvg(z, data):
        del data
        z = z.detach().requires_grad_(True)
        u = to(z) - tspec.unconstrained_log_jacobian(z)
        (g,) = torch.autograd.grad(u, z)
        return u.detach(), g

    z0 = jspec.to_unconstrained() + np.random.default_rng(S).normal(
        0, 0.2, len(jspec.free_names()))
    return jvg, jo.batches, tvg, z0


def test_potential_and_gradient_match_jax(potentials):
    jvg, data, tvg, z0 = potentials
    u_ref, g_ref = jvg(jnp.asarray(z0), data)
    u, g = tvg(torch.tensor(z0), None)
    np.testing.assert_allclose(float(u), float(u_ref), rtol=1e-9)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-9,
                               atol=1e-9 * float(np.abs(g_ref).max()))


def _leapfrog_both(jvg, jdata_, tvg, z, p, inv_mass, eps, n):
    want = jsample._leapfrog(jvg, jnp.asarray(z), jnp.asarray(p),
                             jnp.asarray(inv_mass), eps, n, jdata_)
    got = tsample._leapfrog(tvg, torch.tensor(z), torch.tensor(p),
                            torch.tensor(inv_mass), eps, n, None)
    for w, g in zip(want, got):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-9,
                                   atol=1e-9 * max(np.abs(w).max(), 1e-300))


def test_leapfrog_matches_jax_on_the_model_potential(potentials):
    jvg, data, tvg, z0 = potentials
    rng = np.random.default_rng(5)
    p = rng.normal(size=z0.shape)
    inv_mass = rng.uniform(0.5, 2.0, z0.shape)
    _leapfrog_both(jvg, data, tvg, z0, p, inv_mass, 0.01, 5)


def test_leapfrog_matches_jax_on_a_gaussian():
    cov = np.array([[1.0, 0.6, 0.0], [0.6, 2.0, 0.3], [0.0, 0.3, 0.5]])
    prec, mean = np.linalg.inv(cov), np.array([1.0, -2.0, 0.5])
    jprec, jmean = jnp.asarray(prec), jnp.asarray(mean)
    tprec, tmean = torch.tensor(prec), torch.tensor(mean)

    def jvg(z, data):
        d = z - jmean
        return 0.5 * d @ jprec @ d, jprec @ d

    def tvg(z, data):
        d = z - tmean
        return 0.5 * d @ tprec @ d, tprec @ d

    rng = np.random.default_rng(2)
    _leapfrog_both(jvg, None, tvg, rng.normal(size=3), rng.normal(size=3),
                   rng.uniform(0.5, 2.0, 3), 0.3, 7)


def test_split_rhat_and_ess_match_jax():
    rng = np.random.default_rng(0)
    iid = rng.normal(size=(2, 400))
    ar = np.zeros((3, 300))
    for t in range(1, 300):
        ar[:, t] = 0.9 * ar[:, t - 1] + rng.normal(size=3)
    for x in (iid, iid + np.array([[0.0], [5.0]]), ar, iid[:, :3]):
        for tf, jf in ((tsample._split_rhat, jsample._split_rhat),
                       (tsample._ess, jsample._ess)):
            np.testing.assert_allclose(tf(x), jf(x), rtol=1e-12,
                                       equal_nan=True)
    assert abs(tsample._split_rhat(iid) - 1.0) < 0.05
    assert tsample._ess(iid) > 200
    assert tsample._split_rhat(iid + np.array([[0.0], [5.0]])) > 1.5


# ---- the chain on exact targets (tests/test_sample.py:13-80) ---------------

def test_hmc_chain_gaussian_moments():
    """The raw chain samples a correlated Gaussian with the right moments
    (exact target: no likelihood, pure integrator test)."""
    cov = np.array([[1.0, 0.6, 0.0],
                    [0.6, 2.0, 0.3],
                    [0.0, 0.3, 0.5]])
    prec = torch.tensor(np.linalg.inv(cov))
    mean = torch.tensor([1.0, -2.0, 0.5])

    def vg(z, data):
        d = z - mean
        return 0.5 * d @ prec @ d, prec @ d

    gen = torch.Generator()
    gen.manual_seed(0)
    zs, acc, eps, inv_mass = tsample._hmc_chain(
        vg, torch.zeros(3, dtype=torch.float64), None, gen, num_warmup=500,
        num_samples=1500, n_leapfrog=16, target_accept=0.8, init_step=0.1)
    zs = zs.numpy()
    assert zs.shape == (1500, 3)
    assert 0.4 < float(acc) <= 1.0
    np.testing.assert_allclose(zs.mean(0), mean.numpy(), atol=0.25)
    np.testing.assert_allclose(np.cov(zs.T), cov, atol=0.6)
    # the adapted diagonal mass tracks the marginal variances
    assert np.all(inv_mass.numpy() > 0.1 * np.diag(cov))


def test_hmc_chain_jittered_step_moments():
    """Trajectory-length jitter keeps the chain exact (it only randomizes
    the proposal): a resonance-prone target (n_leapfrog*eps near a full
    period of the standard Gaussian) still recovers the moments."""
    def vg(z, data):
        return 0.5 * torch.sum(z * z), z

    gen = torch.Generator()
    gen.manual_seed(3)
    zs, acc, _, _ = tsample._hmc_chain(
        vg, torch.zeros(2, dtype=torch.float64), None, gen, num_warmup=400,
        num_samples=1200, n_leapfrog=8, target_accept=0.8, init_step=0.1,
        jitter=0.3)
    zs = zs.numpy()
    assert 0.4 < float(acc) <= 1.0
    np.testing.assert_allclose(zs.mean(0), 0.0, atol=0.2)
    np.testing.assert_allclose(zs.var(0), 1.0, atol=0.35)


# ---- sample_posterior ------------------------------------------------------

def test_sample_posterior_validates_inputs():
    tracks = {"3": np.zeros((1, 3, 2))}
    for kw, msg in (({"num_chains": 0}, "num_chains"),
                    ({"jitter": 1.5}, "jitter"),
                    ({"dispatch_chunk": 0}, "dispatch_chunk")):
        with pytest.raises(ValueError, match=msg):
            tsample.sample_posterior(tracks, 0.02, device="cpu", **kw)
        # the JAX package's messages
        with pytest.raises(ValueError, match=msg):
            jsample.sample_posterior(tracks, 0.02, **kw)
    # sharded=True on the CPU: one shard, the unsharded samples bit for bit
    kw = dict(num_samples=3, num_warmup=2, n_leapfrog=2, window=3,
              max_buckets=1, device="cpu")
    want = tsample.sample_posterior(tracks, 0.02, **kw)
    got = tsample.sample_posterior(tracks, 0.02, sharded=True, **kw)
    for k in want.samples:
        np.testing.assert_array_equal(got.samples[k], want.samples[k])
    if not torch.cuda.is_available():
        # the card by default, raising where there is none
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsample.sample_posterior(tracks, 0.02)


def test_sample_posterior_chunking_invariant():
    """dispatch_chunk only decides when samples move to the host: the
    samples are identical for any chunking, remainder chunks included."""
    tracks, _, _ = jsim.sim_fov(nb_tracks=40, seed=21, **SIM)
    kw = dict(nb_states=2, num_samples=11, num_warmup=9, num_chains=2,
              n_leapfrog=4, window=4, cell_dims=(0.5,), seed=5,
              max_buckets=1, device="cpu")
    a = tsample.sample_posterior(tracks, 0.02, dispatch_chunk=4, **kw)
    b = tsample.sample_posterior(tracks, 0.02, dispatch_chunk=10_000, **kw)
    assert set(a.samples) == set(b.samples)
    for k in a.samples:
        np.testing.assert_array_equal(a.samples[k], b.samples[k])
    assert (a.accept_rate, a.step_size) == (b.accept_rate, b.step_size)
    assert a.samples["LocErr"].dtype == np.float64


def test_sample_posterior_fisher_preconditioning():
    """fisher_sd preconditions the start spread and warmup metric without
    changing the API contract; zero / missing / non-finite entries keep
    the identity metric for that coordinate, exactly as the JAX package
    converts them."""
    tracks, _, _ = jsim.sim_fov(nb_tracks=60, seed=23, **SIM)
    sd = {"LocErr": 5e-4, "D1_minus_D0": 2e-3, "D0": 0.0,
          "p01": float("nan")}      # pinned + bad entries tolerated
    out = tsample.sample_posterior(
        tracks, 0.02, nb_states=2, num_samples=16, num_warmup=12,
        num_chains=2, n_leapfrog=4, window=4, cell_dims=(0.5,), seed=7,
        fisher_sd=sd, max_buckets=1, device="cpu")
    assert all(s.shape == (2, 16) for s in out.samples.values())
    assert np.isfinite(out.accept_rate)
    assert "R-hat" in out.summary()
    spec = tparams.generate_params(nb_states=2, nb_dims=2, LocErr_type=1)
    z0 = spec.to_unconstrained()
    sd_z = tsample._fisher_sd_z(spec, z0, sd)
    names = spec.free_names()
    for n in ("D0", "p01", "F0"):
        assert sd_z[names.index(n)] == 1.0
    p = spec["LocErr"]
    s = 1.0 / (1.0 + np.exp(-z0[names.index("LocErr")]))
    np.testing.assert_allclose(sd_z[names.index("LocErr")],
                               5e-4 / ((p.max - p.min) * s * (1 - s)),
                               rtol=1e-12)

