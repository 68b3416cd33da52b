"""The port's refinement extras (extrack_tpu_torch/refine.py: the raw
mixture API ``get_pos_PDF`` and its consumers, the fixed-state refinement,
``get_best_estimates``, the reference-named Gaussian helpers and the GIF
rendering) against the JAX package's, on the same numpy inputs from a
seed, float64 on the CPU, to 1e-7 (the refinement's tolerance,
tests/test_pallas_refine.py); the Gaussian helpers to 1e-12.  The cases
follow tests/test_refine_extras.py and tests/test_refine_mixture.py.
``get_best_estimates`` runs K4 on the card; tests/test_torch_cuda.py and
``chip_smoke.py`` hold it there."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from extrack_tpu import refine as jrefine
from extrack_tpu_torch import params as tparams, refine as trefine
from extrack_tpu_torch.ops import predict_kernel
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)

TOL = dict(rtol=1e-7, atol=1e-9)
DS = np.array([0.0, 0.1])
TR = np.array([[.9, .1], [.15, .85]])
DT, LOC = 0.02, 0.02
CPU = dict(device="cpu")


def _walks(seed, n=5, T=6, D=2, S=2):
    """Random walks whose per-frame state follows a chain of TR's kind."""
    rng = np.random.default_rng(seed)
    Ds = np.linspace(0.0, 0.1, S)
    tr = (0.9 * np.eye(S) + 0.1 / (S - 1) * (1 - np.eye(S)) if S > 1
          else np.ones((1, 1)))
    states = np.zeros((n, T), int)
    states[:, 0] = rng.integers(0, S, n)
    for t in range(1, T):
        states[:, t] = [rng.choice(S, p=tr[s]) for s in states[:, t - 1]]
    steps = (rng.normal(size=(n, T, D))
             * np.sqrt(2 * Ds[states] * DT)[..., None])
    xs = steps.cumsum(1) + rng.normal(0, LOC, (n, T, D))
    return xs, states, np.sqrt(2 * Ds * DT), tr


@pytest.mark.parametrize("seed,n,T,D", [(0, 5, 6, 2), (1, 3, 9, 1),
                                        (2, 4, 7, 3)])
def test_fixed_states_refinement_matches_jax(seed, n, T, D):
    xs, states, ds, _ = _walks(seed, n, T, D)
    rng = np.random.default_rng(seed + 10)
    lengths = rng.integers(1, T + 1, n)
    lengths[0] = T
    l2 = rng.uniform(1e-4, 9e-4, (n, T, D))
    got = trefine.refine_positions_fixed_states(
        torch.tensor(xs), torch.tensor(lengths), torch.tensor(l2),
        torch.tensor(ds ** 2), torch.tensor(states))
    want = jrefine.refine_positions_fixed_states(
        jnp.asarray(xs), jnp.asarray(lengths), jnp.asarray(l2),
        jnp.asarray(ds ** 2), jnp.asarray(states))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_fixed_states_refinement_is_the_one_state_mixture():
    """One state (no mixture): the fixed-state refinement is the mixture
    engine's refinement."""
    xs, _, _, _ = _walks(60, 3, 7, 2, S=1)
    lengths = torch.tensor([7, 5, 7])
    d2 = torch.tensor([2 * 0.05 * DT])
    mu1, s1 = trefine.refine_positions_fixed_states(
        torch.tensor(xs), lengths, torch.tensor(LOC ** 2),
        d2, torch.zeros((3, 7), dtype=torch.int64))
    mu2, s2 = trefine.refine_positions(
        torch.tensor(xs), lengths, torch.tensor(LOC ** 2).reshape(1, 1, 1),
        torch.zeros((1, 1), dtype=torch.float64), d2, window=2)
    torch.testing.assert_close(mu1, mu2, rtol=0, atol=1e-10)
    torch.testing.assert_close(s1, s2, rtol=0, atol=1e-10)


def test_fixed_states_heterogeneous_exact_posterior():
    """State-changing tracks against the exact tridiagonal Gaussian
    posterior."""
    rng = np.random.default_rng(63)
    T, L = 6, 4
    pos = rng.normal(0, 0.3, (1, T, 2))
    pos[0, L:] = 9.9                       # garbage in the pad region
    states = np.array([[1, 0, 1, 0, 1, 0]])
    sig2_states = np.array([0.03, 0.9])
    le2 = 0.004
    d2 = sig2_states[states[0, :L]]
    s2step = 0.5 * (d2[:-1] + d2[1:])
    prec = np.diag(np.full(L, 1.0 / le2))
    for t in range(L - 1):
        prec[t:t + 2, t:t + 2] += np.array([[1, -1], [-1, 1]]) / s2step[t]
    cov = np.linalg.inv(prec)
    mu, sd = trefine.refine_positions_fixed_states(
        torch.tensor(pos), torch.tensor([L]), torch.tensor(le2),
        torch.tensor(sig2_states), torch.tensor(states))
    for dim in range(2):
        np.testing.assert_allclose(mu[0, :L, dim].numpy(),
                                   cov @ (pos[0, :L, dim] / le2), atol=1e-9)
        np.testing.assert_allclose(sd[0, :L, dim].numpy(),
                                   np.sqrt(np.diag(cov)), atol=1e-9)


@pytest.mark.parametrize("seed,T,frame_len", [(41, 6, 6), (42, 5, 3),
                                              (43, 7, 4)])
def test_get_pos_pdf_and_its_consumers_match_jax(seed, T, frame_len):
    xs, _, ds, _ = _walks(seed, 4, T)
    Fs = np.array([.5, .5])
    got = trefine.get_pos_PDF(xs, LOC, ds, Fs, TR, frame_len=frame_len,
                              **CPU)
    want = jrefine.get_pos_PDF(xs, LOC, ds, Fs, TR, frame_len=frame_len)
    for g_list, w_list in zip(got, want):
        assert len(g_list) == len(w_list) == T
        for g, w in zip(g_list, w_list):
            assert g.shape == np.shape(w)
            np.testing.assert_allclose(g, np.asarray(w), **TOL)
    means, stds, weights, Bs = got
    for g, w in zip(trefine.get_all_estimates(weights, Bs, means, stds),
                    jrefine.get_all_estimates(*(want[i]
                                                for i in (2, 3, 0, 1)))):
        np.testing.assert_allclose(g, w, **TOL)
    for idx in (0, 3):
        for g, w in zip(trefine.get_global_sigs_mus(means, stds, weights,
                                                    idx=idx),
                        jrefine.get_global_sigs_mus(want[0], want[1],
                                                    want[2], idx=idx)):
            np.testing.assert_allclose(g, w, **TOL)


def test_get_pos_pdf_moments_are_position_refinement():
    xs, _, ds, _ = _walks(44, 5, 6)
    Fs = np.array([.5, .5])
    means, _, weights, _ = trefine.get_pos_PDF(xs, LOC, ds, Fs, TR,
                                               frame_len=6, **CPU)
    mus_ref, _ = trefine.position_refinement({"6": xs}, LOC, ds, Fs, TR,
                                             frame_len=6, **CPU)
    for k in range(6):
        w = np.exp(weights[k] - weights[k].max(axis=1, keepdims=True))
        w = np.where(np.isfinite(weights[k]), w, 0.0)
        mu_k = (w[..., None] * means[k]).sum(1) / w.sum(1)[:, None]
        np.testing.assert_allclose(mu_k, mus_ref["6"][:, k], atol=1e-9)


@pytest.mark.parametrize("S,frame_len,T", [(2, 6, 10), (2, 10, 9),
                                           (3, 10, 9)])
def test_get_best_estimates_matches_jax(S, frame_len, T):
    """The posteriors run ``predict_kernel.predict`` (its plain version on
    the CPU; K4 at window min(frame_len, 8) on the card: 3 states at the
    default frame_len 10 is K = 6561), then the fixed-state refinement."""
    xs, _, ds, tr = _walks(7 + S, 30, T, 2, S=S)
    Fs = np.full(S, 1.0 / S)
    before = predict_kernel.PLAIN_CALLS
    got = trefine.get_best_estimates(xs, 0.03, ds, Fs, tr,
                                     frame_len=frame_len, **CPU)
    assert predict_kernel.PLAIN_CALLS == before + 1
    want = jrefine.get_best_estimates(xs, 0.03, ds, Fs, tr,
                                      frame_len=frame_len)
    for g, w in zip(got, want):
        assert g.shape == xs.shape
        np.testing.assert_allclose(g, w, **TOL)


def test_get_best_estimates_reduces_error():
    rng = np.random.default_rng(7)
    n, T, loc_err = 150, 10, 0.05
    true = np.cumsum(rng.normal(0, np.sqrt(2 * DS[1] * DT), (n, T, 2)),
                     axis=1)
    obs = true + rng.normal(0, loc_err, true.shape)
    mus, _ = trefine.get_best_estimates(obs, loc_err, np.sqrt(2 * DS * DT),
                                        np.array([.5, .5]), TR, frame_len=6,
                                        **CPU)
    assert np.mean((mus - true) ** 2) < np.mean((obs - true) ** 2)


def test_gaussian_helpers_match_jax():
    rng = np.random.default_rng(0)
    mu1, mu2, mu3 = rng.normal(size=(3, 4, 2))
    s1, s2, s3 = rng.uniform(0.5, 2.0, (3, 4, 1))
    for g, w in zip(trefine.prod_2GaussPDF(s1, s2, mu1, mu2),
                    jrefine.prod_2GaussPDF(s1, s2, mu1, mu2)):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)
    for g, w in zip(trefine.prod_3GaussPDF(s1, s2, s3, mu1, mu2, mu3),
                    jrefine.prod_3GaussPDF(s1, s2, s3, mu1, mu2, mu3)):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(trefine.gaussian(mu1, s1, mu2),
                               jrefine.gaussian(mu1, s1, mu2), rtol=1e-12)


@pytest.mark.parametrize("reference_shape", [False, True])
def test_get_pos_pdf_fixed_bs_matches_jax(reference_shape):
    xs, states, ds, _ = _walks(5, 2, 6)
    Bs = states[:, None] if reference_shape else states
    got = trefine.get_pos_PDF_fixedBs(xs, 0.02, ds, np.array([.5, .5]), TR,
                                      Bs, **CPU)
    want = jrefine.get_pos_PDF_fixedBs(xs, 0.02, ds, np.array([.5, .5]), TR,
                                       Bs)
    for g, w in zip(got, want):
        assert g.shape == (6, 2)
        np.testing.assert_allclose(g, w, **TOL)


def test_save_gifs(tmp_path):
    rng = np.random.default_rng(62)
    tracks = {"6": rng.normal(0, 0.05, (2, 6, 2)).cumsum(1)}
    trefine.save_gifs(tracks, {"6": tracks["6"] * 0.9},
                      {"6": np.full((2, 6), 0.01)},
                      gif_pathnames=str(tmp_path / "trk"), max_tracks=1)
    assert os.path.exists(tmp_path / "trk6_0.gif")
    assert not os.path.exists(tmp_path / "trk6_1.gif")


def test_do_gifs_from_params(tmp_path):
    rng = np.random.default_rng(64)
    tracks = {"5": rng.normal(0, 0.05, (2, 5, 2)).cumsum(1)}
    tp = tparams.generate_params(nb_states=2)
    trefine.do_gifs_from_params(tracks, tp, DT,
                                gif_pathnames=str(tmp_path / "p"),
                                frame_len=4, max_tracks=2, **CPU)
    assert os.path.exists(tmp_path / "p5_0.gif")
    assert os.path.exists(tmp_path / "p5_1.gif")
