"""The port's ``baselines`` (its own copy of the reference's growing-register
recursion) against the JAX package's ``extrack_tpu.baselines``, and the
port's plain engine against it.

* Both functions and both ``end_pattern``s give the JAX package's numbers
  bit for bit on seeded inputs (the same numpy arithmetic).
* The port's plain engine (``core.engine.forward``, float64 on the CPU)
  against the port's baseline in the pruned regime, frame_len < track
  length, at 1e-9 (tests/test_reference_parity.py holds the JAX engine
  there): 2 states at windows 3-5 with and without bleaching, 3 states,
  two sub-steps, per-peak localization errors, and one register past 1024
  slots (3 states at window 7, K = 2187, tracks of 9 frames).
"""
import numpy as np
import pytest
import torch

from extrack_tpu import baselines as jbaselines
from extrack_tpu_torch import baselines
from extrack_tpu_torch.core import engine, tables
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)

DT = 0.02
TOL = dict(rtol=1e-9, atol=1e-9)


def _model(S=2):
    if S == 2:
        Ds = np.array([0.0, 0.1])
        Fs = np.array([0.4, 0.6])
        rates = np.array([[0.0, 0.1], [0.15, 0.0]])
    else:
        Ds = np.array([0.0, 0.03, 0.2])
        Fs = np.array([0.3, 0.3, 0.4])
        rates = np.array([[0.0, 0.08, 0.04], [0.1, 0.0, 0.05],
                          [0.03, 0.07, 0.0]])
    return Ds, Fs, rates


def _transition(rates, nb_substeps=1):
    return tables.transition_matrix(torch.tensor(rates),
                                    nb_substeps=nb_substeps).numpy()


def _sim_tracks(rng, n_tracks, T, D, Ds, tr, Fs, loc_err):
    """A direct simulator at frame resolution (tests/test_engine.py's)."""
    S = len(Ds)
    xs = np.zeros((n_tracks, T, D))
    for i in range(n_tracks):
        s = rng.choice(S, p=Fs)
        r = rng.normal(0, 1, D)
        for t in range(T):
            xs[i, t] = r + rng.normal(0, loc_err, D)
            s_next = rng.choice(S, p=tr[s])
            step = np.sqrt((2 * Ds[s] * DT + 2 * Ds[s_next] * DT) / 2)
            r = r + rng.normal(0, step, D)
            s = s_next
    return xs


@pytest.mark.parametrize("nb_substeps", [1, 2])
@pytest.mark.parametrize("end_pattern", ["full", "reference"])
def test_baseline_equals_jax_bit_for_bit(end_pattern, nb_substeps):
    rng = np.random.default_rng(70 + nb_substeps)
    Ds, Fs, rates = _model(3)
    tr = _transition(rates, nb_substeps)
    xs = _sim_tracks(rng, 5, 7, 2, Ds, tr, Fs, 0.02)
    loc = 0.015 + 0.01 * rng.random((5, 7, 2))
    kw = dict(pBL=0.1, isBL=1, cell_dims=(0.8,), nb_substeps=nb_substeps,
              frame_len=3, min_len=3, end_pattern=end_pattern)
    for loc_err in (0.02, loc):
        got = baselines.reference_log_likelihood(
            xs, loc_err, np.sqrt(2 * Ds * DT), Fs, tr, **kw)
        want = jbaselines.reference_log_likelihood(
            xs, loc_err, np.sqrt(2 * Ds * DT), Fs, tr, **kw)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("nb_substeps", [1, 2])
def test_threshold_baseline_equals_jax_bit_for_bit(nb_substeps):
    rng = np.random.default_rng(80 + nb_substeps)
    Cs = np.cumsum(rng.normal(0, 0.04, (12, 7, 2)), axis=1)
    kw = dict(loc_err=0.02, ds=np.array([0.0, 0.06]),
              Fs=np.array([0.4, 0.6]),
              TrMat=np.array([[0.9, 0.1], [0.2, 0.8]]), pBL=0.05, isBL=1,
              cell_dims=(0.5,), min_len=3, nb_substeps=nb_substeps,
              frame_len=4, threshold=0.2, max_nb_states=20)
    got = baselines.reference_log_likelihood_th(Cs, **kw)
    want = jbaselines.reference_log_likelihood_th(Cs, **kw)
    assert np.array_equal(got, want)


def _engine_logl(xs, isbl, Ds, Fs, rates, *, window, nb_substeps, min_len,
                 loc_err=0.02):
    f64 = dict(dtype=torch.float64)
    le = torch.tensor(loc_err, **f64)
    tb = tables.build_tables(torch.tensor(Ds, **f64), le,
                             torch.tensor(Fs, **f64),
                             torch.tensor(rates, **f64),
                             torch.tensor(0.1, **f64), DT, cell_dims=(0.8,),
                             nb_substeps=nb_substeps)
    B, T, _ = xs.shape
    return engine.forward(torch.tensor(xs, **f64),
                          torch.full((B,), T, dtype=torch.int64),
                          torch.full((B,), float(isbl), **f64), tb,
                          window=window, nb_substeps=nb_substeps,
                          min_len=min_len).numpy()


def _baseline_logl(xs, isbl, Ds, Fs, tr, *, frame_len, nb_substeps, min_len,
                   loc_err=0.02):
    # full-frame step stds with sub-steps too: the reference mixes the
    # sub-states' variances at the frame's displacement scale
    return baselines.reference_log_likelihood(
        xs, loc_err, np.sqrt(2 * Ds * DT), Fs, tr, pBL=0.1, isBL=isbl,
        cell_dims=(0.8,), nb_substeps=nb_substeps, frame_len=frame_len,
        min_len=min_len)


# (states, window, sub-steps, tracks, frames, bleached): frame_len < T
PRUNED_CASES = [(2, 3, 1, 6, 10, 1), (2, 4, 1, 6, 10, 0), (2, 5, 1, 6, 10, 1),
                (3, 3, 1, 4, 8, 1), (2, 4, 2, 4, 7, 1), (3, 7, 1, 3, 9, 1)]


@pytest.mark.parametrize("S,W,n,B,T,isbl", PRUNED_CASES)
def test_plain_engine_matches_baseline_pruned(S, W, n, B, T, isbl):
    rng = np.random.default_rng(60 + S * W + n)
    Ds, Fs, rates = _model(S)
    tr = _transition(rates, n)
    xs = _sim_tracks(rng, B, T, 2, Ds, tr, Fs, 0.02)
    assert W < T
    got = _engine_logl(xs, isbl, Ds, Fs, rates, window=W, nb_substeps=n,
                       min_len=3)
    want = _baseline_logl(xs, isbl, Ds, Fs, tr, frame_len=W, nb_substeps=n,
                          min_len=3)
    np.testing.assert_allclose(got, want, **TOL)


def test_plain_engine_matches_baseline_per_peak_locerr():
    rng = np.random.default_rng(64)
    Ds, Fs, rates = _model()
    tr = _transition(rates)
    xs = _sim_tracks(rng, 5, 9, 2, Ds, tr, Fs, 0.02)
    loc = 0.015 + 0.01 * rng.random((5, 9, 2))
    got = _engine_logl(xs, 1, Ds, Fs, rates, window=4, nb_substeps=1,
                       min_len=3, loc_err=loc)
    want = _baseline_logl(xs, 1, Ds, Fs, tr, frame_len=4, nb_substeps=1,
                          min_len=3, loc_err=loc)
    np.testing.assert_allclose(got, want, **TOL)
