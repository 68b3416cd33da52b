"""The port's position refinement (the plain version of K6,
``position_refinement`` and the window schedule) against the JAX
package's.

Tolerances, float64 on the CPU: 1e-10 relative on mu and sigma against
extrack_tpu.refine.refine_positions (the XLA path; the same arithmetic in
another order) for tracks of 2 frames or more; 1e-9 on
``position_refinement`` (the port length-buckets, the JAX entry point runs one
padded batch).  1-frame rows, where the JAX package's two paths disagree
(the XLA path returns mu = sigma = 0), are held against the Pallas kernel
in interpret mode at its float32 tolerances (mu rtol 2e-4 / atol 2e-5,
sigma rtol 2e-3 / atol 2e-5, as tests/test_pallas_refine.py), and at
1e-14 against the observation and its localization error.

The CUDA kernel K6 itself is checked against its plain version in
tests/test_torch_cuda.py (needs a GPU).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from extrack_tpu import refine as jrefine
from extrack_tpu.ops import pallas_refine
from extrack_tpu_torch import data as tdata, refine as trefine
from extrack_tpu_torch.core import tables as ttables
from extrack_tpu_torch.ops import refine_kernel


def _case(seed, S, B, T, D=2, per_peak=False):
    """Random walks (lengths 0..T, the first rows T, 2, 1, 0) and a
    transition matrix with a zero: the port's floored log table and the
    JAX package's own log (-inf)."""
    rng = np.random.default_rng(seed)
    xs = rng.normal(0, 0.05, (B, T, D)).cumsum(1)
    lengths = rng.integers(0, T + 1, B)
    lengths[:4] = (T, min(2, T), 1, 0)
    tr = rng.uniform(0.05, 0.3, (S, S))
    tr[0, 1] = 0.0                                      # forbidden
    np.fill_diagonal(tr, 0.0)
    np.fill_diagonal(tr, 1.0 - tr.sum(1))
    loc_err2 = (rng.uniform(0.01, 0.03, (B, T, D)) ** 2 if per_peak
                else np.full((1, 1, 1), 0.02 ** 2))
    sig2 = (0.08 * (1 + np.arange(S))) ** 2
    return xs, lengths, tr, loc_err2, sig2


@pytest.mark.parametrize("S,W,T,D,per_peak", [
    (2, 5, 9, 2, False),
    (2, 4, 8, 2, True),          # per-peak LocErr
    (3, 3, 7, 2, False),         # 3 states: odd K
    (2, 3, 2, 2, False),         # T = 2: both ends, no interior
    (2, 6, 4, 1, False),         # window wider than the tracks, D = 1
    (3, 2, 6, 3, True),          # D = 3
])
def test_refine_positions_match_jax(S, W, T, D, per_peak):
    xs, lengths, tr, loc_err2, sig2 = _case(S * 10 + W + T, S, 11, T, D,
                                            per_peak)
    mu_j, sig_j = jrefine.refine_positions(
        jnp.asarray(xs), jnp.asarray(lengths), jnp.asarray(loc_err2),
        jnp.log(jnp.asarray(tr)), jnp.asarray(sig2), window=W)
    args = (torch.tensor(xs), torch.tensor(lengths), torch.tensor(loc_err2),
            ttables.cap_log(torch.tensor(tr)), torch.tensor(sig2))
    before = refine_kernel.PLAIN_CALLS, refine_kernel.LAUNCHES
    mu, sig = refine_kernel.refine(*args, window=W)
    # CPU tensors take the plain version, never the kernel
    assert (refine_kernel.PLAIN_CALLS, refine_kernel.LAUNCHES) == (
        before[0] + 1, before[1])
    assert mu.shape == sig.shape == (11, T, D)
    two = lengths >= 2
    np.testing.assert_allclose(mu.numpy()[two], np.asarray(mu_j)[two],
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(sig.numpy()[two], np.asarray(sig_j)[two],
                               rtol=1e-10, atol=1e-12)
    # padding and empty rows are exact zeros
    valid = np.arange(T)[None, :] < lengths[:, None]
    assert np.all(mu.numpy()[~valid] == 0.0)
    assert np.all(sig.numpy()[~valid] == 0.0)
    # a lone observation refines to itself
    l2 = np.broadcast_to(loc_err2, xs.shape)
    np.testing.assert_allclose(mu.numpy()[2, 0], xs[2, 0], rtol=1e-14)
    np.testing.assert_allclose(sig.numpy()[2, 0], np.sqrt(l2[2, 0]),
                               rtol=1e-14)


def test_one_frame_rows_follow_the_pallas_kernel():
    xs, lengths, tr, loc_err2, sig2 = _case(5, 2, 12, 6)
    lengths[4:8] = 1
    # the floored log table: the TPU kernel's max-shifted sums turn a
    # group of -inf weights into NaN
    log_trans = ttables.cap_log(torch.tensor(tr))
    mu_p, sig_p = pallas_refine.refine_pallas(
        jnp.asarray(xs, jnp.float32), jnp.asarray(lengths),
        jnp.asarray(loc_err2, jnp.float32), jnp.asarray(log_trans.numpy()),
        jnp.asarray(sig2), window=4, interpret=True)
    mu, sig = trefine.refine_positions(
        torch.tensor(xs), torch.tensor(lengths), torch.tensor(loc_err2),
        log_trans, torch.tensor(sig2), window=4)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_p), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(sig.numpy(), np.asarray(sig_p), rtol=2e-3,
                               atol=2e-5)
    # the JAX XLA path is the one that differs, and only on those rows
    mu_x, _ = jrefine.refine_positions(
        jnp.asarray(xs), jnp.asarray(lengths), jnp.asarray(loc_err2),
        jnp.log(jnp.asarray(tr)), jnp.asarray(sig2), window=4)
    lone = lengths == 1
    assert np.all(np.asarray(mu_x)[lone] == 0.0)
    np.testing.assert_allclose(mu.numpy()[~lone], np.asarray(mu_x)[~lone],
                               rtol=1e-10, atol=1e-12)


def test_refine_tables_match_pallas():
    rng = np.random.default_rng(2)
    log_trans = np.log(rng.dirichlet(np.ones(3), 3))
    sig2 = np.array([1e-4, 4e-3, 9e-3])
    for W in (2, 3, 4):
        want = pallas_refine.build_refine_tables(log_trans, sig2, W)
        got = refine_kernel.build_refine_tables(torch.tensor(log_trans),
                                                torch.tensor(sig2), W)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-14)


def test_default_window_matches_jax():
    for S in range(2, 13):
        assert trefine.default_window(S) == jrefine.default_window(S, 16, 2)


@pytest.fixture(scope="module")
def tracks():
    rng = np.random.default_rng(42)
    out = {str(L): rng.normal(0, 0.05, (n, L, 2)).cumsum(1)
           for L, n in ((2, 6), (3, 5), (5, 7), (6, 2), (8, 5), (9, 3))}
    errs = {k: rng.uniform(0.01, 0.03, v.shape) for k, v in out.items()}
    return out, errs


@pytest.mark.parametrize("per_peak", [False, True])
def test_position_refinement_matches_jax(tracks, per_peak):
    all_tracks, errs = tracks
    loc = errs if per_peak else 0.02
    ds = np.array([0.02, 0.1])
    tr = np.array([[0.9, 0.1], [0.0, 1.0]])            # forbidden 1 -> 0
    Fs = np.array([0.5, 0.5])
    mus_j, sigs_j = jrefine.position_refinement(
        all_tracks, loc, ds, Fs, tr, frame_len=5, compute_engine="xla")
    before = refine_kernel.PLAIN_CALLS
    mus, sigs = trefine.position_refinement(all_tracks, loc, ds, Fs, tr,
                                            frame_len=5, device="cpu")
    assert refine_kernel.PLAIN_CALLS == before + len(
        tdata.from_dict_bucketed(all_tracks, max_buckets=4))
    assert list(mus) == list(mus_j) == list(all_tracks)
    for k in all_tracks:
        assert mus[k].shape == all_tracks[k].shape
        assert sigs[k].shape == all_tracks[k].shape[:2]
        np.testing.assert_allclose(mus[k], mus_j[k], rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(sigs[k], sigs_j[k], rtol=1e-9,
                                   atol=1e-12)


def test_refine_batch_defaults_and_sharding(tracks):
    batch = tdata.from_dict(tracks[0])
    ds, tr = np.array([0.02, 0.1, 0.2]), np.full((3, 3), 1 / 3)
    mu, _ = trefine.refine_batch(batch, 0.02, ds, tr)
    mu5, _ = trefine.refine_batch(batch, 0.02, ds, tr, frame_len=5)
    torch.testing.assert_close(mu, mu5, rtol=0, atol=0)  # 3 states: W = 5
    with pytest.raises(NotImplementedError, match="item 15"):
        trefine.refine_batch(batch, 0.02, ds, tr, sharded=True)


def test_position_refinement_defaults_to_the_card(tracks):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run")
    with pytest.raises(RuntimeError, match="CUDA device"):
        trefine.position_refinement(tracks[0], 0.02, [0.02, 0.1],
                                    [0.5, 0.5], np.eye(2))
