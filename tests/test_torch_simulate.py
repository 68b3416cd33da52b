"""The port's simulators against the JAX package's.

The numpy helpers (``sim_nobias`` / ``sim_noBias``, ``markovian_process``,
``get_fractions_from_TrMat``, ``is_in_FOV``) draw from
``numpy.random.default_rng``: for the same seed they must give the JAX
package's output bit for bit.  The device simulators (``sim_fov_batch``,
``brownian_frames``) draw from a ``torch.Generator``, so they are held to
the distributions, with the tolerances of ``tests/test_simulate_device.py``:
against the host ``sim_fov`` (yield, length histogram, state-conditional
displacement variance, per-peak sigma moments) and against the JAX
package's ``sim_fov_batch`` on the same model, run on the CPU.
"""
import numpy as np
import pytest
import torch

import jax

from extrack_tpu import simulate as jsim
from extrack_tpu_torch import simulate as tsim
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)

TR = np.array([[0.9, 0.1], [0.1, 0.9]])
KW = dict(nb_tracks=12000, max_track_len=12, min_track_len=3, LocErr=0.02,
          Ds=(0.0, 0.08), TrMat=TR, dt=0.02, pBL=0.05,
          cell_dims=(0.5, None, None))
# the displacement-variance draw: more tracks, less bleaching and noise
VAR_KW = dict(KW, nb_tracks=20000, pBL=0.02, LocErr=0.005)


# ---- numpy helpers: bit-identical for the same seed ----------------------

def test_sim_nobias_matches_jax_bit_for_bit():
    kw = dict(track_lengths=(3, 6), track_nb_dist=(50, 20), LocErr=0.03,
              Ds=(0.0, 0.1), dt=0.03, nb_dims=3, nb_sub_steps=5, seed=11)
    for jf, tf in ((jsim.sim_nobias, tsim.sim_nobias),
                   (jsim.sim_noBias, tsim.sim_noBias)):
        want, got = jf(**kw), tf(**kw)
        for w, g in zip(want, got):
            assert sorted(w) == sorted(g)
            for k in w:
                assert w[k].dtype == g[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
    assert tsim.sim_noBias is tsim.sim_nobias


def test_numpy_helpers_match_jax_bit_for_bit():
    tr3 = np.array([[0.8, 0.15, 0.05], [0.1, 0.7, 0.2], [0.3, 0.3, 0.4]])
    np.testing.assert_array_equal(tsim.get_fractions_from_TrMat(tr3),
                                  jsim.get_fractions_from_TrMat(tr3))
    # under-normalized fractions: the remainder goes to the last state
    for fr in (tsim.get_fractions_from_TrMat(tr3), [0.3, 0.3, 0.3]):
        got = tsim.markovian_process(tr3, fr, 200, 9, seed=4)
        want = jsim.markovian_process(tr3, fr, 200, 9, seed=4)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    pos = np.random.default_rng(1).uniform(-0.2, 0.7, (40, 3))
    for cell in ((0.5, None, None), (0.5, 0.4, None), (None, None, None)):
        np.testing.assert_array_equal(tsim.is_in_FOV(pos, cell),
                                      jsim.is_in_FOV(pos, cell))


# ---- the device simulator, on the CPU -----------------------------------

def _device(seed=7, **over):
    batches, states = tsim.sim_fov_batch(seed=seed, device="cpu",
                                         **{**KW, **over})
    lens = np.concatenate([b.lengths.numpy() for b in batches])
    return batches, states, lens


def _jax_device(seed=7, **over):
    batches, states = jsim.sim_fov_batch(seed=seed, **{**KW, **over})
    lens = np.concatenate([np.asarray(b.lengths) for b in batches])
    return batches, states, lens


@pytest.fixture(scope="module")
def draws():
    """The port's and the JAX package's device draws and the host one of
    KW (the JAX package's with a 3-tuple of cells, which it needs)."""
    return _device(), _jax_device(), tsim.sim_fov(seed=8, **KW)[0]


def _check_yield(lens, tracks):
    n_host = sum(len(v) for v in tracks.values())
    mean_host = np.average([int(k) for k in tracks],
                           weights=[len(v) for v in tracks.values()])
    assert abs(len(lens) - n_host) / n_host < 0.05
    assert abs(lens.mean() - mean_host) / mean_host < 0.03
    # per-length histogram within 15% on the populous lengths
    for L, v in tracks.items():
        if len(v) < 400:
            continue
        c_dev = int((lens == int(L)).sum())
        assert abs(c_dev - len(v)) / len(v) < 0.15, (L, c_dev, len(v))


def test_yield_and_length_distribution_match_host_and_jax(draws):
    (_, _, lens), (jb, _, jlens), tracks = draws
    _check_yield(lens, tracks)
    # and the JAX package's device simulator, by the same measures
    _check_yield(lens, {str(L): np.empty(int((jlens == L).sum()))
                        for L in np.unique(jlens)})


def test_batch_invariants(draws):
    batches, states, lens = draws[0]
    assert (lens >= KW["min_track_len"]).all()
    data_max = lens.max()
    assert [b.max_len for b in batches] == sorted(
        (b.max_len for b in batches), reverse=True)
    for b, s in zip(batches, states):
        le = b.lengths.numpy()
        assert b.lengths.dtype == torch.int32 and s.dtype == torch.int8
        assert b.positions.dtype == torch.float64      # the CPU's default
        np.testing.assert_array_equal(b.np_lengths, le)
        assert le.max() == b.max_len and (np.diff(le) <= 0).all()
        t = np.arange(b.max_len)[None, :]
        valid = t < le[:, None]
        # padding is zeroed, the bleach flag follows the length convention
        assert np.all(b.positions.numpy()[~valid] == 0.0)
        np.testing.assert_array_equal(b.is_bleached.numpy(),
                                      (le < data_max).astype(float))
        # the bounded x-dim stays inside the FOV up to localization noise
        x = b.positions.numpy()[..., 0]
        assert x[valid].min() > -0.2 and x[valid].max() < 0.7
        assert tuple(s.shape) == (b.batch_size, b.max_len)
        assert set(np.unique(s.numpy()[valid])) <= {0, 1}
        assert b.loc_err is None
    # a seed gives the same draw; float32 on request
    again, _ = tsim.sim_fov_batch(seed=7, device="cpu",
                                  dtype=torch.float32, **KW)
    for a, b in zip(again, batches):
        assert a.positions.dtype == torch.float32
        np.testing.assert_array_equal(a.positions.numpy(),
                                      b.positions.numpy().astype(np.float32))
    # bounded axes may be left out, as in sim_fov
    short, _ = tsim.sim_fov_batch(seed=7, device="cpu",
                                  **dict(KW, cell_dims=(0.5,)))
    assert all(np.array_equal(a.positions.numpy(), b.positions.numpy())
               for a, b in zip(short, batches))


def test_sim_fov_batch_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsim.sim_fov_batch(nb_tracks=10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsim.brownian_frames(None, 10, 5, (0.0, 0.1), (0.5, 0.5), TR,
                             0.02, 0.02)
    with pytest.raises(ValueError, match="no tracks survived"):
        tsim.sim_fov_batch(nb_tracks=5, max_track_len=3, min_track_len=3,
                           pBL=0.99, seed=0, device="cpu")


def _state_step_var(tracks_by_len, states_by_len):
    """Mean squared per-dim displacement for steps whose endpoints share a
    state.  Includes the simulator's real selection effects (mid-frame
    state excursions, FOV survival bias), so it is comparable across
    simulators."""
    d2 = {0: [], 1: []}
    for pos, st in zip(tracks_by_len, states_by_len):
        dx = pos[:, 1:] - pos[:, :-1]
        for k in (0, 1):
            m = (st[:, :-1] == k) & (st[:, 1:] == k)
            d2[k].append((dx[m] ** 2).ravel())
    return {k: np.concatenate(v).mean() for k, v in d2.items()}


def _masked_states(batches, states):
    # padded frames' states become -1, so no step touching padding matches
    # either state
    return [np.where(np.arange(s.shape[1])[None, :]
                     < np.asarray(b.lengths)[:, None], np.asarray(s), -1)
            for b, s in zip(batches, states)]


def test_state_conditional_displacement_variance_matches_host_and_jax():
    batches, states, _ = _device(**VAR_KW)
    dev = _state_step_var([b.positions.numpy() for b in batches],
                          _masked_states(batches, states))
    tracks, stt, _ = tsim.sim_fov(seed=5, **VAR_KW)
    host = _state_step_var([tracks[k] for k in tracks],
                           [stt[k] for k in tracks])
    jb, js, _ = _jax_device(**VAR_KW)
    jdev = _state_step_var([np.asarray(b.positions) for b in jb],
                           _masked_states(jb, js))
    for k in (0, 1):
        assert abs(dev[k] - host[k]) / host[k] < 0.05, (k, dev[k], host[k])
        assert abs(dev[k] - jdev[k]) / jdev[k] < 0.05, (k, dev[k], jdev[k])


def test_per_peak_sigmas_match_host_and_jax():
    def valid_sigmas(batches):
        vals = []
        for b in batches:
            sig = np.asarray(b.loc_err)
            valid = (np.arange(b.max_len)[None, :, None]
                     < np.asarray(b.lengths)[:, None, None])
            vals.append(sig[np.broadcast_to(valid, sig.shape)])
        return np.concatenate(vals)

    v = valid_sigmas(_device(LocErr_std=0.007)[0])
    _, _, hs = tsim.sim_fov(seed=8, LocErr_std=0.007, **KW)
    hv = np.concatenate([x.ravel() for x in hs.values()])
    jv = valid_sigmas(_jax_device(LocErr_std=0.007)[0])
    # chi-square(k=2/std^2) scaled to mean LocErr: same mean AND dispersion
    for ref in (hv, jv):
        assert abs(v.mean() - ref.mean()) / ref.mean() < 0.01
        assert abs(v.std() - ref.std()) / ref.std() < 0.10
    assert v.std() > 0  # actually dispersed, not a constant


@pytest.mark.parametrize("a", [0.4, 3.5, 20408.0])
def test_gamma_draws_have_gamma_moments(a):
    """The Marsaglia-Tsang sampler behind the chi-square sigmas (shape
    20408 is LocErr_std = 0.007's): mean a and variance a, within five
    standard errors of 2^16 draws."""
    g = torch.Generator()
    g.manual_seed(3)
    n = 1 << 16
    x = tsim._gamma(g, a, n, "cpu").numpy()
    assert (x > 0).all()
    assert abs(x.mean() - a) < 5 * np.sqrt(a / n)
    # var of the sample variance of a gamma: (2a^2 + 6a) / n
    assert abs(x.var() - a) < 5 * np.sqrt((2 * a * a + 6 * a) / n)


def test_brownian_frames_moments_match_jax():
    """Stationary state occupancy, transition frequency and the per-step
    displacement variance by the states at both ends, against the JAX
    generator's draws and the model's values."""
    Ds, Fs, loc, dt, B, T = (0.0, 0.1), (0.3, 0.7), 0.02, 0.03, 20000, 8
    tr = np.array([[0.8, 0.2], [1 / 7 * 0.6, 1 - 1 / 7 * 0.6]])
    g = torch.Generator()
    g.manual_seed(0)
    x, s = tsim.brownian_frames(g, B, T, Ds, Fs, tr, loc, dt, device="cpu")
    jx, js = jsim.brownian_frames(jax.random.PRNGKey(0), B, T, Ds, Fs, tr,
                                  loc, dt)
    assert tuple(x.shape) == (B, T, 2) and s.dtype == torch.int32
    assert x.dtype == torch.float64

    def moments(x, s):
        x, s = np.asarray(x), np.asarray(s)
        dx2 = ((x[:, 1:] - x[:, :-1]) ** 2).mean(-1)
        d2 = 2.0 * np.asarray(Ds) * dt
        want = (d2[s[:, :-1]] + d2[s[:, 1:]]) / 2 + 2 * loc ** 2
        return (s.mean(), (s[:, 1:] != s[:, :-1]).mean(),
                dx2.mean() / want.mean())

    got, ref = moments(x, s), moments(jx, js)
    assert abs(got[0] - 0.7) < 0.01 and abs(ref[0] - 0.7) < 0.01
    # P(switch) = 0.3 * 0.2 + 0.7 * 0.6 / 7
    assert abs(got[1] - 0.12) < 0.005 and abs(ref[1] - 0.12) < 0.005
    assert abs(got[2] - 1.0) < 0.02 and abs(ref[2] - 1.0) < 0.02
