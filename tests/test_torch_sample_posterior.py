"""The port's ``sample_posterior`` against the JAX package's, end to end.

The same 60 simulated tracks, model and start go to both packages' samplers
(float64 on the CPU); their chains draw from different generators, so the
posteriors are compared within Monte Carlo error.  Apart from
``tests/test_torch_sample.py`` because the two runs take about a minute
(the port's plain engine on the CPU, the JAX package's compiles).
"""
import numpy as np

from extrack_tpu import sample as jsample, simulate as jsim
from extrack_tpu_torch import sample as tsample
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)

SIM = dict(max_track_len=5, min_track_len=3, LocErr=0.02, Ds=(0.0, 0.08),
           TrMat=np.array([[0.9, 0.1], [0.1, 0.9]]), dt=0.02, pBL=0.05,
           cell_dims=(0.5, None, None))


def test_sample_posterior_matches_jax_posterior():
    """End to end on the same 60 tracks and start: the posterior mean and
    std of D1_minus_D0 agree with the JAX package's within 4 combined
    Monte Carlo errors (sd / sqrt(ESS) for the mean, sd / sqrt(2 ESS) for
    the std)."""
    tracks, _, _ = jsim.sim_fov(nb_tracks=60, seed=23, **SIM)
    kw = dict(nb_states=2, num_samples=100, num_warmup=40, num_chains=2,
              n_leapfrog=4, window=4, cell_dims=(0.5,), seed=3,
              max_buckets=1, dispatch_chunk=20)
    got = tsample.sample_posterior(tracks, 0.02, device="cpu", **kw)
    want = jsample.sample_posterior(tracks, 0.02, **kw)
    n = "D1_minus_D0"
    stats = []
    for r in (got, want):
        x = r.samples[n]
        assert x.shape == (2, 100) and np.isfinite(x).all()
        assert 0.3 < r.accept_rate <= 1.0
        stats.append((x.mean(), x.std(), r.ess[n]))
    (m1, s1, e1), (m2, s2, e2) = stats
    assert abs(m1 - m2) < 4 * np.hypot(s1 / np.sqrt(e1), s2 / np.sqrt(e2))
    assert abs(s1 - s2) < 4 * np.hypot(s1 / np.sqrt(2 * e1),
                                       s2 / np.sqrt(2 * e2))
