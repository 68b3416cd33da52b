"""The Hessian past 16384 register slots: ``hessian_hvp_exact`` at 2
states, window 15 (K = 32,768, 16,384 fusion groups: sixteen a thread of
K3's deep kernel on the card), the port's CPU path (double backward of the
plain engine, float64) against the JAX package's ``hessian_hvp_exact`` on
its XLA route (``pallas_flags`` False: ``hessian_chunked``), rtol 5e-3 and
atol 1e-3 of max|H| (tests/test_hvp.py's).
"""
import numpy as np
import torch

from extrack_tpu import data as jdata, fit as jfit
from extrack_tpu_torch import data as tdata, fit as tfit
from tests.test_torch_fit_past_16384 import _specs, _tracks
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)

TOL_H = dict(rtol=5e-3, atol=1e-3)


def test_hessian_at_32768_slots_matches_jax():
    # 2 states, window 15: K = 2^15, A = 2, 16384 fusion groups
    tracks = _tracks(2, 8, 4, seed=43)
    jspec, tspec = _specs(2, estimated_Ds=[0.001, 0.05])
    jb = jdata.from_dict_bucketed(tracks, max_buckets=1)
    tb = tdata.from_dict_bucketed(tracks, max_buckets=1, device="cpu",
                                  dtype=torch.float64)
    kw = dict(cell_dims=(0.5,), window=15, min_len=2)
    z = jspec.to_unconstrained() + np.random.default_rng(9).normal(
        0, 0.2, len(jspec.free_names()))
    H_ref = jfit.hessian_hvp_exact(jb, jspec, z, 0.02, 2,
                                   pallas_flags=[False] * len(jb), **kw)
    H = tfit.hessian_hvp_exact(tb, tspec, z, 0.02, 2, **kw)
    scale = float(np.abs(H_ref).max())
    np.testing.assert_allclose(H, H_ref, rtol=TOL_H["rtol"],
                               atol=TOL_H["atol"] * scale)
