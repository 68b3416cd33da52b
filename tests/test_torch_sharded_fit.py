"""The port's sharded fit (``fit.fit(sharded=...)``) on eight CPU shards:
against its unsharded fit at tests/test_sharded_fit.py's tolerances (logL
1e-8, parameters 1e-5), its standard errors against the unsharded ones
(1e-9), and against the JAX package's sharded fit on its 8-device mesh
(standard errors within 1e-3 relative)."""
import numpy as np

import jax

from extrack_tpu import data as jdata, fit as jfit, params as jparams, \
    simulate as jsim
from extrack_tpu_torch import data as tdata, fit as tfit, params as tparams
from extrack_tpu_torch.parallel import mesh as pmesh
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)

NAMES = ("D1", "p01", "LocErr")
ERR_NAMES = ("LocErr", "D0", "D1_minus_D0", "F0", "p01", "p10", "pBL")


def _tracks():
    tracks, _, _ = jsim.sim_fov(
        nb_tracks=200, max_track_len=9, min_track_len=3, LocErr=0.02,
        Ds=(0.0, 0.08), TrMat=np.array([[0.9, 0.1], [0.1, 0.9]]), dt=0.02,
        pBL=0.05, cell_dims=(0.5, None, None), seed=25)
    return tracks


def _spec(pkg):
    return pkg.generate_params(nb_states=2, LocErr_type=1, D_max=1.0,
                               estimated_Ds=[0.005, 0.05])


def test_sharded_fit_equals_unsharded_and_jax():
    assert len(jax.devices()) == 8
    tracks = _tracks()
    kw = dict(cell_dims=(0.5,), window=3, max_iter=40, compute_errors=True)

    def run(sharded):
        batches = tdata.from_dict_bucketed(tracks, max_buckets=2,
                                           device="cpu")
        return tfit.fit(batches, _spec(tparams), 0.02, 2, sharded=sharded,
                        **kw)

    r1 = run(False)
    r8 = run(pmesh.make_mesh(devices=["cpu"] * 8))
    np.testing.assert_allclose(r8.logl, r1.logl, rtol=1e-8)
    for name in NAMES:
        np.testing.assert_allclose(r8.params[name].value,
                                   r1.params[name].value, rtol=1e-5)
    assert set(r8.std_errors) == set(ERR_NAMES)
    for name in ERR_NAMES:
        np.testing.assert_allclose(r8.std_errors[name],
                                   r1.std_errors[name], rtol=1e-9)

    jr = jfit.fit(jdata.from_dict_bucketed(tracks, max_buckets=2),
                  _spec(jparams), 0.02, 2, sharded=True, **kw)
    np.testing.assert_allclose(r8.logl, jr.logl, rtol=1e-8)
    for name in NAMES:
        np.testing.assert_allclose(r8.params[name].value,
                                   jr.params[name].value, rtol=1e-5)
    for name in ERR_NAMES:
        np.testing.assert_allclose(r8.std_errors[name],
                                   jr.std_errors[name], rtol=1e-3)


def test_sharded_hessian_equals_unsharded():
    """hessian_hvp_exact(sharded=...) sums each shard's K3 columns (the
    plain double backward on the CPU): the unsharded Hessian at 1e-10."""
    tracks = _tracks()
    batches = tdata.from_dict_bucketed(tracks, max_buckets=2, device="cpu")
    spec = _spec(tparams)
    z = spec.to_unconstrained()
    kw = dict(cell_dims=(0.5,), window=3, min_len=3)
    H1 = tfit.hessian_hvp_exact(batches, spec, z, 0.02, 2, **kw)
    H8 = tfit.hessian_hvp_exact(batches, spec, z, 0.02, 2,
                                sharded=pmesh.make_mesh(
                                    devices=["cpu"] * 8), **kw)
    np.testing.assert_allclose(H8, H1, rtol=1e-10, atol=1e-8)
    np.testing.assert_array_equal(H8, H8.T)
