"""The fit past 1024 register slots, where the port's card runs K2 and K3
on their wide mapping and the JAX package its XLA engines: the port's CPU
path (the plain engine, float64) against the JAX package's XLA path
(float64), on the same simulated tracks and Parameters.

* ``make_objective``'s value and z-gradient at 4 states, window 6 (K =
  4096: the GUI's seeded Model Fitting frame_len) and at 3 states, window
  7 (K = 2187), with constant and per-track dt: value rtol 1e-10,
  z-gradient 1e-8 of its largest entry (both engines sum the same
  recursion in float64; the parameter chain adds round-off);
* ``hessian_hvp_exact`` at 2 states, window 11, two sub-steps (K = 2048)
  against the JAX package's ``hessian_hvp_exact`` on its XLA route
  (``pallas_flags`` False: ``hessian_chunked``, where the TPU's VMEM
  budget sends such buckets), rtol 5e-3 and atol 1e-3 of max|H|
  (tests/test_hvp.py's);
* the GUI's seeded Model Fitting options at 4 states equal to the JAX
  package's, and inside K2's and K3's envelope (frame_len 8 passes it).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from extrack_tpu import data as jdata, fit as jfit, gui as jgui
from extrack_tpu import params as jparams, simulate as jsim
from extrack_tpu_torch import data as tdata, fit as tfit, gui as tgui
from extrack_tpu_torch import params as tparams
from extrack_tpu_torch.ops import forward_kernel
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)

TOL_VALUE = 1e-10
TOL_GRAD = 1e-8
TOL_H = dict(rtol=5e-3, atol=1e-3)


def _tracks(S, nb_tracks, T, seed):
    tr = np.full((S, S), 0.1 / (S - 1)) + np.eye(S) * (0.9 - 0.1 / (S - 1))
    tracks, _, _ = jsim.sim_fov(
        nb_tracks=nb_tracks, max_track_len=T, min_track_len=2, LocErr=0.02,
        Ds=tuple(np.linspace(0.0, 0.1, S)), TrMat=tr, dt=0.02, pBL=0.1,
        cell_dims=(0.5, None, None), seed=seed)
    return tracks


def _specs(S, **kw):
    jspec = jparams.generate_params(nb_states=S, D_max=1.0, **kw)
    tspec = tparams.Parameters.from_records(
        [(p.name, p.value, p.min, p.max, p.vary, p.expr)
         for p in jspec._params.values()])
    return jspec, tspec


# (states, window, tracks requested, longest track, per-track dt)
OBJECTIVE_CASES = [(4, 6, 40, 8, False), (4, 6, 40, 8, True),
                   (3, 7, 40, 8, False), (3, 7, 40, 8, True)]


@pytest.mark.parametrize("S,W,nb,T,per_track_dt", OBJECTIVE_CASES)
def test_objective_past_1024_slots_matches_jax(S, W, nb, T, per_track_dt):
    assert 1024 < S ** W <= forward_kernel.MAX_SLOTS["K2"]
    tracks = _tracks(S, nb, T, seed=10 * S + W)
    dts = None
    if per_track_dt:
        rng = np.random.default_rng(S)
        dts = {k: rng.uniform(0.015, 0.03, (v.shape[0], v.shape[1] - 1))
               for k, v in tracks.items()}
    jspec, tspec = _specs(S)
    jb = jdata.from_dict_bucketed(tracks, max_buckets=1, dt=dts)
    tb = tdata.from_dict_bucketed(tracks, max_buckets=1, dt=dts,
                                  device="cpu", dtype=torch.float64)
    kw = dict(cell_dims=(0.5,), window=W, min_len=2)
    jo = jfit.make_objective(jb, jspec, 0.02, S, compute_engine="xla", **kw)
    to = tfit.make_objective(tb, tspec, 0.02, S, **kw)
    z0 = jspec.to_unconstrained() + np.random.default_rng(W).normal(
        0, 0.2, len(jspec.free_names()))
    v_ref, g_ref = jax.value_and_grad(jo)(jnp.asarray(z0))
    z = torch.tensor(z0, requires_grad=True)
    v = to(z)
    (g,) = torch.autograd.grad(v, z)
    np.testing.assert_allclose(float(v.detach()), float(v_ref),
                               rtol=TOL_VALUE)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=TOL_GRAD,
                               atol=TOL_GRAD * float(np.abs(g_ref).max()))


def test_hessian_past_1024_slots_matches_jax():
    # 2 states, two sub-steps a frame, window 11: K = 2^11, A = 4
    tracks = _tracks(2, 16, 6, seed=31)
    jspec, tspec = _specs(2, estimated_Ds=[0.001, 0.05])
    jb = jdata.from_dict_bucketed(tracks, max_buckets=1)
    tb = tdata.from_dict_bucketed(tracks, max_buckets=1, device="cpu",
                                  dtype=torch.float64)
    kw = dict(cell_dims=(0.5,), nb_substeps=2, window=11, min_len=2)
    z = jspec.to_unconstrained() + np.random.default_rng(5).normal(
        0, 0.2, len(jspec.free_names()))
    H_ref = jfit.hessian_hvp_exact(jb, jspec, z, 0.02, 2,
                                   pallas_flags=[False] * len(jb), **kw)
    H = tfit.hessian_hvp_exact(tb, tspec, z, 0.02, 2, **kw)
    scale = float(np.abs(H_ref).max())
    np.testing.assert_allclose(H, H_ref, rtol=TOL_H["rtol"],
                               atol=TOL_H["atol"] * scale)


def test_gui_seeded_fit_options_at_4_states_are_jax_and_in_envelope():
    ts, js = tgui.Session(nb_states=4), jgui.Session(nb_states=4)
    got = tgui.seeded_options("Model Fitting", ts)
    assert got == jgui.seeded_options("Model Fitting", js)
    W = int(got["frame_len"])
    assert 4 ** W == 4096
    for kernel in ("K2", "K3"):
        forward_kernel.check_envelope(20, 2, 4, W, 1, what="the GUI's fit",
                                      kernel=kernel)
    with pytest.raises(NotImplementedError,
                       match="the GUI's fit.*K2 maps at most 65536.*window "
                             "that fits is 8"):
        forward_kernel.check_envelope(20, 2, 4, W + 3, 1,
                                      what="the GUI's fit", kernel="K2")
