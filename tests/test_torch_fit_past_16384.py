"""The fit past 16384 register slots (up to 65536, at most 16384 fusion
groups), where the port's card runs K1, K2 and K3 on their wide mapping (K2
and K3 up to sixteen groups a thread, the exchange in global scratch) and
the JAX package its XLA engines: the port's CPU path (the plain engine,
float64) against the JAX package's XLA path (float64), on the same
simulated tracks and Parameters (the Hessian there is
tests/test_torch_fit_past_16384_hessian.py, a file of its own to keep each
under a minute).

* ``make_objective``'s value and z-gradient at 6 states, window 6 (K =
  46,656: the GUI's seeded Model Fitting frame_len at 6 states), with
  constant and per-track dt, and at 4 states, window 8 (K = 65,536):
  value rtol 1e-10, z-gradient 1e-8 of its largest entry;
* the host twins of K2's and K3's launch at 6^6 and 4^8 (``plan``,
  ``wide_layout``, ``grid`` under ``cuda_lib.scratch_budget``) on a
  model of an 80 GB card with 132 SMs, and ``check_envelope``'s message
  past the envelope;
* the GUI's seeded Model Fitting options at 6 states equal to the JAX
  package's, and inside K1's, K2's and K3's envelope.
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
from extrack_tpu_torch.ops import cuda_lib, forward_kernel, grad_kernel
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)

TOL_VALUE = 1e-10
TOL_GRAD = 1e-8
SMEM = 232448             # shared bytes a block may opt in to on an H100


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
OBJECTIVE_CASES = [(6, 6, 8, 4, False), (6, 6, 8, 4, True),
                   (4, 8, 6, 4, False)]


@pytest.mark.parametrize("S,W,nb,T,per_track_dt", OBJECTIVE_CASES)
def test_objective_past_16384_slots_matches_jax(S, W, nb, T, per_track_dt):
    K = S ** W
    assert 16384 < K <= forward_kernel.MAX_SLOTS["K2"]
    assert K // S <= forward_kernel.MAX_GROUPS["K2"]
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


def _card_budget(monkeypatch, K, card_bytes=80 * 10 ** 9, held=0):
    """``cuda_lib.scratch_budget`` at K slots on a model of a card with
    ``card_bytes`` this process could hold and ``held`` of them taken."""
    monkeypatch.setattr(cuda_lib, "_card_bytes", lambda index: card_bytes)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev: held)
    return cuda_lib.scratch_budget(torch.device("cuda", 0), K)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("D", [1, 2, 3])
def test_k2_k3_plans_past_16384_slots_fill_the_card(monkeypatch, D,
                                                    itemsize):
    # 6^6 (7776 groups) and 4^8 (16384 groups): the wide mapping in
    # clusters of C blocks (the smallest C at which a thread owns at most
    # two groups and a block's slice of the exchange fits an H100's
    # opt-in), as many clusters as the card keeps resident for 2^12
    # tracks of 2..40 frames under the fit's budget on an 80 GB card
    want = {(6, 4): (4, 8, 8), (6, 8): (8, 16, 16), (4, 4): (8, 8, 8),
            (4, 8): (8, 16, 16)}
    for S, W in ((6, 6), (4, 8)):
        K, A = S ** W, S
        G = K // A
        C = want[(S, itemsize)][D - 1]
        resident = 132 // C           # one block an SM
        budget = _card_budget(monkeypatch, K)
        assert budget == cuda_lib.WIDE_SCRATCH_BUDGET == 16 << 30
        for T in (2, 9, 20, 40):
            pl = grad_kernel.plan(K, A, D, T, SMEM, None, itemsize)
            assert pl == grad_kernel.Plan(grad_kernel.WIDE, False, C)
            lay = grad_kernel.wide_layout(K, A, D, T, C, False, itemsize)
            Gc = -(-G // C)
            assert lay.threads == min(1024, -(-Gc // 32) * 32)
            assert -(-Gc // lay.threads) <= grad_kernel.WIDE_GROUPS
            hist = max(T - 3, 0) * (2 * D + 1) * G
            assert lay.smem == (64 + (2 * D + 1) * Gc * A) * itemsize <= SMEM
            assert lay.scratch == hist * itemsize
            per = lay.scratch + grad_kernel.partial_bytes(K, A, itemsize)
            nblk, floats = grad_kernel.grid(1 << 12, T, D, K, pl, 132,
                                            resident, itemsize, A, budget)
            assert (nblk, floats * 4) == (resident * C,
                                          resident * lay.scratch)
            assert resident * per <= budget
            # one history and one partial row a cluster: the common cap
            # runs them all too (a cluster of 4^8 at T = 20, D = 3 takes
            # 26.6 MB as K3's dual numbers)
            assert grad_kernel.grid(1 << 12, T, D, K, pl, 132, resident,
                                    itemsize, A, cuda_lib.SCRATCH_BUDGET
                                    )[0] == resident * C
        # the card's free memory bounds the budget too: half of what is left
        held = 80 * 10 ** 9 - 10 * 2 ** 30
        assert _card_budget(monkeypatch, K, held=held) == 5 * 2 ** 30
    # below 16384 slots the budget stays the common one
    assert _card_budget(monkeypatch, 5 ** 6) == cuda_lib.SCRATCH_BUDGET
    assert _card_budget(monkeypatch, 16384) == cuda_lib.SCRATCH_BUDGET


def test_check_envelope_past_65536_slots_and_16384_groups():
    for kernel in ("K1", "K2", "K3"):
        for S, W in ((6, 6), (4, 8), (3, 9), (7, 5), (8, 5), (2, 15)):
            forward_kernel.check_envelope(20, 3, S, W, 1, kernel=kernel)
        with pytest.raises(NotImplementedError,
                           match=rf"bucket 3 \(T=20, D=2, S=7, window=6, "
                                 rf"nb_substeps=1\) .*K=S\*\*window=117649 > "
                                 rf"65536 register slots \({kernel} maps at "
                                 rf"most 65536.*largest window that fits "
                                 rf"is 5\)"):
            forward_kernel.check_envelope(20, 2, 7, 6, 1, what="bucket 3",
                                          kernel=kernel)
        with pytest.raises(NotImplementedError,
                           match=rf"K/A=32768 > 16384 fusion groups "
                                 rf"\({kernel} maps at most 16384, up to 16 "
                                 rf"a thread of 1024; the largest window "
                                 rf"that fits is 15\)"):
            forward_kernel.check_envelope(20, 2, 2, 16, 1, kernel=kernel)
        # two sub-steps halve the groups: 2^16 fits
        forward_kernel.check_envelope(20, 2, 2, 16, 2, kernel=kernel)


def test_gui_seeded_fit_options_at_6_states_are_jax_and_in_envelope():
    ts, js = tgui.Session(nb_states=6), jgui.Session(nb_states=6)
    got = tgui.seeded_options("Model Fitting", ts)
    assert got == jgui.seeded_options("Model Fitting", js)
    W = int(got["frame_len"])
    assert 6 ** W == 46656
    for kernel in ("K1", "K2", "K3"):
        forward_kernel.check_envelope(20, 2, 6, W, 1, what="the GUI's fit",
                                      kernel=kernel)
    with pytest.raises(NotImplementedError,
                       match="the GUI's fit.*K3 maps at most 65536.*window "
                             "that fits is 6"):
        forward_kernel.check_envelope(20, 2, 6, W + 1, 1,
                                      what="the GUI's fit", kernel="K3")
