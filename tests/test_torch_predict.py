"""The port's posteriors (the plain version of K4 and ``predict_Bs``)
against the JAX package's.

Tolerances, float64 on the CPU: 1e-10 on per-track logL and per-frame
posteriors against extrack_tpu.core.engine (the same recursion summed in
another order); 1e-9 on predict_Bs's dict (the port length-buckets, the
JAX predict_Bs runs one padded batch; per track the arithmetic is the
same).

The CUDA kernel K4 itself is checked against its plain version in
tests/test_torch_cuda.py (needs a GPU).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from extrack_tpu import predict as jpredict, simulate as jsim
from extrack_tpu.core import engine as jengine, tables as jtables
from extrack_tpu_torch import data as tdata, params as tparams
from extrack_tpu_torch import predict as tpredict
from extrack_tpu_torch.core import engine as tengine, tables as ttables
from extrack_tpu_torch.ops import predict_kernel
from extrack_tpu_torch.parallel import mesh as pmesh
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)


def _case(seed, S, B, T, per_peak, bl):
    rng = np.random.default_rng(seed)
    xs = rng.normal(0, 0.06, (B, T, 2)).cumsum(1)
    lengths = rng.integers(0, T + 1, B)
    lengths[:3] = (T, min(2, T), 1)
    lengths[-1] = 0                                     # padded row
    isbl = (rng.random(B) < 0.5).astype(float) * bl
    rates = rng.uniform(0.03, 0.25, (S, S))
    rates[1, 0] = 0.0                                   # forbidden
    loc = (rng.uniform(0.01, 0.03, (B, T, 2)) if per_peak
           else np.float64(0.02))
    jt = jtables.build_tables(
        jnp.asarray(np.linspace(0.0, 0.15, S)), jnp.asarray(loc),
        jnp.asarray(rng.dirichlet(np.ones(S))), jnp.asarray(rates),
        jnp.asarray(0.08), jnp.asarray(0.02), cell_dims=(0.6,))
    tt = ttables.tables_from_numpy(
        {f: np.asarray(getattr(jt, f)) for f in jt._fields}, "cpu",
        torch.float64)
    return xs, lengths, isbl, jt, tt


@pytest.mark.parametrize("S,W,T,per_peak,bl", [
    (2, 5, 9, False, 1.0),
    (2, 4, 8, True, 1.0),        # per-peak LocErr
    (3, 3, 7, False, 0.0),       # isBL off
    (2, 3, 2, True, 1.0),        # T = 2: every track closes at t = 1
    (2, 6, 4, False, 1.0),       # window wider than the tracks
    (5, 5, 8, False, 1.0),       # predict_Bs' default at 5 states: K =
                                 # 3125, K4's wide mapping on the card
])
def test_engine_posteriors_match_jax(S, W, T, per_peak, bl):
    xs, lengths, isbl, jt, tt = _case(S * 10 + W + T, S, 11, T, per_peak, bl)
    l_ref, p_ref = jengine.forward(jnp.asarray(xs), jnp.asarray(lengths),
                                   jnp.asarray(isbl), jt, window=W,
                                   min_len=3, return_preds=True)
    args = (torch.tensor(xs), torch.tensor(lengths), torch.tensor(isbl), tt)
    plain = predict_kernel.PLAIN_CALLS, predict_kernel.LAUNCHES
    logl, preds = predict_kernel.predict(*args, window=W, min_len=3)
    # CPU tensors take the plain version, never the kernel
    assert (predict_kernel.PLAIN_CALLS, predict_kernel.LAUNCHES) == (
        plain[0] + 1, plain[1])
    assert preds.shape == (11, T, S) and preds.dtype == torch.float64
    np.testing.assert_allclose(logl.numpy(), np.asarray(l_ref), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(preds.numpy(), np.asarray(p_ref), rtol=1e-10,
                               atol=1e-10)
    # the likelihood is the engine's own
    np.testing.assert_allclose(
        logl.numpy(), tengine.forward(*args, window=W, min_len=3).numpy(),
        rtol=1e-12, atol=1e-12)
    # normalized on valid frames, zero on padding and 0/1-frame rows
    valid = np.arange(T)[None, :] < lengths[:, None]
    valid &= (lengths >= 2)[:, None]
    sums = preds.sum(-1).numpy()
    np.testing.assert_allclose(sums[valid], 1.0, atol=1e-10)
    assert np.all(sums[~valid] == 0.0)
    assert np.all(logl.numpy()[lengths < 2] == 0.0)


def test_posteriors_need_one_substep():
    xs, lengths, isbl, _, tt = _case(1, 2, 4, 5, False, 1.0)
    with pytest.raises(ValueError, match="nb_substeps"):
        tengine.forward(torch.tensor(xs), torch.tensor(lengths),
                        torch.tensor(isbl), tt, window=4, nb_substeps=2,
                        return_preds=True)


@pytest.fixture(scope="module")
def sim():
    tracks, _, _ = jsim.sim_fov(
        nb_tracks=120, max_track_len=9, min_track_len=2, LocErr=0.02,
        Ds=(0.0, 0.08), dt=0.02, pBL=0.1, cell_dims=(0.5, None, None),
        seed=7)
    values = {"LocErr": 0.021, "D0": 0.001, "D1": 0.07, "F0": 0.45,
              "F1": 0.55, "p01": 0.08, "p10": 0.12, "pBL": 0.09}
    return tracks, values


def test_predict_Bs_matches_jax(sim):
    tracks, values = sim
    want = jpredict.predict_Bs(tracks, 0.02, values, cell_dims=(0.5,),
                               nb_states=2, frame_len=4)
    got = tpredict.predict_Bs(tracks, 0.02, values, cell_dims=(0.5,),
                              nb_states=2, frame_len=4, device="cpu")
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape == (len(tracks[k]), int(k), 2)
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-9,
                                   atol=1e-9)
        np.testing.assert_allclose(got[k].sum(-1), 1.0, atol=1e-9)


def test_predict_Bs_five_states_at_the_default_frame_len_matches_jax():
    """predict_Bs at 5 states and its default frame_len 5 (K = 3125: the
    card runs K4's wide mapping), on the CPU against JAX's."""
    S = 5
    tr = np.full((S, S), 0.03) + np.eye(S) * (1 - 0.03 * S)
    Ds = (0.0, 0.01, 0.03, 0.06, 0.1)
    tracks, _, _ = jsim.sim_fov(
        nb_tracks=16, max_track_len=8, min_track_len=2, LocErr=0.02, Ds=Ds,
        TrMat=tr, dt=0.02, pBL=0.1, cell_dims=(0.5, None, None), seed=9)
    values = {"LocErr": 0.02, "pBL": 0.1,
              **{f"D{i}": d for i, d in enumerate(Ds)},
              **{f"F{i}": 1 / S for i in range(S)},
              **{f"p{i}{j}": 0.03 for i in range(S) for j in range(S)
                 if i != j}}
    want = jpredict.predict_Bs(tracks, 0.02, values, cell_dims=(0.5,),
                               nb_states=S)
    got = tpredict.predict_Bs(tracks, 0.02, values, cell_dims=(0.5,),
                              nb_states=S, device="cpu")
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape == (len(tracks[k]), int(k), S)
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-9,
                                   atol=1e-9)


def test_predict_Bs_six_states_at_the_default_frame_len_matches_jax():
    """predict_Bs at 6 states and its default frame_len 5 (K = 6^5 = 7776,
    past 4096 slots: the card runs K4's wide mapping), on the CPU against
    JAX's; each frame's posteriors sum to one."""
    S = 6
    tr = np.full((S, S), 0.03) + np.eye(S) * (1 - 0.03 * S)
    Ds = (0.0, 0.01, 0.02, 0.04, 0.07, 0.1)
    tracks, _, _ = jsim.sim_fov(
        nb_tracks=8, max_track_len=8, min_track_len=2, LocErr=0.02, Ds=Ds,
        TrMat=tr, dt=0.02, pBL=0.1, cell_dims=(0.5, None, None), seed=11)
    values = {"LocErr": 0.02, "pBL": 0.1,
              **{f"D{i}": d for i, d in enumerate(Ds)},
              **{f"F{i}": 1 / S for i in range(S)},
              **{f"p{i}{j}": 0.03 for i in range(S) for j in range(S)
                 if i != j}}
    want = jpredict.predict_Bs(tracks, 0.02, values, cell_dims=(0.5,),
                               nb_states=S)
    got = tpredict.predict_Bs(tracks, 0.02, values, cell_dims=(0.5,),
                              nb_states=S, device="cpu")
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape == (len(tracks[k]), int(k), S)
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-9,
                                   atol=1e-9)
        np.testing.assert_allclose(got[k].sum(-1), 1.0, rtol=1e-10)


def test_predict_Bs_past_16384_slots_matches_jax():
    """predict_Bs past 16384 slots (2 states at frame_len 15: K = 2^15,
    K4's wide mapping with its carries in global scratch on the card), on
    the CPU against JAX's (its XLA engine, past the TPU kernel's VMEM
    budget); each frame's posteriors sum to one."""
    rng = np.random.default_rng(16)
    tracks = {str(T): (rng.normal(0, 0.05, (2, T, 2)).cumsum(1)
                       + rng.normal(0, 0.02, (2, T, 2)))
              for T in (16, 17)}
    values = {"LocErr": 0.02, "D0": 0.0, "D1": 0.08, "F0": 0.4, "F1": 0.6,
              "p01": 0.1, "p10": 0.05, "pBL": 0.1}
    want = jpredict.predict_Bs(tracks, 0.02, values, cell_dims=(0.5,),
                               nb_states=2, frame_len=15)
    got = tpredict.predict_Bs(tracks, 0.02, values, cell_dims=(0.5,),
                              nb_states=2, frame_len=15, device="cpu")
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape == (2, int(k), 2)
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-9,
                                   atol=1e-9)
        np.testing.assert_allclose(got[k].sum(-1), 1.0, rtol=1e-10)


def test_k4_envelope_and_plan_past_16384_slots():
    """K4 takes registers up to 65536 slots: predict_Bs at 7 states W=5
    (16807) and 6 states W=6 (46656), the GUI's labeling at 3 states W=10
    (59049), 4 states W=8 and 2 states W=16 (65536); past it the bucket
    raises, naming K4, 65536 and the largest frame_len that fits.  At
    59049 slots the plan is the wide mapping with its carries in global
    scratch."""
    from extrack_tpu_torch.ops import forward_kernel
    from tests.test_torch_forward import SMEM, _wide_walk_bytes
    for S, W in ((7, 5), (6, 6), (3, 10), (4, 8), (2, 16)):
        forward_kernel.check_envelope(20, 2, S, W, 1, kernel="K4",
                                      what="predict_Bs bucket 0")
    for S, W, fits in ((3, 11, 10), (7, 6, 5), (2, 17, 16)):
        with pytest.raises(NotImplementedError,
                           match=(rf"bucket 3 .*K=S\*\*window={S ** W} > "
                                  rf"65536 register slots \(K4 maps at most "
                                  rf"65536.*window that fits is {fits}")):
            forward_kernel.check_envelope(20, 2, S, W, 1, kernel="K4",
                                          what="predict_Bs bucket 3")
    K = 3 ** 10
    fixed, stash, _ = _wide_walk_bytes(K, 3, 3, 2, 20, 10, True)
    pl = forward_kernel.plan("K4", K, fixed, stash, SMEM,
                             lambda warps, smem: 1)
    assert pl == forward_kernel.Plan(forward_kernel.WIDE_GLOBAL, False)


def test_predict_batch_chunks_and_parameters(sim):
    tracks, values = sim
    spec = tparams.generate_params(nb_states=2, D_max=1.0)
    spec.set_values(values)
    batch = tdata.from_dict(tracks, device="cpu")
    logl, preds = tpredict.predict_batch(batch, spec, 0.02, 2,
                                         cell_dims=(0.5,), window=4)
    logl_c, preds_c = tpredict.predict_batch(batch, spec.resolve(), 0.02, 2,
                                             cell_dims=(0.5,), window=4,
                                             chunk_size=37)
    torch.testing.assert_close(logl_c, logl, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(preds_c, preds, rtol=1e-12, atol=1e-12)
    # sharded: one CPU shard bit for bit, three shards within rounding
    logl_s, preds_s = tpredict.predict_batch(batch, spec, 0.02, 2,
                                             cell_dims=(0.5,), window=4,
                                             sharded=True)
    assert torch.equal(logl_s, logl) and torch.equal(preds_s, preds)
    logl_s, preds_s = tpredict.predict_batch(
        batch, spec, 0.02, 2, cell_dims=(0.5,), window=4,
        sharded=pmesh.make_mesh(devices=["cpu"] * 3))
    torch.testing.assert_close(logl_s, logl, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(preds_s, preds, rtol=1e-12, atol=1e-12)


def test_predict_Bs_defaults_to_the_card(sim):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run")
    with pytest.raises(RuntimeError, match="CUDA device"):
        tpredict.predict_Bs(sim[0], 0.02, sim[1], cell_dims=(0.5,))
