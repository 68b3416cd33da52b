"""Variable dt in the port: the streamed displacement-variance table that
the CUDA kernels K1..K5 read, and the fit, Hessian and annotation drivers
on variable dt, against the JAX package.

The same inputs (numpy, fixed seeds) go to both packages on the CPU, in
float64 on the port's side (the stream itself is float32, as the kernels
read it).  Tolerances: the stream and its index maps exactly; the
objective's value and z-gradient rtol 1e-8 (both sides run the same
engine); the Hessian columns rtol 5e-3 / atol 1e-3 max|H| (as
tests/test_hvp.py holds the TPU kernel); the posteriors 1e-8.  The kernels
themselves are held to their plain versions with variable dt in
tests/test_torch_cuda.py (needs a GPU).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from extrack_tpu import data as jdata, fit as jfit, params as jparams
from extrack_tpu import predict as jpredict, simulate as jsim
from extrack_tpu.core import tables as jtables
from extrack_tpu.ops import pallas_engine
from extrack_tpu_torch import data as tdata, fit as tfit, params as tparams
from extrack_tpu_torch import predict as tpredict
from extrack_tpu_torch.core import engine as tengine, tables as ttables
from extrack_tpu_torch.ops import forward_kernel, topk_kernel
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)


@pytest.mark.parametrize("shape", [(9, 4), (6, 9, 4), (7, 1, 8)],
                         ids=["per-step", "per-track", "per-track-T2"])
def test_sig2_stream_matches_jax(shape):
    # (T-1, P) per-step, (B, T-1, P) per-track and a T=2 per-track table
    rng = np.random.default_rng(len(shape) + shape[-1])
    sig2 = rng.uniform(1e-4, 1e-2, shape)
    B = shape[0] if len(shape) == 3 else 5
    T, P = shape[-2] + 1, shape[-1]
    want, _ = pallas_engine._sig2_stream(jnp.asarray(sig2), T, P, B, B, B,
                                         jnp.float32)
    want = np.asarray(want).reshape(T - 1, P, B).transpose(2, 0, 1)
    got = forward_kernel.sig2_stream(torch.tensor(sig2), B, T)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert got.shape == (B, T - 1, P)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sig2_stream_is_differentiable():
    # a shared per-step table's gradient is the stream's summed over tracks
    sig2 = torch.rand(4, 9, dtype=torch.float64, requires_grad=True)
    w = torch.rand(3, 4, 9)
    (forward_kernel.sig2_stream(sig2, 3, 5) * w).sum().backward()
    torch.testing.assert_close(sig2.grad, w.sum(0).double())


def _window_cases():
    # S in {2, 3}, n in {1, 2}, W from n+1 (the smallest register) up
    return [(S, n, W) for S in (2, 3) for n in (1, 2)
            for W in range(n + 1, n + 3)]


@pytest.mark.parametrize("S,n,W", _window_cases())
def test_stream_index_maps_read_the_constant_tables(S, n, W):
    # a table broadcast from a constant dt: the stream entries each slot
    # reads (forward_kernel.stream_index) are the JAX package's and the
    # port's per-slot tables
    f64 = dict(dtype=torch.float64)
    Ds = np.linspace(0.0, 0.2, S)
    rates = np.full((S, S), 0.1)
    np.fill_diagonal(rates, 0.0)
    Fs = np.full(S, 1.0 / S)
    tb = ttables.build_tables(torch.tensor(Ds, **f64),
                              torch.tensor(0.02, **f64),
                              torch.tensor(Fs, **f64),
                              torch.tensor(rates, **f64),
                              torch.tensor(0.1, **f64), 0.03,
                              cell_dims=(0.5,), nb_substeps=n)
    jtb = jtables.build_tables(jnp.asarray(Ds), 0.02, jnp.asarray(Fs),
                               jnp.asarray(rates), 0.1, 0.03,
                               cell_dims=(0.5,), nb_substeps=n)
    B, T = 3, 6
    stream = forward_kernel.sig2_stream(tb.sig2, B, T).double()
    pat, nxt = forward_kernel.stream_index(S, W, n)
    sig2v = forward_kernel.build_slot_tables(tb, W, n)[5]
    s2n = forward_kernel.build_next_tables(tb, W, n)[1]
    jsig2v = np.asarray(pallas_engine.build_slot_tables(jtb, W, n)[5])
    js2n = np.asarray(pallas_engine.build_next_tables(jtb, W, n)[1])
    for t in range(T - 1):
        for b in range(B):
            row = stream[b, t]
            torch.testing.assert_close(row[pat], sig2v.float().double())
            torch.testing.assert_close(row[nxt], s2n.float().double())
            np.testing.assert_allclose(row[pat].numpy(), jsig2v, rtol=1e-7)
            np.testing.assert_allclose(row[nxt].numpy(), js2n, rtol=1e-7)


@pytest.mark.parametrize("S,n,W", [(2, 1, 4), (3, 1, 3), (2, 2, 4)])
def test_stream_index_maps_read_what_the_engine_reads(S, n, W):
    # variable dt: the initial register reads row 0 at pattern(k), and the
    # child a*G + g of a fusion at step t row t at its pattern, as the
    # plain engine's walk_setup does
    rng = np.random.default_rng(S + n + W)
    B, T = 4, 7
    P = S ** (n + 1)
    sig2 = torch.tensor(rng.uniform(1e-4, 1e-2, (B, T - 1, P)))
    tb = ttables.ModelTables(
        torch.zeros(S, S, dtype=torch.float64), torch.zeros(S),
        sig2, torch.zeros(S ** n), torch.zeros(S), torch.zeros(1, 1, 1))
    spec = tengine.make_register_spec(S, W, n)
    wk = tengine.walk_setup(torch.zeros(B, T, 2, dtype=torch.float64), tb,
                            spec)
    stream = forward_kernel.sig2_stream(sig2, B, T).double()
    pat, _ = forward_kernel.stream_index(S, W, n)
    np.testing.assert_allclose(wk.s2[0].T.numpy(),
                               stream[:, 0, pat].float().numpy(), rtol=1e-7)
    for t in range(1, T - 1):
        ag = wk.sig2_ag_at(t)                  # (A, G, B): child a*G + g
        np.testing.assert_allclose(ag.reshape(-1, B).T.numpy(),
                                   stream[:, t, pat].numpy(), rtol=1e-7)


@pytest.fixture(scope="module")
def dt_dataset():
    # tests/test_pallas_grad.py's dt-dict case
    rng = np.random.default_rng(3)
    tracks, _, _ = jsim.sim_fov(
        nb_tracks=150, max_track_len=8, min_track_len=3, LocErr=0.02,
        Ds=(0.0, 0.08), TrMat=np.array([[0.9, .1], [.1, .9]]), dt=0.02,
        pBL=0.05, cell_dims=(0.5, None, None), seed=21)
    dt_dict = {k: rng.uniform(0.015, 0.03, (v.shape[0], v.shape[1] - 1))
               for k, v in tracks.items()}
    jspec = jparams.generate_params(nb_states=2, LocErr_type=1, D_max=1.0,
                                    estimated_Ds=[0.001, 0.05])
    tspec = tparams.Parameters.from_records(
        [(p.name, p.value, p.min, p.max, p.vary, p.expr)
         for p in jspec._params.values()])
    return tracks, dt_dict, jspec, tspec


def test_objective_with_dt_dict_matches_jax(dt_dataset):
    tracks, dt_dict, jspec, tspec = dt_dataset
    jb = jdata.from_dict_bucketed(tracks, max_buckets=2, dt=dt_dict)
    tb = tdata.from_dict_bucketed(tracks, max_buckets=2, dt=dt_dict,
                                   device="cpu", dtype=torch.float64)
    assert all(b.dt is not None for b in tb)
    jo = jfit.make_objective(jb, jspec, 0.02, 2, cell_dims=(0.5,), window=4,
                             compute_engine="xla")
    to = tfit.make_objective(tb, tspec, 0.02, 2, cell_dims=(0.5,), window=4)
    z0 = jspec.to_unconstrained() + np.random.default_rng(1).normal(
        0, 0.3, len(jspec.free_names()))
    v_ref, g_ref = jax.value_and_grad(jo)(jnp.asarray(z0))
    z = torch.tensor(z0, requires_grad=True)
    v = to(z)
    (g,) = torch.autograd.grad(v, z)
    np.testing.assert_allclose(float(v.detach()), float(v_ref), rtol=1e-8)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-8,
                               atol=1e-8 * float(np.abs(g_ref).max()))


def test_hessian_columns_with_per_track_dt_match_jax_hessian(dt_dataset):
    # tests/test_hvp.py's per-track dt case, through the drivers: the
    # port's Hessian columns against jax.hessian of the XLA objective
    tracks, dt_dict, jspec, tspec = dt_dataset
    small = {k: v[:12] for k, v in tracks.items()}
    dts = {k: v[:12] for k, v in dt_dict.items()}
    jb = jdata.from_dict_bucketed(small, max_buckets=1, dt=dts)
    tb = tdata.from_dict_bucketed(small, max_buckets=1, dt=dts,
                                   device="cpu", dtype=torch.float64)
    jo = jfit.make_objective(jb, jspec, 0.02, 2, cell_dims=(0.5,), window=4,
                             compute_engine="xla")
    to = tfit.make_objective(tb, tspec, 0.02, 2, cell_dims=(0.5,), window=4)
    z = jspec.to_unconstrained() + np.random.default_rng(2).normal(
        0, 0.2, len(jspec.free_names()))
    H_ref = np.asarray(jax.hessian(jo)(jnp.asarray(z)))
    H = tfit.hessian_hvp_columns(tb, tspec, z, 0.02, 2, cell_dims=(0.5,),
                                 window=4, min_len=to.min_len)
    scale = np.abs(H_ref).max()
    np.testing.assert_allclose(H, H_ref, rtol=5e-3, atol=1e-3 * scale)


@pytest.mark.parametrize("kind", ["per-step", "per-track"])
def test_predict_batch_with_variable_dt_matches_jax(kind):
    tracks, _, _ = jsim.sim_fov(
        nb_tracks=60, max_track_len=7, min_track_len=2, LocErr=0.02,
        Ds=(0.0, 0.08), dt=0.02, pBL=0.1, cell_dims=(0.5, None, None),
        seed=9)
    rng = np.random.default_rng(5)
    values = {"LocErr": 0.021, "D0": 0.001, "D1": 0.07, "F0": 0.45,
              "F1": 0.55, "p01": 0.08, "p10": 0.12, "pBL": 0.09}
    T = max(int(k) for k in tracks)
    if kind == "per-step":
        dt_dict, dt = None, rng.uniform(0.01, 0.05, T - 1)
    else:
        dt_dict = {k: rng.uniform(0.01, 0.05, (v.shape[0], v.shape[1] - 1))
                   for k, v in tracks.items()}
        dt = 0.0
    jb = jdata.from_dict(tracks, dt=dt_dict)
    tb = tdata.from_dict(tracks, dt=dt_dict, device="cpu")
    assert tb.max_len == T
    want = jpredict.predict_batch(jb, values, jnp.asarray(dt), 2,
                                  cell_dims=(0.5,), window=4,
                                  compute_engine="xla")
    got = tpredict.predict_batch(tb, values, dt, 2, cell_dims=(0.5,),
                                 window=4)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("kernel", forward_kernel.STREAMED)
def test_check_envelope_streams_variable_dt_through_k1_to_k4(kernel):
    forward_kernel.check_envelope(10, 2, 2, 6, 1, variable_dt=True,
                                  kernel=kernel)
    forward_kernel.check_envelope(10, 2, 3, 5, 2, variable_dt=True,
                                  kernel=kernel, what="bucket 0")


def test_check_envelope_names_k5_and_k7_for_variable_dt():
    # K5 reads the stream (one and two sub-steps a frame); so does K7, at
    # len_hist's register (M = 512) and at two sub-steps a frame
    forward_kernel.check_envelope(10, 2, 2, 7, 1, variable_dt=True,
                                  what="histogram batch", kernel="K5")
    forward_kernel.check_envelope(10, 2, 2, 7, 2, variable_dt=True,
                                  what="histogram batch", kernel="K5")
    forward_kernel.check_envelope(10, 2, 2, 7, 1, kernel="K5")
    topk_kernel.check_envelope(10, 2, 2, 512, variable_dt=True)
    topk_kernel.check_envelope(10, 2, 2, 128, 2, variable_dt=True)
    # what still raises under variable dt names K7 and its reason
    with pytest.raises(NotImplementedError, match=r"K7 computes in float32"):
        topk_kernel.check_envelope(10, 2, 2, 512, variable_dt=True,
                                   dtype=torch.float64)
    # K5 maps past 1024 slots (3^7 = 2187, len_hist's default window at
    # 3 states; 3^8 = 6561, 4^7 = 16384 at 4 states; 5^7 and 6^7 past
    # 16384) with variable dt; past 2^19 it raises, naming itself
    for S, W in ((3, 7), (3, 8), (4, 7), (5, 7), (6, 7)):
        forward_kernel.check_envelope(10, 2, S, W, 1, variable_dt=True,
                                      kernel="K5")
    with pytest.raises(NotImplementedError, match=r"K=.*524288.*K5"):
        forward_kernel.check_envelope(10, 2, 3, 12, 1, variable_dt=True,
                                      kernel="K5")


@pytest.mark.parametrize("frame_len", [4, 5])
def test_predict_Bs_with_dt_dict_matches_jax(frame_len):
    """A per-track dt dict: the port's four length buckets take the
    dataset's representative dt for their survival tables, as JAX's one
    padded batch does."""
    tracks, _, _ = jsim.sim_fov(
        nb_tracks=60, max_track_len=7, min_track_len=2, LocErr=0.02,
        Ds=(0.0, 0.08), dt=0.02, pBL=0.1, cell_dims=(0.5, None, None),
        seed=13)
    rng = np.random.default_rng(frame_len)
    values = {"LocErr": 0.021, "D0": 0.001, "D1": 0.07, "F0": 0.45,
              "F1": 0.55, "p01": 0.08, "p10": 0.12, "pBL": 0.09}
    dts = {k: rng.uniform(0.01, 0.05, (v.shape[0], v.shape[1] - 1))
           for k, v in tracks.items()}
    assert len(tdata.from_dict_bucketed(tracks, dt=dts, device="cpu")) > 1
    want = jpredict.predict_Bs(tracks, dts, values, cell_dims=(0.5,),
                               nb_states=2, frame_len=frame_len)
    got = tpredict.predict_Bs(tracks, dts, values, cell_dims=(0.5,),
                              nb_states=2, frame_len=frame_len,
                              device="cpu")
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-8,
                                   atol=1e-8)
