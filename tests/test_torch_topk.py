"""The port's top-K histogram engine (the plain version of K7, the
backpointer decoder and the ``engine="topk"`` routing) against the JAX
package's.

Tolerances, float64 on the CPU: 1e-10 relative on the histogram against
extrack_tpu.histograms.segment_histogram (the same walk and the same
stable selection; only the order of some sums differs); 1e-9 on
``len_hist`` (the port length-buckets, the JAX len_hist runs one padded
batch); the decoder exactly (weights chosen so that every sum is exact in
any order).  Against the Pallas kernel in interpret mode (float32) the
tolerances are tests/test_pallas_topk.py's: a pruned register may keep
another sequence on a near-tie, so rtol 2e-3 / atol 2e-2.

The CUDA kernel K7 itself is checked against its plain version in
tests/test_torch_cuda.py (needs a GPU).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from extrack_tpu import histograms as jhist
from extrack_tpu.core import tables as jtables
from extrack_tpu.ops import pallas_topk
from extrack_tpu_torch import (data as tdata, histograms as thist,
                               params as tparams)
from extrack_tpu_torch.core import tables as ttables
from extrack_tpu_torch.ops import topk_kernel
from tests.test_pallas import _setup
from tests.test_torch_histograms import _case


def _frames(hist, lengths):
    """Frames counted by a (T, S) histogram against the frames of the
    tracks of 2 frames or more."""
    counted = (np.asarray(hist) * np.arange(1, hist.shape[0] + 1)[:, None])
    return counted.sum(), lengths[lengths >= 2].sum()


@pytest.mark.parametrize("S,n,M,T,per_peak,bl", [
    (2, 1, 16, 9, False, 1.0),
    (3, 1, 16, 7, False, 0.0),    # 3 states, isBL off
    (2, 2, 16, 7, False, 1.0),    # two sub-steps per frame
    (2, 1, 16, 8, True, 1.0),     # per-peak LocErr
    (2, 1, 8, 8, False, 1.0),     # a saturated register
    (3, 1, 88, 5, False, 1.0),    # unpruned: 3^4 = 81 sequences fit
    (2, 1, 16, 2, True, 1.0),     # T = 2: every track ends at t = 1
])
def test_segment_histogram_matches_jax(S, n, M, T, per_peak, bl):
    xs, lengths, isbl, jt, tt = _case(S * 10 + M + T + n, S, 13, T, n=n,
                                      per_peak=per_peak)
    isbl = isbl * bl
    want = np.asarray(jhist.segment_histogram(
        jnp.asarray(xs), jnp.asarray(lengths), jnp.asarray(isbl), jt,
        max_nb_states=M, min_len=3, nb_substeps=n))
    args = (torch.tensor(xs), torch.tensor(lengths), torch.tensor(isbl), tt)
    before = topk_kernel.PLAIN_CALLS, topk_kernel.LAUNCHES
    got = topk_kernel.segment_topk(*args, max_nb_states=M, min_len=3,
                                   nb_substeps=n)
    # CPU tensors take the plain version, never the kernel
    assert (topk_kernel.PLAIN_CALLS, topk_kernel.LAUNCHES) == (
        before[0] + 1, before[1])
    assert got.shape == (T, S) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10)
    counted, frames = _frames(got.numpy(), lengths)
    np.testing.assert_allclose(counted, frames, rtol=1e-10)
    # raw outputs: the layout the kernel's are compared in
    parents, states, w_final = thist.segment_backpointers(
        *args, max_nb_states=M, min_len=3, nb_substeps=n)
    assert parents.shape == states.shape == (T - 1, 13, M)
    assert states.dtype == torch.int8 and w_final.shape == (13, M)
    live = lengths >= 2
    np.testing.assert_allclose(w_final.sum(1).numpy()[live], 1.0, rtol=1e-12)
    assert (w_final.numpy()[~live] == 0.0).all()
    # frozen steps record identity parents
    steps = np.arange(1, T)[:, None]
    frozen = torch.tensor(steps >= np.maximum(lengths, 1) - 1)
    assert (parents[frozen] == torch.arange(M)).all()


@pytest.mark.parametrize("per_track", [False, True])
def test_segment_histogram_variable_dt_matches_jax(per_track):
    S, B, T, M = 2, 11, 7, 16
    rng = np.random.default_rng(21 + per_track)
    xs = rng.normal(0, 0.06, (B, T, 2)).cumsum(1)
    lengths = rng.integers(0, T + 1, B)
    lengths[:3] = (T, 2, 1)
    isbl = (lengths < T).astype(np.float64)
    dt = rng.uniform(0.01, 0.04, (B, T - 1) if per_track else (T - 1,))
    phys = (np.array([0.0, 0.1]), np.float64(0.02), np.array([0.4, 0.6]),
            np.array([[0.0, 0.1], [0.0, 0.0]]), np.float64(0.08), dt)
    jt = jtables.build_tables(*(jnp.asarray(v) for v in phys),
                              cell_dims=(0.6,))
    tt = ttables.build_tables(*(torch.tensor(v) for v in phys),
                              cell_dims=(0.6,))
    want = np.asarray(jhist.segment_histogram(
        jnp.asarray(xs), jnp.asarray(lengths), jnp.asarray(isbl), jt,
        max_nb_states=M, min_len=3))
    got = thist.segment_histogram(torch.tensor(xs), torch.tensor(lengths),
                                  torch.tensor(isbl), tt, max_nb_states=M,
                                  min_len=3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10)


def test_decode_backpointers_matches_jax_exactly():
    rng = np.random.default_rng(4)
    Tm1, B, M, S = 6, 9, 12, 3
    pairs = ttables.state_codes(S, 2)
    parents = rng.integers(0, M, (Tm1, B, M))
    states = rng.integers(0, S, (Tm1, B, M)).astype(np.int8)
    w_final = rng.integers(0, 9, (B, M)) / 8.0          # exact sums
    lengths = rng.integers(0, Tm1 + 2, B)
    want = np.asarray(jhist.decode_backpointers(
        jnp.asarray(parents, jnp.int32), jnp.asarray(states),
        jnp.asarray(w_final), jnp.asarray(lengths), pairs, S, M))
    # K7's int16 parents, as (B, T-1, M) buffers seen through a transpose
    got = thist.decode_backpointers(
        torch.tensor(parents.transpose(1, 0, 2), dtype=torch.int16
                     ).transpose(0, 1),
        torch.tensor(states.transpose(1, 0, 2)).transpose(0, 1),
        torch.tensor(w_final), torch.tensor(lengths), pairs, S, M)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def sim():
    from extrack_tpu import simulate as jsim
    tracks, _, _ = jsim.sim_fov(
        nb_tracks=90, max_track_len=9, min_track_len=2, LocErr=0.02,
        Ds=(0.0, 0.08), dt=0.02, pBL=0.1, cell_dims=(0.5, None, None),
        seed=12)
    values = {"LocErr": 0.021, "D0": 0.001, "D1": 0.07, "F0": 0.45,
              "F1": 0.55, "p01": 0.08, "p10": 0.0, "pBL": 0.09}
    return tracks, values


def test_len_hist_topk_matches_jax(sim):
    """max_nb_states=8 rounds up to a register of 128, as in JAX; a
    register of 8 prunes weight that 128 keeps."""
    tracks, values = sim
    kw = dict(cell_dims=(0.5,), nb_states=2, engine="topk",
              max_nb_states=8)
    want = np.asarray(jhist.len_hist(tracks, values, 0.02, **kw))
    before = topk_kernel.PLAIN_CALLS
    got = thist.len_hist(tracks, values, 0.02, device="cpu", **kw)
    assert topk_kernel.PLAIN_CALLS == before + len(
        tdata.from_dict_bucketed(tracks, max_buckets=4))
    assert got.shape == want.shape == (9, 2)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    batch = tdata.from_dict(tracks)
    Ds, Fs, rates, loc_err, pBL = tparams.extract_arrays(values, 2)
    tb = ttables.build_tables(Ds, loc_err, Fs, rates, pBL, 0.02,
                              cell_dims=(0.5,))
    unrounded = thist.segment_histogram(
        batch.positions, batch.lengths, batch.is_bleached, tb,
        max_nb_states=8, min_len=2)
    assert np.abs(unrounded.numpy() - got).max() > 1e-6


def test_topk_engine_names_are_one_computation(sim):
    tracks, values = sim
    batch = tdata.from_dict(tracks)
    kw = dict(cell_dims=(0.5,), max_nb_states=128)
    before = topk_kernel.PLAIN_CALLS, topk_kernel.LAUNCHES
    a = thist.hist_batch(batch, values, 0.02, engine="topk", **kw)
    b = thist.hist_batch(batch, values, 0.02, engine="topk_pallas", **kw)
    c = thist.hist_batch(batch, values, 0.02, engine="topk", chunk=17, **kw)
    assert (topk_kernel.PLAIN_CALLS, topk_kernel.LAUNCHES) == (
        before[0] + 2 + -(-batch.batch_size // 17), before[1])
    assert torch.equal(a, b)
    torch.testing.assert_close(c, a, rtol=1e-12, atol=1e-12)


def test_segment_histogram_matches_pallas_interpret():
    M = 16
    xs, lengths, isbl, jt = _setup(62, n_tracks=12, T=5)
    want = np.asarray(pallas_topk.segment_topk_pallas(
        jnp.asarray(xs), jnp.asarray(lengths),
        jnp.asarray(isbl, jnp.float32), jt, max_nb_states=M, min_len=3,
        interpret=True))
    tt = ttables.tables_from_numpy(
        {f: np.asarray(getattr(jt, f)) for f in jt._fields}, "cpu",
        torch.float32)
    got = thist.segment_histogram(
        torch.tensor(xs), torch.tensor(lengths),
        torch.tensor(isbl, dtype=torch.float32), tt, max_nb_states=M,
        min_len=3)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-2)


def test_check_envelope():
    ok = dict(T=10, D=2, S=2, M=512)
    topk_kernel.check_envelope(**ok, smem_limit=227 * 1024)
    with pytest.raises(NotImplementedError, match="dt"):
        topk_kernel.check_envelope(**ok, variable_dt=True)
    with pytest.raises(NotImplementedError, match="float64"):
        topk_kernel.check_envelope(**ok, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="< nb_states"):
        topk_kernel.check_envelope(T=10, D=2, S=3, M=8)
    with pytest.raises(NotImplementedError, match="D=4"):
        topk_kernel.check_envelope(T=10, D=4, S=2, M=512)
    # 2 runs of 512 children's words and two merge buffers (16 KB) + 8
    # floats per row (16 KB) at M=512
    assert topk_kernel.walk_bytes(512, 2, 2) == 16384 + 16384
    with pytest.raises(NotImplementedError,
                       match="largest max_nb_states that fits is 256"):
        topk_kernel.check_envelope(**ok, smem_limit=topk_kernel.walk_bytes(
            256, 2, 2))
    with pytest.raises(NotImplementedError, match="that fits is 1024"):
        topk_kernel.check_envelope(T=10, D=2, S=2, M=1152)
    # len_hist's register, M = 512, at S = 2, 3, 4 (n = 1) and S = 2, n = 2,
    # D = 1..3, inside an H100 block's 227 KB
    for S, n in ((2, 1), (3, 1), (4, 1), (2, 2)):
        for D in (1, 2, 3):
            topk_kernel.check_envelope(10, D, S, 512, n,
                                       smem_limit=227 * 1024)


def test_topk_tables_layout():
    _, _, _, _, tt = _case(3, 3, 4, 5, n=1)
    M, S = 16, 3
    lp0, s20, nw0, tab = topk_kernel.topk_tables(tt, M, 1)
    assert [t.dtype for t in (lp0, s20, nw0, tab)] == [
        torch.float32, torch.float32, torch.int32, torch.float32]
    codes = ttables.state_codes(S, 2)
    np.testing.assert_allclose(
        lp0[:9].numpy(),
        ttables.init_log_prob(tt.log_trans, tt.log_frac, 1).numpy(),
        rtol=1e-6)
    assert (lp0[9:] == -1e30).all()
    np.testing.assert_array_equal(nw0[0, :9].numpy(), codes[:, 0])
    np.testing.assert_array_equal(nw0[1, :9].numpy(), codes[:, -1])
    assert (nw0[:, 9:] == 0).all()
    sig2 = tt.sig2.reshape(-1, 9)[0].float()
    torch.testing.assert_close(s20[9:], sig2[0].expand(M - 9))
    torch.testing.assert_close(tab[-9:], sig2)
    assert tab.shape == (2 * S * S + S + S,)


def test_topk_engine_defaults_to_the_card(sim):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run")
    with pytest.raises(RuntimeError, match="CUDA device"):
        thist.len_hist(sim[0], sim[1], 0.02, cell_dims=(0.5,),
                       engine="topk")


def test_fused_layout_keeps_backpointers_in_shared_memory():
    limit = 227 * 1024
    # T=10, M=512: 2 blocks of 512 threads fit an SM's registers, so the
    # decode's 20 bins of columns (40 KB) take one pass beside the
    # backpointers, (T-1)*M*3 bytes
    assert topk_kernel.layout(512, 2, 2, 2, 10, limit) == (
        20 * 512 * 4, 20, True)
    # T=30, M=128: 8 blocks fit the registers; the columns are cut to what
    # keeps 8 resident (27 KB a block with the backpointers): 2 passes
    share = (limit + 1024) // 8 - 2048
    bp = 29 * 128 * 3
    assert topk_kernel.layout(128, 2, 2, 2, 30, limit) == (
        share - bp, (share - bp) // 512, True)
    # 3 states at T = 20 (the 3-state main path's longest bucket)
    region, chunk, bp_smem = topk_kernel.layout(512, 2, 3, 3, 20, limit)
    assert bp_smem and chunk == region // 2048 < 60
    assert region + 19 * 512 * 3 <= limit
    # too long to keep the backpointers: they go to global scratch
    walk = topk_kernel.walk_bytes(1024, 2, 2)
    assert walk == 8 * 4 * 1024 + 4 * 8 * 1024
    assert topk_kernel.layout(1024, 2, 2, 2, 60, limit) == (walk, 16, False)
    # the backpointers fit beside the walk's region alone, not beside the
    # decode's: the decode then takes more passes
    lim = topk_kernel.walk_bytes(128, 2, 2) + 3 * 29 * 128
    region, chunk, bp_smem = topk_kernel.layout(128, 2, 2, 2, 30, lim)
    assert bp_smem and region == topk_kernel.walk_bytes(128, 2, 2)
    assert chunk == region // (4 * 128)


@pytest.mark.parametrize("S,n,M,T", [(2, 1, 16, 8), (3, 1, 88, 5),
                                     (2, 2, 16, 7)])
def test_per_track_rows_match_jax_track_by_track(S, n, M, T):
    # the rows K7's fused decode writes, one per track: each against the
    # JAX package's histogram of that track alone
    xs, lengths, isbl, jt, tt = _case(S * 7 + M + T + n, S, 6, T, n=n)
    rows = thist.segment_histogram(
        torch.tensor(xs), torch.tensor(lengths), torch.tensor(isbl), tt,
        max_nb_states=M, min_len=3, nb_substeps=n, per_track=True)
    assert rows.shape == (6, T, S)
    for b in range(6):
        want = np.asarray(jhist.segment_histogram(
            jnp.asarray(xs[b:b + 1]), jnp.asarray(lengths[b:b + 1]),
            jnp.asarray(isbl[b:b + 1]), jt, max_nb_states=M, min_len=3,
            nb_substeps=n))
        np.testing.assert_allclose(rows[b].numpy(), want, rtol=1e-10,
                                   atol=1e-10)
    total = thist.segment_histogram(
        torch.tensor(xs), torch.tensor(lengths), torch.tensor(isbl), tt,
        max_nb_states=M, min_len=3, nb_substeps=n)
    np.testing.assert_allclose(rows.sum(0).numpy(), total.numpy(),
                               rtol=1e-12, atol=1e-12)
