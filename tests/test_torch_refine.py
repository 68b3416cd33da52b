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
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from extrack_tpu import refine as jrefine
from extrack_tpu.ops import pallas_refine
from extrack_tpu_torch import data as tdata, refine as trefine
from extrack_tpu_torch.core import tables as ttables
from extrack_tpu_torch.ops import refine_kernel
from extrack_tpu_torch.parallel import mesh as pmesh
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)


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
    (6, 4, 5, 1, False),         # the default window at 6 states on short
                                 # 1-D tracks: K = 1296, K6's wide mapping
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


@pytest.mark.parametrize("S", range(2, 9))
@pytest.mark.parametrize("T", [3, 5, 10, 16, 20, 30, 50, 100])
@pytest.mark.parametrize("D", [1, 2, 3])
def test_default_window_matches_jax(S, T, D):
    assert trefine.default_window(S, T, D) == jrefine.default_window(S, T, D)


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
        tdata.from_dict_bucketed(all_tracks, max_buckets=4,
                                 device="cpu"))
    assert list(mus) == list(mus_j) == list(all_tracks)
    for k in all_tracks:
        assert mus[k].shape == all_tracks[k].shape
        assert sigs[k].shape == all_tracks[k].shape[:2]
        np.testing.assert_allclose(mus[k], mus_j[k], rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(sigs[k], sigs_j[k], rtol=1e-9,
                                   atol=1e-12)


def test_position_refinement_default_window_matches_jax(tracks):
    """frame_len=None: both packages take the window of the longest track
    (2 states, T=9, D=2: 7) and refine alike."""
    all_tracks, _ = tracks
    ds, tr = np.array([0.02, 0.1]), np.array([[0.9, 0.1], [0.2, 0.8]])
    mus_j, sigs_j = jrefine.position_refinement(
        all_tracks, 0.02, ds, [0.5, 0.5], tr, compute_engine="xla")
    mus, sigs = trefine.position_refinement(all_tracks, 0.02, ds, [0.5, 0.5],
                                            tr, device="cpu")
    for k in all_tracks:
        np.testing.assert_allclose(mus[k], mus_j[k], rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(sigs[k], sigs_j[k], rtol=1e-9,
                                   atol=1e-12)


def test_position_refinement_six_states_1d_default_window_matches_jax():
    """6 states on 1-D tracks of 3-5 frames: both packages take the
    default window 4 (K = 1296: the card runs K6's wide mapping)."""
    rng = np.random.default_rng(21)
    all_tracks = {str(L): rng.normal(0, 0.05, (n, L, 1)).cumsum(1)
                  for L, n in ((3, 6), (4, 5), (5, 5))}
    S = 6
    ds = np.linspace(0.01, 0.12, S)
    tr = np.full((S, S), 0.02) + np.eye(S) * 0.88
    Fs = np.full(S, 1 / S)
    assert trefine.default_window(S, 5, 1) == 4
    mus_j, sigs_j = jrefine.position_refinement(
        all_tracks, 0.02, ds, Fs, tr, compute_engine="xla")
    mus, sigs = trefine.position_refinement(all_tracks, 0.02, ds, Fs, tr,
                                            device="cpu")
    for k in all_tracks:
        np.testing.assert_allclose(mus[k], mus_j[k], rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(sigs[k], sigs_j[k], rtol=1e-9,
                                   atol=1e-12)


def test_refine_batch_defaults_and_sharding(tracks):
    batch = tdata.from_dict(tracks[0], device="cpu")
    ds, tr = np.array([0.02, 0.1, 0.2]), np.full((3, 3), 1 / 3)
    W = jrefine.default_window(3, batch.max_len, batch.nb_dims)
    assert W == 6                      # 3 states at T=9, D=2
    mu, _, n = trefine.refine_batch(batch, 0.02, ds, tr)
    muW, _, _ = trefine.refine_batch(batch, 0.02, ds, tr, frame_len=W)
    assert n == batch.batch_size
    np.testing.assert_array_equal(mu, muW)
    # sharded: one CPU shard bit for bit, three shards within rounding
    mu1, _, n1 = trefine.refine_batch(batch, 0.02, ds, tr, sharded=True)
    assert n1 == n and np.array_equal(mu1, mu)
    mu3, _, _ = trefine.refine_batch(
        batch, 0.02, ds, tr, sharded=pmesh.make_mesh(devices=["cpu"] * 3))
    np.testing.assert_allclose(mu3, mu, rtol=1e-12, atol=1e-14)


def test_position_refinement_defaults_to_the_card(tracks):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run")
    with pytest.raises(RuntimeError, match="CUDA device"):
        trefine.position_refinement(tracks[0], 0.02, [0.02, 0.1],
                                    [0.5, 0.5], np.eye(2))


LOG2E = 1.0 / math.log(2.0)


def _forms32(m, s2, lp, x, l2, obs):
    """K6's precision form of each slot (csrc/refine.cu make_form) in f32:
    Pt = l2/s2 (+ obs), Nt = (m - x)/s2 sqrt(l2 log2(e) / 2), and the base-2
    log weight with the slot's normalizer."""
    p = 1.0 / s2
    a = m - x[..., None, :]
    b = (LOG2E * (lp - 0.5 * (a * a * p).sum(-1))
         - 0.5 * torch.log2(s2.prod(-1)))
    return (b, l2[..., None, :] * p + obs,
            a * p * torch.sqrt(0.5 * LOG2E * l2[..., None, :]))


def _pairs32(pre, suf, x, l2, S, tile=4):
    """K6's pair algebra (csrc/refine.cu pair_loop) in f32 at every position
    at once: per pair o_d = prod_{e != d} Pt_e, a_d = Nt_d o_d, one rsqrt r
    of prod_d Pt (1/Pt_d = r^2 o_d), the exponent b2 + r^2 sum_d Nt_d a_d in
    base 2 with b1 added per row (through an offset no smaller than the
    row's max), the accumulators of each prefix slot
    rescaled once per tile of ``tile`` suffix slots; then the sum over
    prefix slots at their common max.  Returns mu, sigma (..., D)."""
    (b1, A, C), (b2, B2, N2) = pre, suf
    lead, (K, D) = b1.shape[:-1], A.shape[-2:]
    KS = K // S

    def blocks(t):
        return t.reshape(lead + (S, KS) + t.shape[len(lead) + 1:])

    b1, A, C, b2, B2, N2 = map(blocks, (b1, A, C, b2, B2, N2))
    P = A[..., :, None, :] + B2[..., None, :, :]          # (.., S, i, j, D)
    N = C[..., :, None, :] + N2[..., None, :, :]
    o = torch.stack([torch.prod(P[..., [e for e in range(D) if e != d]], -1)
                     for d in range(D)], -1)
    r = torch.rsqrt(P[..., 0] * o[..., 0])
    a = N * o
    arg = (N * a).sum(-1) * r * r + b2[..., None, :]
    mx = torch.full(arg.shape[:-1], -1e30, dtype=arg.dtype)
    acc = torch.zeros(arg.shape[:-1] + (1 + 2 * D,), dtype=arg.dtype)
    for c in range(0, KS, tile):
        sl = slice(c, c + tile)
        row = arg[..., sl].amax(-1)
        top = torch.maximum(mx, row + b1)
        acc = acc * torch.exp2(mx - top)[..., None]
        mx = top
        e = torch.exp2(arg[..., sl] - torch.maximum(mx - b1, row)[..., None])
        z = (e * r[..., sl] ** 3)[..., None]
        acc = acc + torch.cat([(e * r[..., sl]).sum(-1, keepdim=True),
                               (z * a[..., sl, :]).sum(-2),
                               (z * o[..., sl, :]).sum(-2)], -1)
    mx = mx.flatten(-2)
    acc = acc.flatten(-3, -2)
    top = mx.amax(-1, keepdim=True)
    tot = (acc * torch.exp2(mx - top)[..., None]).sum(-2)
    mean = tot[..., 1:1 + D] / tot[..., :1] * torch.sqrt(2 * l2 / LOG2E)
    var = tot[..., 1 + D:] / tot[..., :1] * l2
    return x + mean, var.sqrt()


@pytest.mark.parametrize("sigma", [1e-4, 1e-2, 1.0])
@pytest.mark.parametrize("S,W,D", [(2, 5, 1), (2, 4, 2), (3, 3, 3)])
def test_pair_algebra_f32_matches_refine_positions(S, W, D, sigma):
    """K6's reformulated pair algebra, rendered in torch f32 on the
    registers of the plain scans, against refine_positions in f64 at
    every interior position, within K6's tolerances (mu rtol 2e-4 / atol
    2e-5 relative to the localization error's scale, sigma rtol 2e-3 /
    atol 2e-5): the single rsqrt, base-2 exponents, the per-position scale
    by l2 and the tiled rescale are exact up to f32 rounding, from
    localization errors of 1e-4 to 1."""
    rng = np.random.default_rng(int(S * 100 + W * 10 + D + 1e4 * sigma))
    B, T = 9, 7
    xs = rng.normal(0, 0.05, (B, T, D)).cumsum(1) + rng.normal(
        0, sigma, (B, T, D))
    lengths = np.full(B, T)
    l2 = (sigma * rng.uniform(0.5, 1.5, (B, T, D))) ** 2      # per peak
    tr = np.full((S, S), 0.2 / (S - 1))
    np.fill_diagonal(tr, 0.8)
    tr[0, 1] = 0.0
    tr /= tr.sum(1, keepdims=True)
    args = (torch.tensor(xs), torch.tensor(lengths), torch.tensor(l2),
            ttables.cap_log(torch.tensor(tr)),
            torch.tensor((0.08 * (1 + np.arange(S))) ** 2 * 0.04))
    mu0, sig0 = trefine.refine_positions(*args, window=W)
    pos, lens, l2t, lt, sig2 = args
    pm, ps2, plp = trefine._refine_scan(pos, l2t, lens, lt, sig2, W)
    rev = trefine._reverse_tracks
    sm, ss2, slp = trefine._refine_scan(rev(pos, lens), rev(l2t, lens), lens,
                                        lt.T, sig2, W)
    sm, ss2, slp = rev(sm, lens), rev(ss2, lens), rev(slp, lens)
    f = {n: v.float() for n, v in dict(pm=pm, ps2=ps2, plp=plp, sm=sm,
                                        ss2=ss2, slp=slp, x=pos,
                                        l2=l2t).items()}
    pre = _forms32(f["pm"], f["ps2"], f["plp"], f["x"], f["l2"], 1.0)
    suf = _forms32(f["sm"], f["ss2"], f["slp"], f["x"], f["l2"], 0.0)
    mu, sig = _pairs32(pre, suf, f["x"], f["l2"], S)
    inner = slice(1, T - 1)
    scale = sigma + 0.05
    np.testing.assert_allclose(mu[:, inner].numpy(), mu0[:, inner].numpy(),
                               rtol=2e-4, atol=2e-5 * scale)
    np.testing.assert_allclose(sig[:, inner].numpy(),
                               sig0[:, inner].numpy(), rtol=2e-3,
                               atol=2e-5 * scale)
