"""The port's duration histograms (the plain version of K5, ``len_hist``
and the segment decoders) against the JAX package's.

Tolerances, float64 on the CPU: 1e-10 relative on the window histogram
against extrack_tpu.histograms.window_segment_histogram (the same
recursion summed in another order); 1e-9 on ``len_hist`` (the port
length-buckets, the JAX len_hist runs one padded batch); the decoders
exactly (weights chosen so that every sum is exact in any order); rtol
2e-3 / atol 2e-4 against the Pallas kernel in interpret mode (float32, as
tests/test_pallas_hist.py holds it).

The CUDA kernel K5 itself is checked against its plain version in
tests/test_torch_cuda.py (needs a GPU).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from extrack_tpu import histograms as jhist, simulate as jsim
from extrack_tpu.core import tables as jtables
from extrack_tpu.ops import pallas_hist
from extrack_tpu_torch import data as tdata, histograms as thist
from extrack_tpu_torch.core import engine as tengine, tables as ttables
from extrack_tpu_torch.ops import hist_kernel


def _case(seed, S, B, T, n=1, per_peak=False, dtype=np.float64):
    rng = np.random.default_rng(seed)
    xs = rng.normal(0, 0.06, (B, T, 2)).cumsum(1).astype(dtype)
    lengths = rng.integers(0, T + 1, B)
    lengths[:4] = (T, min(2, T), 1, 0)                  # 0/1-frame rows
    isbl = (rng.random(B) < 0.5).astype(dtype)
    rates = rng.uniform(0.03, 0.25, (S, S))
    rates[1, 0] = 0.0                                   # forbidden
    loc = (rng.uniform(0.01, 0.03, (B, T, 2)) if per_peak
           else np.float64(0.02))
    jt = jtables.build_tables(
        *(jnp.asarray(np.asarray(v, dtype)) for v in (
            np.linspace(0.0, 0.15, S), loc, rng.dirichlet(np.ones(S)),
            rates, 0.08, 0.02)),
        cell_dims=(0.6,), nb_substeps=n)
    tt = ttables.tables_from_numpy(
        {f: np.asarray(getattr(jt, f)) for f in jt._fields}, "cpu",
        torch.float64 if dtype == np.float64 else torch.float32)
    return xs, lengths, isbl, jt, tt


@pytest.mark.parametrize("S,W,n,T,per_peak,bl", [
    (2, 5, 1, 9, False, 1.0),
    (2, 4, 1, 8, True, 1.0),     # per-peak LocErr
    (3, 3, 1, 7, False, 0.0),    # 3 states, isBL off
    (2, 3, 1, 2, True, 1.0),     # T = 2: every track ends at t = 1
    (2, 6, 1, 4, False, 1.0),    # window wider than the tracks
    (2, 5, 2, 8, False, 1.0),    # two sub-steps per frame
])
def test_window_histogram_matches_jax(S, W, n, T, per_peak, bl):
    xs, lengths, isbl, jt, tt = _case(S * 10 + W + T + n, S, 13, T, n=n,
                                      per_peak=per_peak)
    isbl = isbl * bl
    want = np.asarray(jhist.window_segment_histogram(
        jnp.asarray(xs), jnp.asarray(lengths), jnp.asarray(isbl), jt,
        window=W, min_len=3, nb_substeps=n))
    args = (torch.tensor(xs), torch.tensor(lengths), torch.tensor(isbl), tt)
    before = hist_kernel.PLAIN_CALLS, hist_kernel.LAUNCHES
    got = hist_kernel.hist(*args, window=W, min_len=3, nb_substeps=n)
    # CPU tensors take the plain version, never the kernel
    assert (hist_kernel.PLAIN_CALLS, hist_kernel.LAUNCHES) == (
        before[0] + 1, before[1])
    assert got.shape == (T, S) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10)
    # every frame of a track of 2 frames or more sits in one segment
    frames = (got.numpy() * np.arange(1, T + 1)[:, None]).sum()
    np.testing.assert_allclose(frames, lengths[lengths >= 2].sum(),
                               rtol=1e-10)


def test_window_histogram_matches_pallas_interpret():
    xs, lengths, isbl, jt, _ = _case(7, 2, 20, 7, dtype=np.float32)
    lengths[3] = 2
    want = np.asarray(pallas_hist.hist_pallas(
        jnp.asarray(xs), jnp.asarray(lengths), jnp.asarray(isbl), jt,
        window=4, min_len=3, interpret=True))
    tt = ttables.tables_from_numpy(
        {f: np.asarray(getattr(jt, f)) for f in jt._fields}, "cpu",
        torch.float64)
    got = thist.window_segment_histogram(
        torch.tensor(xs, dtype=torch.float64), torch.tensor(lengths),
        torch.tensor(isbl, dtype=torch.float64), tt, window=4, min_len=3)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-4)


def test_segment_tables_layout():
    """K5's static tables are the plain version's, slot axis last."""
    S, W, T = 3, 3, 5
    seg, ext = hist_kernel.segment_tables(S, W, T)
    spec = tengine.make_register_spec(S, W, 1)
    seg_int, seg_all, ext0 = thist._segment_tables(spec.codes, W, T, S)
    assert seg.shape == (W + 2, S * T, S ** W) and seg.dtype == np.float32
    np.testing.assert_array_equal(ext, ext0)
    for v in range(W + 1):
        np.testing.assert_array_equal(
            seg[v], seg_all[v].transpose(2, 1, 0).reshape(S * T, -1))
    np.testing.assert_array_equal(
        seg[W + 1], seg_int.transpose(2, 1, 0).reshape(S * T, -1))


def _group_rows_histogram(positions, lengths, is_bleached, tb, window,
                          min_len):
    """K5's algorithm (csrc/hist.cu) in torch f64: run/hist rows per fusion
    group, each bin mixed once, the branch-free drop (run(0) = 1 - w_q,
    run(r) = w_q run_q(r-1), hist_s += w_s run_s for s != q), bin 0 as the
    only initialised bin and a harvest that reads only the bins written.
    Unwritten bins hold NaN, so a read of one shows in the result."""
    B, T, D = positions.shape
    S, W = tb.nb_states, window
    spec = tengine.make_register_spec(S, W, 1)
    K, A, G = spec.K, spec.A, spec.G
    f64 = dict(dtype=torch.float64)
    lengths = torch.as_tensor(lengths, dtype=torch.int64)
    isbl = torch.as_tensor(is_bleached, **f64)[None, :]
    wk = tengine.walk_setup(positions, tb, spec)
    m, s2, lp = wk.m, wk.s2, wk.lp
    seg_np, ext_np = hist_kernel.segment_tables(S, W, T)
    seg = torch.tensor(seg_np, **f64)                       # (W+2, ST, K)
    ext = torch.tensor(ext_np.astype(np.int64))
    gc, sc = torch.arange(K) % G, torch.arange(K) % S
    q = torch.arange(G) % S
    mb0 = (torch.arange(G) * S) % G
    nan = float("nan")
    run = torch.full((T, G, B), nan, **f64)
    hist = torch.full((S, T, G, B), nan, **f64)
    run[0], hist[:, 0] = 1.0, 0.0
    out = torch.zeros(S * T, **f64)
    for t in range(1, T):
        x_t, l2_t = wk.xs_pos[t], wk.xs_l2[t]
        tot = l2_t[:, None, :] + s2
        lc = (-0.5 * torch.log(2 * np.pi * tot)
              - (x_t[:, None, :] - m) ** 2 / (2 * tot)).sum(0)   # (K, B)
        # harvest of the tracks that end here
        pbar = (torch.softmax(lp + isbl * wk.end_k + lc, 0)
                * (t == lengths - 1)[None, :])
        carry, nw = t + 1 > W, min(t, T)
        sg = seg[W + 1 if carry else t + 1]
        for j in range(S * T):
            s, mb = divmod(j, T)
            tj = sg[j][:, None].expand(K, B)
            if mb < nw:
                tj = tj + hist[s, mb, gc]
            if carry:
                src = mb - ext + 1
                ok = (sc == s) & (src >= 0) & (src < nw)
                tj = tj + torch.where(ok[:, None],
                                      run[src.clamp(0, T - 1), gc], 0.0)
            out[j] += (torch.where(pbar > 0, pbar * tj, 0.0)).sum()
        # fusion: one set of member weights per group
        new_m = (m * l2_t[:, None, :] + x_t[:, None, :] * s2) / tot
        tail = l2_t[:, None, :] * s2 / tot
        _, wn, lp_new, m_f, _, s2_new = tengine.branch_fuse(
            lp, lc, new_m, tail, wk.sig2_ag_at(t), float(t + 1 >= min_len),
            wk.lt_b, wk.lsurv_b, G, A)
        # the members' weights without the children's transition terms;
        # where those are finite they cancel, and every child of a group
        # has the group's weights (the log floor of a forbidden transition
        # rounds them, on children that carry no posterior weight)
        w = torch.softmax((lp + lc).reshape(G, A, B), dim=1)  # (G, O, B)
        ok = wk.lt_b[:, :, 0, 0] > -1e10
        torch.testing.assert_close(wn[ok], w[None].expand_as(wn)[ok],
                                   rtol=1e-12, atol=1e-15)
        drop, nb, nold = t >= W - 1, min(t + 1, T), min(t, T)
        new_run = torch.full_like(run, nan)
        new_hist = torch.full_like(hist, nan)
        wq = w.gather(1, q[:, None, None].expand(G, 1, B))[:, 0]
        if drop:
            new_run[0] = 1.0 - wq
            for r in range(1, nb):
                new_run[r] = wq * run[r - 1, mb0 + q]
        else:
            for r in range(nold):
                new_run[r] = sum(w[:, o] * run[r, mb0 + o] for o in range(S))
        for s in range(S):
            cs = torch.where((q != s)[:, None] & drop, w[:, s], 0.0)
            for r in range(nold):
                new_hist[s, r] = sum(w[:, o] * hist[s, r, mb0 + o]
                                     for o in range(S)) + cs * run[r, mb0 + s]
        if nold < nb:
            if not drop:
                new_run[nold] = 0.0
            new_hist[:, nold] = 0.0
        keep = (t < lengths - 1)[None, :]
        m = torch.where(keep[None], m_f.reshape(D, K, B), m)
        s2 = torch.where(keep[None], s2_new.reshape(D, K, B), s2)
        lp = torch.where(keep, lp_new.reshape(K, B), lp)
        run = torch.where(keep, new_run, run)
        hist = torch.where(keep, new_hist, hist)
    return out.reshape(S, T).T


@pytest.mark.parametrize("S,W,T", [(2, 5, 9), (3, 3, 7), (2, 3, 2),
                                   (2, 6, 4), (4, 2, 6)])
def test_group_rows_match_window_histogram(S, W, T):
    """K5 keeps one run/hist row per fusion group, mixes each bin once with
    a branch-free drop and zeroes only bin 0: the same histogram as the
    plain version, to 1e-10 in float64."""
    xs, lengths, isbl, _, tt = _case(S * 10 + W + T, S, 17, T)
    args = (torch.tensor(xs), torch.tensor(lengths), torch.tensor(isbl), tt)
    want = thist.window_segment_histogram(*args, window=W, min_len=2)
    got = _group_rows_histogram(*args, window=W, min_len=2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10,
                               atol=1e-12)


def test_decoders_match_jax_exactly():
    rng = np.random.default_rng(3)
    B, M, T, S = 9, 4, 7, 3
    seqs = rng.integers(0, S, (B, M, T))
    weights = rng.integers(0, 9, (B, M)) / 8.0          # exact sums
    lengths = rng.integers(0, T + 1, B)
    want = np.asarray(jhist.decode_segments(
        jnp.asarray(seqs, jnp.int8), jnp.asarray(weights),
        jnp.asarray(lengths), S))
    got = thist.decode_segments(torch.tensor(seqs), torch.tensor(weights),
                                torch.tensor(lengths), S)
    np.testing.assert_array_equal(got.numpy(), want)
    all_Bs = {"3": rng.integers(0, 2, (5, 3)), "6": rng.integers(0, 2, (4, 6)),
              "2": np.zeros((0, 2), int)}
    for long_tracks in (False, True):
        np.testing.assert_array_equal(
            thist.ground_truth_hist(all_Bs, 2, long_tracks, 5),
            jhist.ground_truth_hist(all_Bs, 2, long_tracks, 5))


@pytest.fixture(scope="module")
def sim():
    tracks, states, _ = jsim.sim_fov(
        nb_tracks=90, max_track_len=9, min_track_len=2, LocErr=0.02,
        Ds=(0.0, 0.08), dt=0.02, pBL=0.1, cell_dims=(0.5, None, None),
        seed=11)
    values = {"LocErr": 0.021, "D0": 0.001, "D1": 0.07, "F0": 0.45,
              "F1": 0.55, "p01": 0.08, "p10": 0.0, "pBL": 0.09}
    return tracks, states, values


def test_len_hist_matches_jax_and_ignores_buckets(sim):
    tracks, _, values = sim
    want = jhist.len_hist(tracks, values, 0.02, cell_dims=(0.5,),
                          nb_states=2, window=5)
    before = hist_kernel.PLAIN_CALLS
    got = thist.len_hist(tracks, values, 0.02, cell_dims=(0.5,),
                         nb_states=2, window=5, device="cpu")
    batches = tdata.from_dict_bucketed(tracks, max_buckets=4, device="cpu")
    assert hist_kernel.PLAIN_CALLS == before + len(batches)
    assert got.shape == want.shape == (9, 2)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-9, atol=1e-9)
    # one padded batch gives the same histogram as the 4 buckets
    one = thist.hist_batch(tdata.from_dict(tracks, device="cpu"), values, 0.02,
                           cell_dims=(0.5,), window=5)
    np.testing.assert_allclose(got, one.numpy(), rtol=1e-12, atol=1e-12)


def test_hist_batch_chunks_and_engines(sim):
    tracks, _, values = sim
    batch = tdata.from_dict(tracks, device="cpu")
    whole = thist.hist_batch(batch, values, 0.02, cell_dims=(0.5,),
                             window=4)
    chunked = thist.hist_batch(batch, values, 0.02, cell_dims=(0.5,),
                               window=4, chunk=23)
    torch.testing.assert_close(chunked, whole, rtol=1e-12, atol=1e-12)
    # the JAX package's names of its two window implementations run the
    # port's one implementation per device
    before = hist_kernel.PLAIN_CALLS
    for engine in ("pallas", "xla"):
        assert torch.equal(thist.hist_batch(batch, values, 0.02,
                                            cell_dims=(0.5,), window=4,
                                            engine=engine), whole)
    assert hist_kernel.PLAIN_CALLS == before + 2
    with pytest.raises(NotImplementedError, match="nb_substeps > 1"):
        thist.hist_batch(batch, values, 0.02, engine="pallas", nb_substeps=2)
    with pytest.raises(ValueError, match="unknown engine"):
        thist.hist_batch(batch, values, 0.02, engine="exact")
    with pytest.raises(NotImplementedError, match="item 15"):
        thist.hist_batch(batch, values, 0.02, sharded=True)


def test_len_hist_defaults_to_the_card(sim):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run")
    with pytest.raises(RuntimeError, match="CUDA device"):
        thist.len_hist(sim[0], sim[2], 0.02, cell_dims=(0.5,))
