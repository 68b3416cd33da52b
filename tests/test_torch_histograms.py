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
from extrack_tpu.core import engine as jengine, tables as jtables
from extrack_tpu.ops import pallas_hist
from extrack_tpu_torch import data as tdata, histograms as thist
from extrack_tpu_torch.core import engine as tengine, tables as ttables
from extrack_tpu_torch.ops import forward_kernel, hist_kernel
from extrack_tpu_torch.parallel import mesh as pmesh
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)


def _case(seed, S, B, T, n=1, per_peak=False, dtype=np.float64, dt=None):
    """Random tracks and tables; ``dt`` "step" or "track": variable dt, a
    (T-1,) or (B, T-1) table of intervals uniform in 0.01..0.05, else
    0.02."""
    rng = np.random.default_rng(seed)
    xs = rng.normal(0, 0.06, (B, T, 2)).cumsum(1).astype(dtype)
    lengths = rng.integers(0, T + 1, B)
    lengths[:4] = (T, min(2, T), 1, 0)                  # 0/1-frame rows
    isbl = (rng.random(B) < 0.5).astype(dtype)
    rates = rng.uniform(0.03, 0.25, (S, S))
    rates[1, 0] = 0.0                                   # forbidden
    loc = (rng.uniform(0.01, 0.03, (B, T, 2)) if per_peak
           else np.float64(0.02))
    dts = {"step": lambda: rng.uniform(0.01, 0.05, T - 1),
           "track": lambda: rng.uniform(0.01, 0.05, (B, T - 1)),
           None: lambda: 0.02}[dt]()
    jt = jtables.build_tables(
        *(jnp.asarray(np.asarray(v, dtype)) for v in (
            np.linspace(0.0, 0.15, S), loc, rng.dirichlet(np.ones(S)),
            rates, 0.08, dts)),
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
    (3, 7, 1, 8, False, 1.0),    # len_hist's default window at 3 states:
    (3, 7, 1, 8, True, 1.0),     # K = 2187, K5's wide mapping on the card
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


@pytest.mark.parametrize("kind", ["step", "track"])
def test_window_histogram_with_variable_dt_matches_pallas_interpret(kind):
    """Per-step and per-track dt: the plain version (float64) against the
    Pallas kernel's streamed-sig2 path in interpret mode (float32)."""
    xs, lengths, isbl, jt, _ = _case(8, 2, 20, 7, dtype=np.float32, dt=kind)
    lengths[3] = 2
    want = np.asarray(pallas_hist.hist_pallas(
        jnp.asarray(xs), jnp.asarray(lengths), jnp.asarray(isbl), jt,
        window=4, min_len=3, interpret=True))
    tt = ttables.tables_from_numpy(
        {f: np.asarray(getattr(jt, f)) for f in jt._fields}, "cpu",
        torch.float64)
    assert forward_kernel.classify_sig2(tt.sig2, 7)
    got = thist.window_segment_histogram(
        torch.tensor(xs, dtype=torch.float64), torch.tensor(lengths),
        torch.tensor(isbl, dtype=torch.float64), tt, window=4, min_len=3)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("S,W,T,n", [(3, 3, 5, 1), (2, 5, 6, 2),
                                     (2, 7, 8, 3), (2, 3, 5, 2),
                                     (3, 5, 7, 2)])
def test_segment_tables_layout(S, W, T, n):
    """K5's static tables are the JAX package's (stride n), slot axis
    last: Wf+1 coverage rows and the interior row."""
    Wf = (W - 1) // n + 1
    seg, ext = hist_kernel.segment_tables(S, W, T, n)
    spec = jengine.make_register_spec(S, W, n)
    seg_int, seg_all, ext0 = jhist._segment_tables(spec.codes, W, T, S,
                                                   stride=n)
    assert seg.shape == (Wf + 2, S * T, S ** W) and seg.dtype == np.float32
    np.testing.assert_array_equal(ext, ext0)
    for v in range(Wf + 1):
        np.testing.assert_array_equal(
            seg[v], seg_all[v].transpose(2, 1, 0).reshape(S * T, -1))
    np.testing.assert_array_equal(
        seg[Wf + 1], seg_int.transpose(2, 1, 0).reshape(S * T, -1))


def _stream(tb, B, T):
    """The (B, T-1, P) displacement variances K5 reads with variable dt
    (forward_kernel.sig2_stream's layout), kept in float64."""
    s = tb.sig2 if tb.sig2.ndim == 3 else tb.sig2[None]
    return s.expand(B, T - 1, s.shape[-1])


def _group_rows_histogram(positions, lengths, is_bleached, tb, window,
                          min_len, nb_substeps=1):
    """K5's algorithm (csrc/hist.cu) in torch f64: run/hist rows per fusion
    group (A = S^n members, whose rows are those of groups (g*A + o) % G),
    each bin mixed once, the branch-free drop once per frame (run(0) = 1 -
    sum w_o and run(r) = sum w_o run_o(r-1) over the members o whose oldest
    state o % S is q, the group's state a frame newer; hist_s += w_o run_o
    over the members of oldest state s != q), bin 0 as the only
    initialised bin and a harvest that reads only the bins written.  The
    displacement variances come from the (B, T-1, P) stream at
    forward_kernel.stream_index's patterns (row 0 for the initial register,
    row t for the fusion at step t), as the kernel reads them with variable
    dt.  Unwritten bins hold NaN, so a read of one shows in the result."""
    B, T, D = positions.shape
    S, W, n = tb.nb_states, window, nb_substeps
    Wf = hist_kernel.window_frames(W, n)
    spec = tengine.make_register_spec(S, W, n)
    K, A, G = spec.K, spec.A, spec.G
    f64 = dict(dtype=torch.float64)
    lengths = torch.as_tensor(lengths, dtype=torch.int64)
    isbl = torch.as_tensor(is_bleached, **f64)[None, :]
    wk = tengine.walk_setup(positions, tb, spec)
    stream = _stream(tb, B, T)
    pat = torch.as_tensor(forward_kernel.stream_index(S, W, n)[0])
    m, lp = wk.m, wk.lp
    s2 = wk.xs_l2[0][:, None, :] + stream[:, 0, pat].T[None]
    seg_np, ext_np = hist_kernel.segment_tables(S, W, T, n)
    seg = torch.tensor(seg_np, **f64)                      # (Wf+2, ST, K)
    ext = torch.tensor(ext_np.astype(np.int64))
    gc, sc = torch.arange(K) % G, torch.arange(K) % S
    q = torch.arange(G) % S
    mrow = (torch.arange(G)[:, None] * A + torch.arange(A)) % G   # (G, A)
    old = torch.arange(A) % S
    goes_on = (old[None, :] == q[:, None])[..., None]            # (G, A, 1)
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
        carry, nw = t + 1 > Wf, min(t, T)
        sg = seg[Wf + 1 if carry else t + 1]
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
        _, wn, lp_new, m_f, tail_f, _ = tengine.branch_fuse(
            lp, lc, new_m, tail, wk.sig2_ag_at(t), float(t + 1 >= min_len),
            wk.lt_b, wk.lsurv_b, G, A)
        # the child's variance of step t from the stream's row t
        s2_new = (stream[:, min(t, T - 2), pat].T[None]
                  + tail_f.reshape(D, K, B))
        # the members' weights without the children's transition terms;
        # where those are finite they cancel, and every child of a group
        # has the group's weights (the log floor of a forbidden transition
        # rounds them, on children that carry no posterior weight)
        w = torch.softmax((lp + lc).reshape(G, A, B), dim=1)  # (G, O, B)
        ok = wk.lt_b[:, :, 0, 0] > -1e10
        torch.testing.assert_close(wn[ok], w[None].expand_as(wn)[ok],
                                   rtol=1e-12, atol=1e-15)
        drop, nb, nold = t >= Wf - 1, min(t + 1, T), min(t, T)
        new_run = torch.full_like(run, nan)
        new_hist = torch.full_like(hist, nan)

        def members(rows_r, sel=None):
            """sum over the members o (of ``sel`` (G, A, 1) only) of w_o
            times their row ``rows_r`` (G, B), read only where selected."""
            v = w * rows_r[mrow]                               # (G, A, B)
            if sel is not None:
                v = torch.where(sel, v, 0.0)
            return v.sum(1)

        if drop:
            new_run[0] = 1.0 - torch.where(goes_on, w, 0.0).sum(1)
            for r in range(1, nb):
                new_run[r] = members(run[r - 1], goes_on)
        else:
            for r in range(nold):
                new_run[r] = members(run[r])
        for s in range(S):
            ends = (drop & (q != s)[:, None, None]
                    & (old == s)[None, :, None])
            for r in range(nold):
                new_hist[s, r] = members(hist[s, r]) + members(run[r], ends)
        if nold < nb:
            if not drop:
                new_run[nold] = 0.0
            new_hist[:, nold] = 0.0
        keep = (t < lengths - 1)[None, :]
        m = torch.where(keep[None], m_f.reshape(D, K, B), m)
        s2 = torch.where(keep[None], s2_new, s2)
        lp = torch.where(keep, lp_new.reshape(K, B), lp)
        run = torch.where(keep, new_run, run)
        hist = torch.where(keep, new_hist, hist)
    return out.reshape(S, T).T


@pytest.mark.parametrize("S,W,T,n,dt", [
    (2, 5, 9, 1, None), (3, 3, 7, 1, None), (2, 3, 2, 1, None),
    (2, 6, 4, 1, None), (4, 2, 6, 1, None),
    (2, 5, 9, 1, "step"), (3, 3, 7, 1, "track"),
    (2, 5, 9, 2, None), (2, 5, 9, 2, "step"), (2, 5, 9, 2, "track"),
    (2, 7, 9, 2, None), (2, 7, 9, 2, "step"), (2, 7, 9, 2, "track"),
    (3, 5, 7, 2, None), (3, 5, 7, 2, "step"), (3, 5, 7, 2, "track"),
    (2, 7, 8, 3, None), (2, 7, 8, 3, "step"), (2, 7, 8, 3, "track"),
    (2, 3, 6, 2, "track"),      # Wf = 2: A = 4 members over G = 2 groups
])
def test_group_rows_match_window_histogram(S, W, T, n, dt):
    """K5 keeps one run/hist row per fusion group, mixes each bin once with
    a branch-free drop once per frame, zeroes only bin 0 and reads the
    displacement variances from the stream: the same histogram as the
    plain version, to 1e-10 in float64, at n sub-steps a frame and with
    constant, per-step and per-track dt."""
    xs, lengths, isbl, _, tt = _case(S * 10 + W + T + n, S, 17, T, n=n,
                                     dt=dt)
    args = (torch.tensor(xs), torch.tensor(lengths), torch.tensor(isbl), tt)
    want = thist.window_segment_histogram(*args, window=W, min_len=2,
                                          nb_substeps=n)
    got = _group_rows_histogram(*args, window=W, min_len=2, nb_substeps=n)
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
    np.testing.assert_allclose(got, one, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind", ["dt_dict", "substeps"])
def test_len_hist_with_dt_dict_and_substeps_matches_jax(sim, kind):
    """len_hist on the CPU with a per-track dt dict (mixed frame rates)
    and with two sub-steps a frame (window 4: W = 7 sub-steps, K = 128),
    each against JAX's len_hist on the same tracks, and frames conserved."""
    tracks, _, values = sim
    kw = dict(cell_dims=(0.5,), nb_states=2)
    if kind == "dt_dict":
        rng = np.random.default_rng(12)
        dt = {k: rng.uniform(0.01, 0.05, (v.shape[0], v.shape[1] - 1))
              for k, v in tracks.items()}
        kw["window"] = 5
    else:
        dt = 0.02
        kw.update(window=4, nb_substeps=2)
    want = jhist.len_hist(tracks, values, dt, **kw)
    got = thist.len_hist(tracks, values, dt, device="cpu", **kw)
    assert got.shape == want.shape == (9, 2)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-8, atol=1e-8)
    frames = (got * np.arange(1, 10)[:, None]).sum()
    np.testing.assert_allclose(
        frames, sum(v.shape[0] * v.shape[1] for v in tracks.values()
                    if v.shape[1] >= 2), rtol=1e-10)


def test_len_hist_three_states_at_the_default_window_matches_jax():
    """The README workflow's histogram at 3 states and JAX's default
    window 7 (K = 2187, past the 1024 slots of a thread a slot: the card
    runs K5's wide mapping), on the CPU against JAX's len_hist."""
    tr = np.full((3, 3), 0.05) + np.eye(3) * 0.85
    tracks, _, _ = jsim.sim_fov(
        nb_tracks=16, max_track_len=9, min_track_len=3, LocErr=0.02,
        Ds=(0.0, 0.02, 0.1), TrMat=tr, dt=0.02, pBL=0.1,
        cell_dims=(0.5, None, None), seed=4)
    values = {"LocErr": 0.02, "D0": 0.0, "D1": 0.02, "D2": 0.1,
              "F0": 0.3, "F1": 0.3, "F2": 0.4, "pBL": 0.1,
              **{f"p{i}{j}": 0.05 for i in range(3) for j in range(3)
                 if i != j}}
    want = jhist.len_hist(tracks, values, 0.02, cell_dims=(0.5,),
                          nb_states=3)
    got = thist.len_hist(tracks, values, 0.02, cell_dims=(0.5,),
                         nb_states=3, device="cpu")
    T = max(int(k) for k in tracks)
    assert got.shape == want.shape == (T, 3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-9, atol=1e-9)
    frames = (got * np.arange(1, T + 1)[:, None]).sum()
    np.testing.assert_allclose(
        frames, sum(v.shape[0] * v.shape[1] for v in tracks.values()),
        rtol=1e-10)


@pytest.mark.parametrize("S,n", [(4, 1), (2, 2)])
def test_len_hist_past_4096_slots_at_the_default_window_matches_jax(S, n):
    """len_hist at JAX's default window 7 past 4096 slots: 4 states (K =
    4^7 = 16384) and 2 states at two sub-steps a frame (13 sub-steps, K =
    2^13 = 8192).  The card runs K5's wide mapping with its carries in
    global scratch where shared memory cannot hold them; here the plain
    version against JAX's len_hist, and frames conserved."""
    tr = np.full((S, S), 0.05) + np.eye(S) * (1 - 0.05 * S)
    Ds = tuple(np.linspace(0.0, 0.1, S))
    tracks, _, _ = jsim.sim_fov(
        nb_tracks=8, max_track_len=8, min_track_len=3, LocErr=0.02,
        Ds=Ds, TrMat=tr, dt=0.02, pBL=0.1, cell_dims=(0.5, None, None),
        seed=4 + S + n)
    values = {"LocErr": 0.02, "pBL": 0.1,
              **{f"D{i}": d for i, d in enumerate(Ds)},
              **{f"F{i}": 1 / S for i in range(S)},
              **{f"p{i}{j}": 0.05 for i in range(S) for j in range(S)
                 if i != j}}
    kw = dict(cell_dims=(0.5,), nb_states=S, nb_substeps=n)
    before = hist_kernel.PLAIN_CALLS
    got = thist.len_hist(tracks, values, 0.02, device="cpu", **kw)
    assert hist_kernel.PLAIN_CALLS > before
    want = jhist.len_hist(tracks, values, 0.02, **kw)
    T = max(int(k) for k in tracks)
    assert got.shape == want.shape == (T, S)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-9, atol=1e-9)
    frames = (got * np.arange(1, T + 1)[:, None]).sum()
    np.testing.assert_allclose(
        frames, sum(v.shape[0] * v.shape[1] for v in tracks.values()),
        rtol=1e-10)


def test_hist_batch_chunks_and_engines(sim):
    tracks, _, values = sim
    batch = tdata.from_dict(tracks, device="cpu")
    whole = thist.hist_batch(batch, values, 0.02, cell_dims=(0.5,),
                             window=4)
    chunked = thist.hist_batch(batch, values, 0.02, cell_dims=(0.5,),
                               window=4, chunk=23)
    np.testing.assert_allclose(chunked, whole, rtol=1e-12, atol=1e-12)
    # the JAX package's names of its two window implementations run the
    # port's one implementation per device
    before = hist_kernel.PLAIN_CALLS
    for engine in ("pallas", "xla"):
        assert np.array_equal(thist.hist_batch(batch, values, 0.02,
                                               cell_dims=(0.5,), window=4,
                                               engine=engine), whole)
    assert hist_kernel.PLAIN_CALLS == before + 2
    with pytest.raises(NotImplementedError, match="nb_substeps > 1"):
        thist.hist_batch(batch, values, 0.02, engine="pallas", nb_substeps=2)
    with pytest.raises(ValueError, match="unknown engine"):
        thist.hist_batch(batch, values, 0.02, engine="exact")
    # sharded: one CPU shard bit for bit; three shards of 23-track
    # chunks (69 tracks a chunk) within rounding
    assert np.array_equal(thist.hist_batch(batch, values, 0.02,
                                           cell_dims=(0.5,), window=4,
                                           sharded=True), whole)
    np.testing.assert_allclose(thist.hist_batch(
        batch, values, 0.02, cell_dims=(0.5,), window=4, chunk=23,
        sharded=pmesh.make_mesh(devices=["cpu"] * 3)), whole, rtol=1e-12,
        atol=1e-12)


def test_len_hist_defaults_to_the_card(sim):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run")
    with pytest.raises(RuntimeError, match="CUDA device"):
        thist.len_hist(sim[0], sim[2], 0.02, cell_dims=(0.5,))
