"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc (the kernels have no CPU mode) and
skip without one.  They import no JAX, so on a machine without it they run
as ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
Tolerances (float32): per-track logL rtol 2e-5 / atol 2e-4; value rtol
2e-5; table gradients rtol/atol 2e-3; Hessian columns rtol 5e-3 / atol
1e-3 max|H| and symmetry 2e-3 max|H| (as tests/test_hvp.py holds the TPU
kernel); posteriors' logL rtol/atol 2e-4, posteriors rtol 2e-3 / atol 2e-4
(as tests/test_pallas_predict.py); histograms rtol 2e-3 / atol 2e-4 (as
tests/test_pallas_hist.py); refined mu rtol 2e-4 / atol 2e-5 and sigma rtol
2e-3 / atol 2e-5 (as tests/test_pallas_refine.py); top-K histograms rtol
1e-5 / atol 1e-5 max|hist| (the kernel and the plain version keep the same
sequences, stably; only the f32 rounding of the sums differs), final
weights of an unpruned register rtol 1e-4 / atol 1e-5.  Variable dt (the
streamed displacement-variance table of K1..K5) and K5 past one sub-step
are held to the same tolerances (K5 there against the plain version in
float64 on the same inputs), and so are K1, K4, K5 and K6 on their wide
mapping (a thread a fusion group), past 1024 slots up to 4096 and forced
onto the small registers of the other tests, K4 and K5 past 4096 up to
16384 slots (the JAX package's defaults of ``predict_Bs`` at 6 states
and ``len_hist`` at 4 states or two sub-steps among them), with their
carries in shared memory or, where that cannot hold them, global scratch,
and K4 past 16384 up to 65536 (``predict_Bs`` at 7 states, the GUI's
labeling window at 3 states), K1, K2 and K3 up to 65536 slots and 16384
fusion groups (the GUI's Model Fitting at 6 states).  K7 reads the
streamed table of variable dt too, held to the same tolerances as with a
constant dt, and past 1024 register rows (up to 4096) runs its wide
kernel, held to the same tolerances.
The HMC sampler runs its gradients on K2 alone (its launches by the
formula in ``sample``'s docstring) and draws the same samples for any
``dispatch_chunk``; the device simulators run on the card by default.
"""
import numpy as np
import pytest
import torch

from extrack_tpu_torch import data, fit, histograms, params, sample, \
    simulate
from extrack_tpu_torch.core import tables
from extrack_tpu_torch.ops import (cuda_lib, forward_kernel, grad_kernel,
                                   hist_kernel, hvp_kernel, predict_kernel,
                                   refine_kernel, topk_kernel)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _case(dev, S, n, B, T, D, seed=5, per_peak=False, dt=None):
    """Random tracks (lengths 0..T) and f32 tables with a forbidden
    transition.  ``dt`` "step" or "track": variable dt, a (T-1,) or (B, T-1)
    table of intervals uniform in 0.01..0.05 (a track's steps from its
    length on at the median, as data.from_dict pads them); else 0.02."""
    rng = np.random.default_rng(seed)
    xs = rng.normal(0, 0.06, (B, T, D)).cumsum(1)
    lengths = rng.integers(0, T + 1, B)
    lengths[:2] = (T, 2)
    isbl = (lengths < T).astype(np.float32)
    f32 = dict(dtype=torch.float32, device=dev)
    l2 = rng.uniform(1e-4, 9e-4, (B, T, D)) if per_peak else None
    dts = 0.02
    if dt == "step":
        dts = torch.tensor(rng.uniform(0.01, 0.05, T - 1), **f32)
    elif dt == "track":
        d = rng.uniform(0.01, 0.05, (B, T - 1))
        d[np.arange(T - 1)[None, :] >= lengths[:, None] - 1] = np.median(d)
        dts = torch.tensor(d, **f32)
    rates = torch.full((S, S), 0.08, **f32)
    rates[0, -1] = 0.0
    tb = tables.build_tables(
        torch.linspace(0, 0.12, S, **f32), torch.tensor(0.02, **f32),
        torch.full((S,), 1.0 / S, **f32), rates, torch.tensor(0.1, **f32),
        dts, cell_dims=(0.8,), nb_substeps=n)
    if per_peak:
        tb = tb._replace(loc_err2=torch.tensor(l2, **f32))
    return (torch.tensor(xs, **f32),
            torch.tensor(lengths, dtype=torch.int32, device=dev),
            torch.tensor(isbl, **f32), tb)


@pytest.mark.cuda
@pytest.mark.parametrize("S,W,n,B,T,D", [(2, 6, 1, 300, 9, 2),
                                         (3, 4, 2, 77, 7, 3),
                                         (2, 4, 1, 3, 2, 1)])
def test_cuda_kernels_match_plain(cuda, S, W, n, B, T, D):
    args = _case(cuda, S, n, B, T, D)
    kw = dict(window=W, nb_substeps=n, min_len=2)
    launches = forward_kernel.LAUNCHES, grad_kernel.LAUNCHES
    torch.testing.assert_close(forward_kernel.forward(*args, **kw),
                               forward_kernel.forward_plain(*args, **kw),
                               rtol=2e-5, atol=2e-4)
    v, g = grad_kernel.value_and_table_grads(*args, **kw)
    v0, g0 = grad_kernel.value_and_table_grads_plain(*args, **kw)
    assert (forward_kernel.LAUNCHES, grad_kernel.LAUNCHES) == (
        launches[0] + 1, launches[1] + 1)
    torch.testing.assert_close(v, v0, rtol=2e-5, atol=0.0)
    for k in g:
        torch.testing.assert_close(g[k], g0[k], rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
def test_cuda_value_only_and_envelope(cuda):
    pos, lens, isbl, tb = _case(cuda, 2, 1, 50, 6, 2)
    before = forward_kernel.LAUNCHES, grad_kernel.LAUNCHES
    with torch.no_grad():
        v = grad_kernel.neg_log_likelihood(pos, lens, isbl, tb, window=4)
    assert (forward_kernel.LAUNCHES, grad_kernel.LAUNCHES) == (
        before[0] + 1, before[1])
    torch.testing.assert_close(
        v, grad_kernel.neg_log_likelihood_plain(pos, lens, isbl, tb,
                                                window=4), rtol=2e-5,
        atol=0.0)
    # a per-track table (variable dt) streams through K1 and K2: here every
    # track's rows are the constant table's
    per_track = tb._replace(sig2=tb.sig2.expand(50, 5, -1))
    with torch.no_grad():
        v_dt = grad_kernel.neg_log_likelihood(pos, lens, isbl, per_track,
                                              window=4)
    torch.testing.assert_close(v_dt, v, rtol=2e-5, atol=0.0)
    v_dt, g_dt = grad_kernel.value_and_table_grads(pos, lens, isbl,
                                                   per_track, window=4)
    v0, g0 = grad_kernel.value_and_table_grads_plain(pos, lens, isbl,
                                                     per_track, window=4)
    torch.testing.assert_close(v_dt, v0, rtol=2e-5, atol=0.0)
    for k in g0:
        torch.testing.assert_close(g_dt[k], g0[k], rtol=2e-3, atol=2e-3)
    before = (before[0] + 2, before[1] + 1)
    assert (forward_kernel.LAUNCHES, grad_kernel.LAUNCHES) == before
    # a float64 input raises instead of running the kernel in float32
    with pytest.raises(NotImplementedError, match="float64"):
        grad_kernel.neg_log_likelihood(pos.double(), lens, isbl, tb, window=4)
    with pytest.raises(NotImplementedError, match="float64"):
        forward_kernel.forward(pos, lens, isbl,
                               tb._replace(log_trans=tb.log_trans.double()),
                               window=4)
    assert (forward_kernel.LAUNCHES, grad_kernel.LAUNCHES) == before


# (S, W, n, B, T, D, dt): variable dt on K1, K2 and K4 (one sub-step), per
# step and per track: the warp mapping at K = 64 (and forced onto the block
# mapping, K1 onto the wide one), the block mapping at K = 243 (K1: the
# wide one), two sub-steps, D = 1 and 3, and
# T = 2 per track (a per-step table at T = 2 is one row: a constant dt)
DT_CASES = [c + (dt,) for c in [
    (2, 6, 1, 300, 9, 2), (3, 5, 1, 120, 9, 2), (2, 4, 2, 200, 8, 2),
    (2, 4, 1, 150, 9, 1), (2, 3, 1, 150, 12, 3)] for dt in ("step", "track")
] + [(2, 4, 1, 60, 2, 2, "track")]


@pytest.mark.cuda
@pytest.mark.parametrize("S,W,n,B,T,D,dt", DT_CASES)
def test_cuda_variable_dt_matches_plain(cuda, monkeypatch, S, W, n, B, T, D,
                                        dt):
    args = _case(cuda, S, n, B, T, D, seed=11, per_peak=(D == 1), dt=dt)
    tb = args[3]
    assert forward_kernel.classify_sig2(tb.sig2, T)
    kw = dict(window=W, nb_substeps=n, min_len=2)
    want = forward_kernel.forward_plain(*args, **kw)
    v0, g0 = grad_kernel.value_and_table_grads_plain(*args, **kw)
    K = S ** W
    for warp_max in ((64, 0) if K <= 64 else (64,)):
        monkeypatch.setattr(forward_kernel, "WARP_MAX_K", warp_max)
        monkeypatch.setattr(grad_kernel, "WARP_MAX_K", warp_max)
        before = forward_kernel.LAUNCHES, grad_kernel.LAUNCHES
        torch.testing.assert_close(forward_kernel.forward(*args, **kw), want,
                                   rtol=2e-5, atol=2e-4)
        v, g = grad_kernel.value_and_table_grads(*args, **kw)
        assert (forward_kernel.LAUNCHES, grad_kernel.LAUNCHES) == (
            before[0] + 1, before[1] + 1)
        torch.testing.assert_close(v, v0, rtol=2e-5, atol=0.0)
        for k in g:
            torch.testing.assert_close(g[k], g0[k], rtol=2e-3, atol=2e-3)
    monkeypatch.undo()
    # K2's stream cotangent: rows from each track's length on are exactly 0,
    # and s20, sig2v and s2n (unread) get none
    data_, tabs = _kernel_args(args, W, n)
    assert len(tabs) == 11
    _, _, cts = grad_kernel.launch(data_, tabs, 2)
    L = args[1].cpu().numpy()
    dead = np.arange(T - 1)[None, :] >= L[:, None] - 1
    assert bool((cts[10][torch.tensor(dead, device=cuda)] == 0).all())
    assert bool((cts[10][torch.tensor(~dead, device=cuda)] != 0).any())
    for i in (1, 5, 7):
        assert bool((cts[i] == 0).all())
    if n == 1:
        logl0, preds0 = predict_kernel.predict_plain(*args, window=W,
                                                     min_len=2)
        logl, preds = predict_kernel.predict(*args, window=W, min_len=2)
        torch.testing.assert_close(logl, logl0, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(preds, preds0, rtol=2e-3, atol=2e-4)
        for mapping in (("warp", "block") if K <= 64 else ("block",)):
            for stash in ("smem", "global"):
                logl, preds = predict_kernel.launch(
                    data_, tabs, 2, S, W, mapping=mapping, stash=stash)
                torch.testing.assert_close(logl, logl0, rtol=2e-4,
                                           atol=2e-4)
                torch.testing.assert_close(preds, preds0, rtol=2e-3,
                                           atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("S,W,n", [(2, 6, 1), (3, 5, 1), (2, 4, 2)])
def test_cuda_stream_of_constant_dt_matches_constant_kernels(cuda, S, W, n):
    # the constant table streamed gives the constant-dt kernels' results
    args = _case(cuda, S, n, 300, 9, 2)
    data_, tabs = _kernel_args(args, W, n)
    stream = forward_kernel.sig2_stream(args[3].sig2, 300, 9)
    torch.testing.assert_close(
        forward_kernel.launch(data_, tabs + [stream], 2),
        forward_kernel.launch(data_, tabs, 2), rtol=1e-6, atol=1e-5)
    got = grad_kernel.launch(data_, tabs + [stream], 2)
    ref = grad_kernel.launch(data_, tabs, 2)
    torch.testing.assert_close(got[0], ref[0], rtol=1e-6, atol=1e-5)
    # the stream's cotangent, summed over tracks and rows, is the constant
    # sig2 row's, gathered from s20, sig2v and s2n
    pat, nxt = forward_kernel.stream_index(S, W, n)
    P = S ** (n + 1)
    row = torch.zeros(P, dtype=torch.float64, device=cuda)
    for i, idx in ((1, pat), (5, pat), (7, nxt)):
        row.index_add_(0, torch.tensor(idx.ravel(), device=cuda),
                       ref[2][i].double().ravel())
    torch.testing.assert_close(got[2][10].double().sum((0, 1)), row,
                               rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("W,dt", [(4, "track"), (6, "step")])
def test_cuda_k3_variable_dt_mappings_agree(cuda, W, dt):
    # K3 with the stream's tangent in and its cotangent pair out, on both
    # mappings
    args = _case(cuda, 2, 1, 200, 9, 2, dt=dt)
    data_, tabs = _kernel_args(args, W)
    rng = np.random.default_rng(W)
    dots = [torch.tensor(rng.normal(0, 1e-3, t.shape), dtype=torch.float32,
                         device=cuda) for t in tabs]
    l2_dot = torch.zeros_like(data_[1])
    warp = hvp_kernel.launch(data_, tabs, l2_dot, dots, 2, mapping="warp")
    block = hvp_kernel.launch(data_, tabs, l2_dot, dots, 2, mapping="block")
    assert len(warp[2][0]) == len(warp[2][1]) == 11
    for a, b in zip(warp[2][0] + warp[2][1], block[2][0] + block[2][1]):
        torch.testing.assert_close(a, b, rtol=2e-4,
                                   atol=2e-5 * float(b.abs().max()))
    L = args[1].cpu().numpy()
    dead = torch.tensor(np.arange(8)[None, :] >= L[:, None] - 1, device=cuda)
    for c in (warp[2][0][10], warp[2][1][10]):
        assert bool((c[dead] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("S,W,n", [(2, 4, 1), (2, 3, 2), (3, 3, 1)])
def test_cuda_hessian_columns_per_track_dt_match_plain(cuda, S, W, n):
    rng = np.random.default_rng(S + W + n + 40)
    B, T = 200, 8
    lengths = rng.integers(1, T + 1, B)
    lengths[:2] = (T, 2)
    tracks, dts = {}, {}
    for L in range(1, T + 1):
        nb = int((lengths == L).sum())
        if nb:
            tracks[str(L)] = rng.normal(0, 0.05, (nb, L, 2)).cumsum(1)
            dts[str(L)] = rng.uniform(0.01, 0.05, (nb, max(L - 1, 0)))
    buckets = data.from_dict_bucketed(tracks, max_buckets=2, dt=dts,
                                      device=cuda, dtype=torch.float32)
    assert all(b.dt is not None for b in buckets)
    spec = params.generate_params(nb_states=S, D_max=1.0)
    spec.add("p01", 0.0, vary=False)                   # forbidden transition
    z = spec.to_unconstrained()
    kw = dict(cell_dims=(0.8,), nb_substeps=n, window=W, min_len=2)
    before = hvp_kernel.LAUNCHES, hvp_kernel.PLAIN_CALLS
    H = fit.hessian_hvp_columns(buckets, spec, z, 0.02, S, **kw)
    assert (hvp_kernel.LAUNCHES, hvp_kernel.PLAIN_CALLS) == (
        before[0] + len(z) * len(buckets), before[1])
    saved = hvp_kernel.table_hvp
    hvp_kernel.table_hvp = hvp_kernel.table_hvp_plain
    try:
        H0 = fit.hessian_hvp_columns(buckets, spec, z, 0.02, S, **kw)
    finally:
        hvp_kernel.table_hvp = saved
    scale = np.abs(H0).max()
    np.testing.assert_allclose(H, H0, rtol=5e-3, atol=1e-3 * scale)
    np.testing.assert_allclose(H, H.T, atol=2e-3 * scale)


@pytest.mark.cuda
def test_cuda_histograms_with_variable_dt_raise_naming_the_kernel(cuda):
    # K5 and K7 read the streamed table: each matches its plain version,
    # and len_hist with a dt dict matches the CPU's on both engines
    pos, lens, isbl, tb = _case(cuda, 2, 1, 40, 8, 2, dt="track")
    before = hist_kernel.LAUNCHES, hist_kernel.PLAIN_CALLS
    got = hist_kernel.hist(pos, lens, isbl, tb, window=5, min_len=2)
    assert (hist_kernel.LAUNCHES, hist_kernel.PLAIN_CALLS) == (
        before[0] + 1, before[1])
    torch.testing.assert_close(
        got, hist_kernel.hist_plain(pos, lens, isbl, tb, window=5,
                                    min_len=2), rtol=2e-3, atol=2e-4)
    before = topk_kernel.LAUNCHES, topk_kernel.PLAIN_CALLS
    got = topk_kernel.segment_topk(pos, lens, isbl, tb, max_nb_states=64,
                                   min_len=2)
    assert (topk_kernel.LAUNCHES, topk_kernel.PLAIN_CALLS) == (
        before[0] + 1, before[1])
    want = topk_kernel.segment_topk_plain(pos, lens, isbl, tb,
                                          max_nb_states=64, min_len=2)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    rng = np.random.default_rng(3)
    tracks = {"6": rng.normal(0, 0.05, (20, 6, 2)).cumsum(1)}
    values = {"LocErr": 0.02, "D0": 0.0, "D1": 0.08, "F0": 0.5, "F1": 0.5,
              "p01": 0.1, "p10": 0.1, "pBL": 0.1}
    dts = {"6": np.full((20, 5), 0.03)}
    h = histograms.len_hist(tracks, values, dts, nb_states=2, window=5)
    h0 = histograms.len_hist(tracks, values, dts, nb_states=2, window=5,
                             device="cpu")
    np.testing.assert_allclose(h, h0, rtol=2e-3, atol=2e-4)
    dts = {"6": rng.uniform(0.01, 0.05, (20, 5))}
    before = topk_kernel.LAUNCHES, topk_kernel.PLAIN_CALLS
    h = histograms.len_hist(tracks, values, dts, nb_states=2, engine="topk")
    assert (topk_kernel.LAUNCHES, topk_kernel.PLAIN_CALLS) == (
        before[0] + 1, before[1])
    h0 = histograms.len_hist(tracks, values, dts, nb_states=2, engine="topk",
                             device="cpu")
    np.testing.assert_allclose(h, h0, rtol=2e-3, atol=2e-4)


# K5 with variable dt and past one sub-step: (S, W, n, B, T, D, dt);
# A = S^n children a group (2, 4, 8, 9), A not dividing G (W = n+1), the
# 1024-thread block (K = 729) and rows in global scratch (K = 512, T = 80)
HIST_DT_CASES = [
    (2, 7, 1, 300, 9, 2, "track"), (3, 5, 1, 77, 12, 3, "step"),
    (2, 5, 2, 300, 9, 2, None), (2, 7, 2, 300, 10, 2, "track"),
    (2, 9, 2, 60, 80, 2, "step"), (3, 5, 2, 77, 9, 1, "track"),
    (2, 7, 3, 64, 9, 2, "track"), (2, 3, 2, 40, 6, 2, None),
    (3, 6, 1, 12, 8, 2, "track"), (2, 2, 1, 40, 5, 3, "step")]


@pytest.mark.cuda
@pytest.mark.parametrize("S,W,n,B,T,D,dt", HIST_DT_CASES)
def test_cuda_histogram_variable_dt_and_substeps_match_plain(
        cuda, S, W, n, B, T, D, dt):
    pos, lens, isbl, tb = _case(cuda, S, n, B, T, D, dt=dt)
    kw = dict(window=W, min_len=2, nb_substeps=n)
    got = hist_kernel.hist(pos, lens, isbl, tb, **kw)
    assert torch.equal(got, hist_kernel.hist(pos, lens, isbl, tb, **kw))
    want = hist_kernel.hist_plain(pos.double(), lens, isbl.double(),
                                  tables.ModelTables(*(f.double()
                                                       for f in tb)), **kw)
    torch.testing.assert_close(got.double(), want, rtol=2e-3, atol=2e-4)
    L = lens.cpu().numpy()
    frames = float((got.cpu().double()
                    * torch.arange(1, T + 1)[:, None]).sum())
    np.testing.assert_allclose(frames, L[L >= 2].sum(), rtol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("S,W,n,D", [(2, 4, 1, 2), (2, 3, 2, 1), (3, 3, 1, 3)])
def test_cuda_hessian_columns_match_plain(cuda, S, W, n, D):
    rng = np.random.default_rng(S + W + n)
    B, T = 200, 8
    lengths = rng.integers(0, T + 1, B)
    lengths[:2] = (T, 2)
    tracks = {}
    for L in range(1, T + 1):
        nb = int((lengths == L).sum())
        if nb:
            tracks[str(L)] = rng.normal(0, 0.05, (nb, L, D)).cumsum(1)
    buckets = data.from_dict_bucketed(tracks, max_buckets=2, device=cuda,
                                      dtype=torch.float32)
    spec = params.generate_params(nb_states=S, D_max=1.0)
    spec.add("p01", 0.0, vary=False)                   # forbidden transition
    z = spec.to_unconstrained()
    kw = dict(cell_dims=(0.8,), nb_substeps=n, window=W, min_len=2)
    before = hvp_kernel.LAUNCHES, hvp_kernel.PLAIN_CALLS
    H = fit.hessian_hvp_columns(buckets, spec, z, 0.02, S, **kw)
    assert (hvp_kernel.LAUNCHES, hvp_kernel.PLAIN_CALLS) == (
        before[0] + len(z) * len(buckets), before[1])
    saved = hvp_kernel.table_hvp
    hvp_kernel.table_hvp = hvp_kernel.table_hvp_plain
    try:
        H0 = fit.hessian_hvp_columns(buckets, spec, z, 0.02, S, **kw)
    finally:
        hvp_kernel.table_hvp = saved
    scale = np.abs(H0).max()
    np.testing.assert_allclose(H, H0, rtol=5e-3, atol=1e-3 * scale)
    np.testing.assert_allclose(H, H.T, atol=2e-3 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("S,W,B,T,D", [(2, 5, 300, 9, 2), (3, 3, 77, 12, 3),
                                       (2, 4, 5, 2, 1), (2, 9, 40, 60, 2)])
def test_cuda_posteriors_match_plain(cuda, S, W, B, T, D):
    pos, lens, isbl, tb = _case(cuda, S, 1, B, T, D)
    kw = dict(window=W, min_len=3)
    before = predict_kernel.LAUNCHES, predict_kernel.PLAIN_CALLS
    logl, preds = predict_kernel.predict(pos, lens, isbl, tb, **kw)
    assert (predict_kernel.LAUNCHES, predict_kernel.PLAIN_CALLS) == (
        before[0] + 1, before[1])
    logl0, preds0 = predict_kernel.predict_plain(pos, lens, isbl, tb, **kw)
    torch.testing.assert_close(logl, logl0, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(preds, preds0, rtol=2e-3, atol=2e-4)
    L = lens.cpu().numpy()
    valid = (np.arange(T)[None, :] < L[:, None]) & (L >= 2)[:, None]
    sums = preds.sum(-1).cpu().numpy()
    np.testing.assert_allclose(sums[valid], 1.0, atol=1e-3)
    assert np.all(sums[~valid] == 0.0)


# (S, W, n, B, T, D, per-peak LocErr): K1 on both its mappings at K = 8,
# 16, 32, 64 (warp and wide; A = 2, 3, 4 unrolled and 8 at run time), and
# on the wide mapping at K = 243 and 1024 (S = 2 and 32); K1 has no block
# mapping
K1_MAPPING_CASES = [
    (2, 3, 1, 300, 9, 2, False), (2, 4, 1, 300, 9, 1, True),
    (2, 5, 1, 300, 9, 3, False), (2, 6, 1, 300, 9, 2, True),
    (3, 3, 1, 200, 9, 2, False), (2, 4, 2, 200, 9, 2, False),
    (2, 6, 3, 100, 9, 2, False), (3, 5, 1, 200, 9, 2, True),
    (2, 10, 1, 40, 12, 2, False), (32, 2, 1, 40, 6, 1, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("S,W,n,B,T,D,per_peak", K1_MAPPING_CASES)
def test_cuda_k1_mappings_match_plain(cuda, S, W, n, B, T, D, per_peak):
    args = _case(cuda, S, n, B, T, D, per_peak=per_peak)
    kw = dict(window=W, nb_substeps=n, min_len=2)
    want = forward_kernel.forward_plain(*args, **kw)
    data_, tabs = _kernel_args(args, W, n)
    K = S ** W
    for mapping in (("warp",) if K <= 64 else ()) + ("wide",):
        got = forward_kernel.launch(data_, tabs, 2, mapping=mapping)
        again = forward_kernel.launch(data_, tabs, 2, mapping=mapping)
        assert torch.equal(got, again)        # no atomics: repeatable
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-4)
    if K > 64:
        with pytest.raises(ValueError, match="K <= 64"):
            forward_kernel.launch(data_, tabs, 2, mapping="warp")
    with pytest.raises(ValueError, match="K1 has the mappings"):
        forward_kernel.launch(data_, tabs, 2, mapping="block")


# (S, W, B, T, D, per-peak LocErr): K4 on both mappings at K = 8, 16, 32,
# 64 (warp and block), 243 and 1024 (block), and each on the wide
# mapping, with its stash of fusion weights in shared memory and in
# global scratch; T = 2 and a window wider than the tracks among them
K4_MAPPING_CASES = [
    (2, 3, 300, 9, 2, False), (2, 4, 300, 12, 1, True),
    (2, 5, 300, 20, 2, False), (2, 6, 200, 14, 3, True),
    (3, 3, 200, 10, 2, False), (4, 3, 100, 9, 2, True),
    (5, 2, 100, 8, 3, False), (2, 5, 50, 2, 2, False),
    (2, 6, 50, 4, 2, True), (3, 5, 100, 12, 2, False),
    (2, 10, 30, 14, 2, True), (4, 5, 20, 8, 1, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("S,W,B,T,D,per_peak", K4_MAPPING_CASES)
def test_cuda_k4_mappings_match_plain(cuda, S, W, B, T, D, per_peak):
    args = _case(cuda, S, 1, B, T, D, per_peak=per_peak)
    kw = dict(window=W, min_len=2)
    logl0, preds0 = predict_kernel.predict_plain(*args, **kw)
    data_, tabs = _kernel_args(args, W)
    K = S ** W
    for mapping in (("warp", "block") if K <= 64 else ("block",)) + (
            "wide",):
        for stash in ("smem", "global"):
            logl, preds = predict_kernel.launch(data_, tabs, 2, S, W,
                                                mapping=mapping, stash=stash)
            again = predict_kernel.launch(data_, tabs, 2, S, W,
                                          mapping=mapping, stash=stash)
            assert torch.equal(logl, again[0])
            assert torch.equal(preds, again[1])
            torch.testing.assert_close(logl, logl0, rtol=2e-4, atol=2e-4)
            torch.testing.assert_close(preds, preds0, rtol=2e-3, atol=2e-4)


@pytest.mark.cuda
def test_predict_layout(cuda):
    """K4's team as its source defines it (``extrack_predict_layout``): a
    warp's slice holds two publish areas, two buffers of a track's rows and
    its length and flag, the softmax and the groups' masses; a block's
    holds the publish areas, the closings' and the harvest's warp partials,
    the softmax and the masses; the stash of fusion weights is T-W rows of
    K floats, padded to an odd length.  With variable dt (P = S^2) a
    warp's slice also holds two buffers of the track's (T-1, P) streamed
    displacement variances."""
    import ctypes
    from extrack_tpu_torch.ops import cuda_lib
    lib = cuda_lib.library()
    for S, W, T, D in ((2, 5, 10, 2), (2, 6, 20, 3), (3, 3, 9, 1),
                       (3, 5, 20, 2), (2, 10, 14, 2), (2, 5, 4, 2)):
        K, G = S ** W, S ** (W - 1)
        out = (ctypes.c_longlong * 3)()
        stash = 4 * max(T - W, 0) * (K | 1)
        for warps in ((1, 0) if K <= 64 else (0,)):
            for P in (0, S * S):
                assert lib.extrack_predict_layout(
                    T, D, K, S, W, warps, P, ctypes.addressof(out)) == 0
                pub = 2 * (2 + 2 * D) * K
                fixed = (pub + 4 * T * D + 2 * (T - 1) * P + 4 + K + G
                         if warps else pub + 128 + W * S * 32 + K + G)
                assert tuple(out) == (32 if warps else -(-K // 32) * 32,
                                      4 * fixed, stash)
        assert lib.extrack_predict_layout(T, D, 81, 3, 4, 1, 0,
                                          ctypes.addressof(out)) != 0
    # the wide mapping: two publish areas of (2D+1) floats a fusion group,
    # the closings' and the harvest's partials, the softmax; a thread a
    # group up to 1024
    for S, W, T, D in ((6, 4, 5, 1), (3, 7, 20, 2), (5, 5, 9, 3),
                       (2, 12, 14, 3), (4, 6, 10, 2), (2, 5, 10, 2)):
        K, G = S ** W, S ** (W - 1)
        out = (ctypes.c_longlong * 3)()
        assert lib.extrack_predict_layout(T, D, K, S, W, -1, 0,
                                          ctypes.addressof(out)) == 0
        assert tuple(out) == (
            min(1024, -(-G // 32) * 32),
            4 * (2 * (2 * D + 1) * G + 128 + W * S * 32 + K),
            4 * max(T - W, 0) * (K | 1))
    # past shared memory (-2): only the partials stay there; the publish
    # areas, the softmax and the stash go to the block's global scratch
    # (K4 past 16384 slots: the GUI's labeling window at 3 states, 2^16
    # and 6^6)
    for S, W, T, D in ((4, 7, 10, 3), (2, 14, 17, 1), (6, 5, 4, 2),
                       (3, 10, 40, 2), (2, 16, 20, 3), (6, 6, 9, 1)):
        K, G = S ** W, S ** (W - 1)
        assert lib.extrack_predict_layout(T, D, K, S, W, -2, 0,
                                          ctypes.addressof(out)) == 0
        assert tuple(out) == (
            1024, 4 * (128 + W * S * 32),
            4 * (2 * (2 * D + 1) * G + K + max(T - W, 0) * (K | 1)))
    for warps in (-1, -2):
        assert lib.extrack_predict_layout(10, 2, 3 ** 11, 3, 11, warps, 0,
                                          ctypes.addressof(out)) != 0
    assert lib.extrack_predict_layout(10, 2, 2 ** 11, 2, 11, 0, 0,
                                      ctypes.addressof(out)) != 0


# every hist_kernel<D, NT> instantiation (NT = 128, 256, 512, 1024
# threads), K = 8, 128, 243, 729 and 1024 among them, D = 1..3, and rows
# in global scratch (K = 512 at T = 60, K = 729 at T = 24, K = 1024 at
# D = 1: 48 KB of dynamic shared memory beside the static partials)
HIST_CASES = [
    (2, 5, 300, 9, 2), (3, 3, 77, 12, 3), (2, 4, 5, 2, 1), (2, 9, 40, 60, 2),
    (2, 3, 64, 7, 1), (2, 7, 64, 10, 2), (3, 4, 40, 9, 3), (3, 5, 40, 9, 1),
    (3, 5, 40, 9, 2), (3, 5, 40, 9, 3), (2, 9, 12, 8, 1), (7, 3, 12, 8, 2),
    (2, 9, 12, 8, 3), (3, 6, 12, 8, 2), (2, 10, 8, 6, 1), (4, 5, 8, 6, 3),
    (3, 6, 8, 24, 3), (2, 10, 8, 16, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("S,W,B,T,D", HIST_CASES)
def test_cuda_histogram_matches_plain(cuda, S, W, B, T, D):
    pos, lens, isbl, tb = _case(cuda, S, 1, B, T, D)
    kw = dict(window=W, min_len=3)
    before = hist_kernel.LAUNCHES, hist_kernel.PLAIN_CALLS
    got = hist_kernel.hist(pos, lens, isbl, tb, **kw)
    again = hist_kernel.hist(pos, lens, isbl, tb, **kw)
    assert (hist_kernel.LAUNCHES, hist_kernel.PLAIN_CALLS) == (
        before[0] + 2, before[1])
    assert torch.equal(got, again)            # no atomics: repeatable
    want = hist_kernel.hist_plain(pos, lens, isbl, tb, **kw)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-4)
    L = lens.cpu().numpy()
    frames = float((got.cpu().double()
                    * torch.arange(1, T + 1)[:, None]).sum())
    np.testing.assert_allclose(frames, L[L >= 2].sum(), rtol=2e-3)
    with pytest.raises(NotImplementedError, match="largest window"):
        hist_kernel.hist(pos, lens, isbl, tb,
                         window=_past_envelope(S, "K5"))


# every refine_kernel<D, NT> instantiation (NT = 128, 256, 512, 1024
# threads), K = 8, 128, 243, 729 and 1024 among them, odd K and state
# blocks that straddle warps (S = 3, 5, 7), D = 1..3, and stashes in
# global scratch (the last two)
REFINE_CASES = [
    (2, 5, 300, 9, 2, False), (3, 4, 77, 12, 3, True), (4, 3, 5, 2, 1, False),
    (2, 3, 64, 7, 1, False), (2, 7, 64, 10, 2, True), (3, 4, 40, 9, 3, False),
    (3, 5, 40, 9, 1, True), (3, 5, 40, 9, 2, False), (5, 3, 40, 9, 3, True),
    (2, 9, 12, 8, 2, False), (7, 3, 12, 8, 1, True), (2, 9, 12, 8, 3, False),
    (3, 6, 12, 8, 2, True), (2, 10, 8, 6, 1, False), (4, 5, 8, 6, 3, True),
    (2, 8, 16, 60, 2, True), (3, 6, 8, 24, 3, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("S,W,B,T,D,per_peak", REFINE_CASES)
def test_cuda_refinement_matches_plain(cuda, S, W, B, T, D, per_peak):
    pos, lens, _, _ = _case(cuda, S, 1, B, T, D)
    rng = np.random.default_rng(S + W)
    tr = np.full((S, S), 0.1 / (S - 1))
    np.fill_diagonal(tr, 0.9)
    tr[0, -1] = 0.0                                   # forbidden
    tr /= tr.sum(1, keepdims=True)
    f32 = dict(dtype=torch.float32, device=cuda)
    log_trans = tables.cap_log(torch.tensor(tr, **f32))
    sig2 = torch.tensor((0.08 * (1 + np.arange(S))) ** 2, **f32)
    l2 = (torch.tensor(rng.uniform(1e-4, 9e-4, (B, T, D)), **f32)
          if per_peak else torch.full((1, 1, 1), 4e-4, **f32))
    before = refine_kernel.LAUNCHES, refine_kernel.PLAIN_CALLS
    mu, sig = refine_kernel.refine(pos, lens, l2, log_trans, sig2, window=W)
    assert (refine_kernel.LAUNCHES, refine_kernel.PLAIN_CALLS) == (
        before[0] + 1, before[1])
    mu0, sig0 = refine_kernel.refine_plain(pos, lens, l2, log_trans, sig2,
                                           window=W)
    torch.testing.assert_close(mu, mu0, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(sig, sig0, rtol=2e-3, atol=2e-5)
    L = lens.cpu().numpy()
    valid = np.arange(T)[None, :] < L[:, None]
    assert np.all(mu.cpu().numpy()[~valid] == 0.0)
    assert np.all(sig.cpu().numpy()[~valid] == 0.0)


@pytest.mark.cuda
def test_refine_layout(cuda):
    """K6's block as its source defines it (``cuda_lib.layout``): frames of
    forms 16-byte aligned, a stash frame per interior position, and a
    thread for every slot and every pair-loop thread of two prefix slots
    (odd K included); the tiled wide mapping's scan block, shared bytes and
    carry a track as the host twin (tests/refine_tiled_twin.py) has
    them."""
    from extrack_tpu_torch.ops import cuda_lib
    from tests.refine_tiled_twin import layout as _layout
    for D, per in ((1, 4), (2, 5), (3, 8)):
        for S, W in ((2, 3), (2, 7), (3, 5), (3, 6), (5, 3), (7, 3),
                     (2, 10)):
            K, KS = S ** W, S ** (W - 1)
            n, fixed, stash = cuda_lib.layout("refine", 10, D, K, S, 0, 0)
            frame = per * (-(-K // 4) * 4) * 4
            assert stash == 8 * frame and frame % 16 == 0
            assert fixed == (2 * frame + 2 * (2 + 2 * D) * K * 4
                             + 32 * (n // 32) * (2 + 2 * D) * 4)
            assert n % 32 == 0 and n >= K and n <= 1024
            assert n >= S * -(-KS // 2) * 2
            assert cuda_lib.layout("refine", 2, D, K, S, 0, 0)[2] == 0
        # the tiled wide mapping, its publish areas in shared memory (1)
        # or in the carry (2), at several pair-kernel row tiles
        for S, W in ((6, 4), (2, 11), (3, 7), (5, 5), (2, 12), (16, 3),
                     (2, 7), (4, 7), (2, 14), (3, 8), (5, 6)):
            K = S ** W
            for wide in (1, 2):
                for rows in (64, 512, 1024):
                    for T in (2, 10):
                        assert cuda_lib.layout("refine", T, D, K, S, wide,
                                               rows) == _layout(
                            T, D, K, S, wide, rows)
            assert cuda_lib.layout("refine", 2, D, K, S, 1, 512)[2] == 0
    with pytest.raises(RuntimeError):
        cuda_lib.layout("refine", 10, 4, 128, 2, 0, 0)
    with pytest.raises(RuntimeError):
        cuda_lib.layout("refine", 10, 2, 2 ** 11, 2, 0, 0)
    for wide in (1, 2):
        with pytest.raises(RuntimeError):
            cuda_lib.layout("refine", 10, 2, 3 ** 9, 3, wide, 512)
        with pytest.raises(RuntimeError):
            cuda_lib.layout("refine", 10, 2, 3 ** 7, 3, wide, 0)


@pytest.mark.cuda
def test_hist_layout(cuda):
    """K5's block as its source defines it: a thread per slot, rows per
    fusion group (K/A of them at A = S^n children, double-buffered)."""
    from extrack_tpu_torch.ops import cuda_lib
    for S, W, T, n in ((2, 7, 10, 1), (3, 5, 10, 1), (4, 2, 60, 1),
                       (2, 3, 8, 1), (2, 7, 10, 2), (3, 5, 9, 2),
                       (2, 3, 8, 2)):
        K, A = S ** W, S ** n
        for D in (1, 2, 3):
            threads, fixed, rows = cuda_lib.layout("hist", T, D, K, S, A,
                                                   0)
            assert threads == -(-K // 32) * 32
            assert rows == 2 * (K // A) * (1 + S) * T * 4
            assert fixed == (2 * (2 + 2 * D) + 4) * K * 4
    # the wide mapping: a thread a fusion group (at most 1024), two publish
    # areas of (2D+1) floats a group and K member weights; the same rows
    for S, W, T, n in ((6, 4, 5, 1), (2, 11, 10, 1), (3, 7, 20, 1),
                       (3, 7, 9, 2), (5, 5, 8, 2), (2, 12, 14, 1),
                       (16, 3, 6, 2), (2, 7, 10, 1)):
        K, A = S ** W, S ** n
        G = K // A
        for D in (1, 2, 3):
            assert cuda_lib.layout("hist", T, D, K, S, A, 1) == (
                min(1024, -(-G // 32) * 32),
                (2 * (2 * D + 1) * G + K) * 4, 2 * G * (1 + S) * T * 4)
    # the publish areas and member weights in global scratch (wide = 2):
    # no dynamic shared memory, the carry holds them after the rows
    for S, W, T, n in ((4, 7, 10, 1), (2, 13, 9, 2), (2, 14, 8, 1)):
        K, A = S ** W, S ** n
        G = K // A
        for D in (1, 2, 3):
            assert cuda_lib.layout("hist", T, D, K, S, A, 2) == (
                1024, 0, (2 * G * (1 + S) * T + 2 * (2 * D + 1) * G + K) * 4)
    # past 16384 slots (wide = 3, the harvest from the slots' digits): the
    # layout of wide = 2, up to 2^19
    for S, W, T, n in ((5, 7, 10, 1), (6, 7, 20, 1), (4, 8, 9, 1),
                       (2, 15, 10, 2), (2, 19, 4, 1)):
        K, A = S ** W, S ** n
        G = K // A
        for D in (1, 2, 3):
            assert cuda_lib.layout("hist", T, D, K, S, A, 3) == (
                1024, 0, (2 * G * (1 + S) * T + 2 * (2 * D + 1) * G + K) * 4)
    with pytest.raises(RuntimeError):
        cuda_lib.layout("hist", 10, 2, 2 ** 11, 2, 2, 0)
    for wide in (1, 2):
        with pytest.raises(RuntimeError):
            cuda_lib.layout("hist", 10, 2, 3 ** 9, 3, 3, wide)
    with pytest.raises(RuntimeError):
        cuda_lib.layout("hist", 10, 2, 3 ** 12, 3, 3, 3)


@pytest.mark.cuda
def test_cuda_refinement_window_past_the_envelope_raises(cuda):
    """The reference's default window for 6 states on short 1-D tracks
    needs 6^4 = 1296 slots: K6's wide mapping runs it, held to the plain
    version; a window past 16384 slots raises, names the bucket and points
    to frame_len."""
    from extrack_tpu_torch import refine
    rng = np.random.default_rng(0)
    batch = data.from_dict({"4": rng.normal(0, 0.05, (5, 4, 1))},
                           device=cuda)
    assert refine.default_window(6, 4, 1) == 4
    TrMat = np.full((6, 6), 0.02) + np.eye(6) * 0.88
    before = refine_kernel.LAUNCHES, refine_kernel.PLAIN_CALLS
    mu, sig, n = refine.refine_batch(batch, 0.02, np.full(6, 0.05), TrMat)
    assert n == 5 and mu.dtype == np.float32
    assert (refine_kernel.LAUNCHES, refine_kernel.PLAIN_CALLS) == (
        before[0] + 1, before[1])
    cpu = data.from_dict({"4": batch.positions.double().cpu().numpy()},
                         device="cpu")
    mu0, sig0, _ = refine.refine_batch(cpu, 0.02, np.full(6, 0.05), TrMat)
    np.testing.assert_allclose(mu, mu0, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(sig, sig0, rtol=2e-3, atol=2e-5)
    with pytest.raises(NotImplementedError, match="bucket.*frame_len.*K6"):
        refine.refine_batch(batch, 0.02, np.full(6, 0.05), TrMat,
                            frame_len=6)


@pytest.mark.cuda
@pytest.mark.parametrize("S,n,M,B,T,D", [
    (2, 1, 512, 300, 9, 2),       # unpruned: 2^9 sequences fit
    (3, 1, 88, 77, 6, 3), (2, 2, 64, 40, 8, 1)])
def test_cuda_topk_matches_plain(cuda, S, n, M, B, T, D):
    pos, lens, isbl, tb = _case(cuda, S, n, B, T, D)
    kw = dict(max_nb_states=M, min_len=3, nb_substeps=n)
    before = topk_kernel.LAUNCHES, topk_kernel.PLAIN_CALLS
    got = topk_kernel.segment_topk(pos, lens, isbl, tb, **kw)
    again = topk_kernel.segment_topk(pos, lens, isbl, tb, **kw)
    assert (topk_kernel.LAUNCHES, topk_kernel.PLAIN_CALLS) == (
        before[0] + 2, before[1])
    assert torch.equal(got, again)            # no atomics: repeatable
    want = topk_kernel.segment_topk_plain(pos, lens, isbl, tb, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    L = lens.cpu().numpy()
    frames = float((got.cpu().double()
                    * torch.arange(1, T + 1)[:, None]).sum())
    np.testing.assert_allclose(frames, L[L >= 2].sum(), rtol=2e-3)
    if S ** T <= M:
        # unpruned: the same sequences in the same slots
        par, st, wf = topk_kernel.backpointers(pos, lens, isbl, tb, **kw)
        par0, st0, wf0 = histograms.segment_backpointers(pos, lens, isbl,
                                                         tb, **kw)
        assert torch.equal(par.long(), par0) and torch.equal(st, st0)
        torch.testing.assert_close(wf, wf0, rtol=1e-4, atol=1e-5)
    with pytest.raises(NotImplementedError, match="largest max_nb_states"):
        topk_kernel.segment_topk(pos, lens, isbl, tb, max_nb_states=4224,
                                 nb_substeps=n)
    # a per-track table: K7 on the stream, the plain version's histogram
    # (and, unpruned, its backpointers)
    per_track = tb._replace(sig2=tb.sig2.expand(B, T - 1, -1))
    before = topk_kernel.LAUNCHES, topk_kernel.PLAIN_CALLS
    got = topk_kernel.segment_topk(pos, lens, isbl, per_track, **kw)
    assert (topk_kernel.LAUNCHES, topk_kernel.PLAIN_CALLS) == (
        before[0] + 1, before[1])
    want = topk_kernel.segment_topk_plain(pos, lens, isbl, per_track, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    if S ** T <= M:
        par, st, wf = topk_kernel.backpointers(pos, lens, isbl, per_track,
                                               **kw)
        par0, st0, wf0 = histograms.segment_backpointers(
            pos, lens, isbl, per_track, **kw)
        assert torch.equal(par.long(), par0) and torch.equal(st, st0)
        torch.testing.assert_close(wf, wf0, rtol=1e-4, atol=1e-5)
    # K5 reads the per-track table (one and two sub-steps a frame)
    kw5 = dict(window=3, min_len=3, nb_substeps=n)
    torch.testing.assert_close(
        hist_kernel.hist(pos, lens, isbl, per_track, **kw5),
        hist_kernel.hist_plain(pos, lens, isbl, per_track, **kw5),
        rtol=2e-3, atol=2e-4)


def _kernel_args(args, W, n=1):
    (xs, l2, lens, isbl), tabs = forward_kernel.kernel_inputs(*args, W, n)
    return (xs, l2, lens, isbl), [t.detach() for t in tabs]


@pytest.mark.cuda
@pytest.mark.parametrize("S,W,D", [(2, 3, 2), (2, 4, 2), (2, 5, 2),
                                   (2, 6, 2), (2, 6, 1), (2, 6, 3),
                                   (3, 5, 2)])
def test_cuda_k2_mappings_match_plain(cuda, monkeypatch, S, W, D):
    # K = 8, 16, 32, 64 on the warp mapping (history in shared memory and
    # in global scratch) against the block mapping, and K = 243 on the
    # block mapping; each through value_and_table_grads against the plain
    # version
    args = _case(cuda, S, 1, 300, 9, D)
    kw = dict(window=W, nb_substeps=1, min_len=2)
    data_, tabs = _kernel_args(args, W)
    K = S ** W
    runs = ([("warp", None), ("warp", "global"), ("block", None)]
            if K <= 64 else [("block", None)])
    outs = [grad_kernel.launch(data_, tabs, 2, mapping=m, stash=st)
            for m, st in runs]
    ref = outs[-1]
    for out in outs[:-1]:
        torch.testing.assert_close(out[0], ref[0], rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(out[1], ref[1], rtol=2e-4,
                                   atol=2e-5 * float(ref[1].abs().max()))
        for c, c0 in zip(out[2], ref[2]):
            torch.testing.assert_close(c, c0, rtol=2e-4,
                                       atol=2e-5 * float(c0.abs().max()))
    v0, g0 = grad_kernel.value_and_table_grads_plain(*args, **kw)
    for warp_max in ((64, 0) if K <= 64 else (64,)):
        monkeypatch.setattr(grad_kernel, "WARP_MAX_K", warp_max)
        v, g = grad_kernel.value_and_table_grads(*args, **kw)
        torch.testing.assert_close(v, v0, rtol=2e-5, atol=0.0)
        for k in g:
            torch.testing.assert_close(g[k], g0[k], rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [4, 6])
def test_cuda_k3_mappings_agree(cuda, W):
    # K3 (dual numbers) on both mappings: the same values and tangents
    args = _case(cuda, 2, 1, 200, 9, 2)
    data_, tabs = _kernel_args(args, W)
    rng = np.random.default_rng(W)
    dots = [torch.tensor(rng.normal(0, 1, t.shape), dtype=torch.float32,
                         device=cuda) for t in tabs]
    l2_dot = torch.zeros_like(data_[1])
    warp = hvp_kernel.launch(data_, tabs, l2_dot, dots, 2, mapping="warp")
    block = hvp_kernel.launch(data_, tabs, l2_dot, dots, 2, mapping="block")
    for (a, a_dot), (b, b_dot) in zip(warp[:2], block[:2]):
        torch.testing.assert_close(a, b, rtol=2e-4,
                                   atol=2e-5 * float(b.abs().max()))
        torch.testing.assert_close(a_dot, b_dot, rtol=2e-4,
                                   atol=2e-5 * float(b_dot.abs().max()))
    for a, b in zip(warp[2][0] + warp[2][1], block[2][0] + block[2][1]):
        torch.testing.assert_close(a, b, rtol=2e-4,
                                   atol=2e-5 * float(b.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("S,n,M,B,T,D", [
    (2, 1, 512, 300, 9, 2), (3, 1, 88, 77, 6, 3), (2, 2, 64, 40, 8, 1),
    (2, 1, 128, 200, 30, 2)])
def test_cuda_topk_fused_matches_raw_decode(cuda, S, n, M, B, T, D):
    # the fused decode's rows against the raw backpointers decoded track by
    # track in plain torch, and the same bits on a second run
    pos, lens, isbl, tb = _case(cuda, S, n, B, T, D)
    data_, tabs = topk_kernel.kernel_inputs(pos, lens, isbl, tb, M, n)
    rows = [torch.empty((B, T * S), device=cuda) for _ in range(2)]
    for r in rows:
        topk_kernel.launch_fused(data_, tabs, r, S, n, 3)
    assert torch.equal(rows[0], rows[1])
    par, st, wf = topk_kernel.backpointers(pos, lens, isbl, tb,
                                           max_nb_states=M, min_len=3,
                                           nb_substeps=n)
    want = histograms.decode_backpointers(
        par, st, wf, lens, tables.state_codes(S, n + 1), S, M,
        per_track=True)
    torch.testing.assert_close(rows[0].view(B, T, S), want, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("S,n,M,B,T,D", [
    (2, 1, 512, 300, 8, 2), (3, 1, 256, 77, 5, 3), (2, 2, 64, 40, 3, 1),
    (2, 1, 88, 60, 6, 2)])
def test_cuda_topk_pad_prefix_backpointers_match_plain(cuda, S, n, M, B, T,
                                                       D):
    # registers that never fill: every slot past the live children holds an
    # unused child in closed form, and every parent and state, live or not,
    # is the plain version's
    pos, lens, isbl, tb = _case(cuda, S, n, B, T, D)
    assert S ** (n + 1) * (S ** n) ** (T - 2) <= M
    kw = dict(max_nb_states=M, min_len=3, nb_substeps=n)
    par, st, wf = topk_kernel.backpointers(pos, lens, isbl, tb, **kw)
    par0, st0, wf0 = histograms.segment_backpointers(pos, lens, isbl, tb,
                                                     **kw)
    assert torch.equal(par.long(), par0) and torch.equal(st, st0)
    torch.testing.assert_close(wf, wf0, rtol=1e-4, atol=1e-5)


# ---- the wide mapping: 1024 < K <= 4096 -------------------------------


def _past_envelope(S, kernel):
    """The smallest window whose register passes ``kernel``'s envelope
    (K6: 16384 slots; K1, K2, K3: 65536 and 16384 fusion groups; K4:
    65536; K5: 2^19) at S states, one sub-step."""
    limit = forward_kernel.MAX_SLOTS[kernel]
    groups = forward_kernel.MAX_GROUPS.get(kernel, limit)
    return next(w for w in range(1, 24)
                if S ** w > limit or S ** (w - 1) > groups)


# (S, W, D, dt): K = 1296, 2048, 2187, 3125 and 4096 (2, 4 and 8 states),
# each at D = 1..3 among them; variable dt per step and per track
WIDE_WALK_CASES = [
    (6, 4, 1, None), (6, 4, 2, "track"), (6, 4, 3, "step"),
    (2, 11, 1, "step"), (2, 11, 2, None), (2, 11, 3, "track"),
    (3, 7, 1, "track"), (3, 7, 2, None), (3, 7, 3, "step"),
    (5, 5, 1, None), (5, 5, 2, "step"), (5, 5, 3, "track"),
    (2, 12, 1, "track"), (4, 6, 2, None), (8, 4, 3, "step")]


@pytest.mark.cuda
@pytest.mark.parametrize("S,W,D,dt", WIDE_WALK_CASES)
def test_cuda_wide_k1_k4_match_plain(cuda, S, W, D, dt):
    # K1 and K4 past 1024 slots through their wrappers (the default
    # mapping there is the wide one), K4 with its stash in shared memory
    # and in global scratch; tracks longer than the window, so that frames
    # leave it
    T = W + 3
    args = _case(cuda, S, 1, 24, T, D, seed=S + W, per_peak=(D == 2),
                 dt=dt)
    assert forward_kernel.plan("K1", S ** W, 0, 0, 0, None).warps == (
        forward_kernel.WIDE)
    kw = dict(window=W, min_len=2)
    before = forward_kernel.LAUNCHES, predict_kernel.LAUNCHES
    got = forward_kernel.forward(*args, **kw)
    assert torch.equal(got, forward_kernel.forward(*args, **kw))
    torch.testing.assert_close(got, forward_kernel.forward_plain(*args, **kw),
                               rtol=2e-5, atol=2e-4)
    logl0, preds0 = predict_kernel.predict_plain(*args, **kw)
    logl, preds = predict_kernel.predict(*args, **kw)
    assert (forward_kernel.LAUNCHES, predict_kernel.LAUNCHES) == (
        before[0] + 2, before[1] + 1)
    torch.testing.assert_close(logl, logl0, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(preds, preds0, rtol=2e-3, atol=2e-4)
    data_, tabs = _kernel_args(args, W)
    for stash in ("smem", "global"):
        try:
            logl, preds = predict_kernel.launch(data_, tabs, 2, S, W,
                                                stash=stash)
        except ValueError as e:       # a stash too large for shared memory
            assert stash == "smem" and "does not fit" in str(e)
            continue
        torch.testing.assert_close(logl, logl0, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(preds, preds0, rtol=2e-3, atol=2e-4)
    with pytest.raises(NotImplementedError,
                       match="K1 maps at most (65536|16384)"):
        forward_kernel.forward(*args, window=_past_envelope(S, "K1"),
                               min_len=2)
    with pytest.raises(NotImplementedError, match="K4 maps at most 65536"):
        predict_kernel.predict(*args, window=_past_envelope(S, "K4"),
                               min_len=2)


# K5 past 1024 slots: (S, W, n, D, dt); two sub-steps where the window's
# frames align (A = 4, 9, 25 and 256, the last a window of two frames, A
# not dividing G)
WIDE_HIST_CASES = [
    (6, 4, 1, 1, None), (6, 4, 1, 3, "track"), (2, 11, 1, 2, "step"),
    (2, 11, 2, 1, "track"), (3, 7, 1, 1, None), (3, 7, 1, 2, "track"),
    (3, 7, 2, 3, "step"), (5, 5, 1, 3, None), (5, 5, 2, 2, "track"),
    (2, 12, 1, 2, None), (4, 6, 1, 1, "step"), (16, 3, 2, 2, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("S,W,n,D,dt", WIDE_HIST_CASES)
def test_cuda_wide_k5_matches_plain(cuda, S, W, n, D, dt):
    wf = (W - 1) // n + 1
    T = wf + 4
    pos, lens, isbl, tb = _case(cuda, S, n, 20, T, D, seed=S * W + n, dt=dt)
    kw = dict(window=W, min_len=2, nb_substeps=n)
    before = hist_kernel.LAUNCHES, hist_kernel.PLAIN_CALLS
    got = hist_kernel.hist(pos, lens, isbl, tb, **kw)
    assert torch.equal(got, hist_kernel.hist(pos, lens, isbl, tb, **kw))
    assert (hist_kernel.LAUNCHES, hist_kernel.PLAIN_CALLS) == (
        before[0] + 2, before[1])
    want = hist_kernel.hist_plain(pos.double(), lens, isbl.double(),
                                  tables.ModelTables(*(f.double()
                                                       for f in tb)), **kw)
    torch.testing.assert_close(got.double(), want, rtol=2e-3, atol=2e-4)
    L = lens.cpu().numpy()
    frames = float((got.cpu().double()
                    * torch.arange(1, T + 1)[:, None]).sum())
    np.testing.assert_allclose(frames, L[L >= 2].sum(), rtol=2e-3)
    with pytest.raises(NotImplementedError, match="K5 maps at most 524288"):
        hist_kernel.hist(pos, lens, isbl, tb,
                         window=_past_envelope(S, "K5"))


# K6 past 1024 slots: (S, W, B, T, D, per-peak LocErr)
WIDE_REFINE_CASES = [
    (6, 4, 12, 5, 1, False), (6, 4, 12, 9, 2, True), (6, 4, 8, 6, 3, False),
    (2, 11, 6, 8, 1, True), (3, 7, 8, 9, 2, False), (3, 7, 6, 10, 3, True),
    (5, 5, 6, 8, 1, False), (2, 12, 4, 6, 2, False), (4, 6, 4, 7, 3, True)]


def _refine_args(dev, S, W, B, T, D, per_peak):
    pos, lens, _, _ = _case(dev, S, 1, B, T, D)
    rng = np.random.default_rng(S + W)
    tr = np.full((S, S), 0.1 / (S - 1))
    np.fill_diagonal(tr, 0.9)
    tr[0, -1] = 0.0                                   # forbidden
    tr /= tr.sum(1, keepdims=True)
    f32 = dict(dtype=torch.float32, device=dev)
    log_trans = tables.cap_log(torch.tensor(tr, **f32))
    sig2 = torch.tensor((0.08 * (1 + np.arange(S))) ** 2, **f32)
    l2 = (torch.tensor(rng.uniform(1e-4, 9e-4, (B, T, D)), **f32)
          if per_peak else torch.full((1, 1, 1), 4e-4, **f32))
    return pos, lens, l2, log_trans, sig2


@pytest.mark.cuda
@pytest.mark.parametrize("S,W,B,T,D,per_peak", WIDE_REFINE_CASES)
def test_cuda_wide_k6_matches_plain(cuda, S, W, B, T, D, per_peak):
    args = _refine_args(cuda, S, W, B, T, D, per_peak)
    before = refine_kernel.LAUNCHES, refine_kernel.PLAIN_CALLS
    mu, sig = refine_kernel.refine(*args, window=W)
    assert (refine_kernel.LAUNCHES, refine_kernel.PLAIN_CALLS) == (
        before[0] + 1, before[1])
    mu0, sig0 = refine_kernel.refine_plain(*args, window=W)
    torch.testing.assert_close(mu, mu0, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(sig, sig0, rtol=2e-3, atol=2e-5)
    L = args[1].cpu().numpy()
    valid = np.arange(T)[None, :] < L[:, None]
    assert np.all(mu.cpu().numpy()[~valid] == 0.0)
    with pytest.raises(NotImplementedError, match="K6 maps at most 16384"):
        refine_kernel.refine(*args, window=_past_envelope(S, "K6"))


@pytest.mark.cuda
@pytest.mark.parametrize("case", HIST_CASES[:9])
def test_cuda_k5_wide_mapping_on_small_registers(cuda, case):
    # the wide mapping forced onto the block mapping's registers (a thread
    # a group, G = K/S threads or fewer) gives the same histograms
    S, W, B, T, D = case
    pos, lens, isbl, tb = _case(cuda, S, 1, B, T, D)
    data_, tabs = _kernel_args((pos, lens, isbl, tb), W)
    want = hist_kernel.launch(data_, tabs, 3, S, W, mapping="block")
    got = hist_kernel.launch(data_, tabs, 3, S, W, mapping="wide")
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", REFINE_CASES[:9])
def test_cuda_k6_wide_mapping_on_small_registers(cuda, case):
    S, W, B, T, D, per_peak = case
    pos, lens, l2, log_trans, sig2 = _refine_args(cuda, S, W, B, T, D,
                                                  per_peak)
    lp0f, ltf, sig2v = refine_kernel.build_refine_tables(log_trans, sig2, W)
    lp0r, ltr, _ = refine_kernel.build_refine_tables(log_trans.T, sig2, W)
    tabs = [t.contiguous() for t in (lp0f, ltf, lp0r, ltr, sig2v)]
    lens = lens.to(torch.int32)
    l2 = l2.expand(B, T, D).contiguous()
    mu0, sig0 = refine_kernel.launch(pos, lens, l2, tabs, S, mapping="block")
    mu, sig = refine_kernel.launch(pos, lens, l2, tabs, S, mapping="wide")
    torch.testing.assert_close(mu, mu0, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(sig, sig0, rtol=2e-3, atol=2e-5)


# ---- K4 and K5 past 4096 slots, up to 16384 ----------------------------

# (S, W, D, dt): K = 7776 (6 states at predict_Bs's default frame_len 5),
# 8192 and 16384 at D = 1..3; K4's carries in shared memory (6^5, 2^13 and
# 4^7 at D = 1) or in global scratch (the others)
PAST_4096_K4_CASES = [
    (6, 5, 1, None), (6, 5, 2, "track"), (6, 5, 3, "step"),
    (2, 13, 1, "step"), (2, 13, 2, None), (2, 13, 3, "track"),
    (4, 7, 1, "track"), (4, 7, 2, "step"), (4, 7, 3, None),
    (2, 14, 1, None), (2, 14, 2, "track"), (2, 14, 3, "step")]


@pytest.mark.cuda
@pytest.mark.parametrize("S,W,D,dt", PAST_4096_K4_CASES)
def test_cuda_k4_past_4096_slots_matches_plain(cuda, S, W, D, dt):
    # tracks longer than the window, so that frames leave it; the stash in
    # shared memory where it fits, and forced to global scratch
    T = W + 3
    args = _case(cuda, S, 1, 12, T, D, seed=S + W + D, per_peak=(D == 2),
                 dt=dt)
    kw = dict(window=W, min_len=2)
    logl0, preds0 = predict_kernel.predict_plain(*args, **kw)
    before = predict_kernel.LAUNCHES, predict_kernel.PLAIN_CALLS
    logl, preds = predict_kernel.predict(*args, **kw)
    again = predict_kernel.predict(*args, **kw)
    assert (predict_kernel.LAUNCHES, predict_kernel.PLAIN_CALLS) == (
        before[0] + 2, before[1])
    assert torch.equal(logl, again[0]) and torch.equal(preds, again[1])
    torch.testing.assert_close(logl, logl0, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(preds, preds0, rtol=2e-3, atol=2e-4)
    data_, tabs = _kernel_args(args, W)
    logl, preds = predict_kernel.launch(data_, tabs, 2, S, W, stash="global")
    torch.testing.assert_close(logl, logl0, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(preds, preds0, rtol=2e-3, atol=2e-4)


# (S, W, n, D, dt): K = 7776, 8192 (two states at two sub-steps, window 7
# frames: len_hist(nb_substeps=2)'s default) and 16384 (four states at
# window 7: len_hist(nb_states=4)'s default; two states at 14), D = 1..3;
# the publish areas and weights in shared memory or global scratch
PAST_4096_K5_CASES = [
    (6, 5, 1, 1, None), (6, 5, 1, 3, "track"),
    (2, 13, 2, 1, None), (2, 13, 2, 2, "track"), (2, 13, 2, 3, "step"),
    (4, 7, 1, 1, "step"), (4, 7, 1, 2, None), (4, 7, 1, 3, "track"),
    (2, 14, 1, 1, "track"), (2, 14, 1, 2, "step"), (2, 14, 1, 3, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("S,W,n,D,dt", PAST_4096_K5_CASES)
def test_cuda_k5_past_4096_slots_matches_plain(cuda, S, W, n, D, dt):
    wf = (W - 1) // n + 1
    T = wf + 3
    pos, lens, isbl, tb = _case(cuda, S, n, 16, T, D, seed=S * W + n + D,
                                dt=dt)
    kw = dict(window=W, min_len=2, nb_substeps=n)
    before = hist_kernel.LAUNCHES, hist_kernel.PLAIN_CALLS
    got = hist_kernel.hist(pos, lens, isbl, tb, **kw)
    assert torch.equal(got, hist_kernel.hist(pos, lens, isbl, tb, **kw))
    assert (hist_kernel.LAUNCHES, hist_kernel.PLAIN_CALLS) == (
        before[0] + 2, before[1])
    want = hist_kernel.hist_plain(pos.double(), lens, isbl.double(),
                                  tables.ModelTables(*(f.double()
                                                       for f in tb)), **kw)
    torch.testing.assert_close(got.double(), want, rtol=2e-3, atol=2e-4)
    L = lens.cpu().numpy()
    frames = float((got.cpu().double()
                    * torch.arange(1, T + 1)[:, None]).sum())
    np.testing.assert_allclose(frames, L[L >= 2].sum(), rtol=2e-3)


# ---- K5 past 16384 slots (up to 2^19), K6 past 4096 (up to 16384) -----

# (S, W, n, D, dt): len_hist's default window 7 at 5 and 6 states (K =
# 78,125 and 279,936), the GUI's lifetime window 8 at 4 states (65,536)
# and two sub-steps at window 8 frames (2^15), D = 1..3, constant and
# variable dt: the harvest from the slots' digits (hist_runs_kernel)
PAST_16384_K5_CASES = [
    (5, 7, 1, 1, None), (5, 7, 1, 2, "track"), (5, 7, 1, 3, "step"),
    (6, 7, 1, 2, None), (4, 8, 1, 2, "track"), (4, 8, 1, 3, None),
    (2, 15, 2, 1, "step"), (2, 15, 2, 2, "track"), (2, 15, 2, 3, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("S,W,n,D,dt", PAST_16384_K5_CASES)
def test_cuda_k5_past_16384_slots_matches_plain(cuda, S, W, n, D, dt):
    # tracks longer than the window (frames leave it) and shorter ones,
    # against the plain version in float64; bit-repeatable
    wf = (W - 1) // n + 1
    T = wf + 3
    pos, lens, isbl, tb = _case(cuda, S, n, 6, T, D, seed=S * W + n + D,
                                dt=dt)
    kw = dict(window=W, min_len=2, nb_substeps=n)
    before = hist_kernel.LAUNCHES, hist_kernel.PLAIN_CALLS
    got = hist_kernel.hist(pos, lens, isbl, tb, **kw)
    assert torch.equal(got, hist_kernel.hist(pos, lens, isbl, tb, **kw))
    assert (hist_kernel.LAUNCHES, hist_kernel.PLAIN_CALLS) == (
        before[0] + 2, before[1])
    want = hist_kernel.hist_plain(pos.double(), lens, isbl.double(),
                                  tables.ModelTables(*(f.double()
                                                       for f in tb)), **kw)
    torch.testing.assert_close(got.double(), want, rtol=2e-3, atol=2e-4)
    L = lens.cpu().numpy()
    frames = float((got.cpu().double()
                    * torch.arange(1, T + 1)[:, None]).sum())
    np.testing.assert_allclose(frames, L[L >= 2].sum(), rtol=2e-3)


# (S, W, D, per-peak LocErr): 6^5 (1-D), 3^8, 5^6 (the reference's
# frame_len 6 at 5 states) and 4^7 (its frame_len 7 at 4 states) with the
# publish areas in shared memory, 4^7 at D = 3 and 2^14 in global scratch
PAST_4096_K6_CASES = [
    (6, 5, 1, False), (3, 8, 2, True), (5, 6, 3, False), (4, 7, 1, True),
    (4, 7, 3, False), (2, 14, 2, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("S,W,D,per_peak", PAST_4096_K6_CASES)
def test_cuda_k6_past_4096_slots_matches_plain(cuda, S, W, D, per_peak):
    args = _refine_args(cuda, S, W, 4, 6, D, per_peak)
    before = refine_kernel.LAUNCHES, refine_kernel.PLAIN_CALLS
    mu, sig = refine_kernel.refine(*args, window=W)
    assert (refine_kernel.LAUNCHES, refine_kernel.PLAIN_CALLS) == (
        before[0] + 1, before[1])
    mu0, sig0 = refine_kernel.refine_plain(*args, window=W)
    torch.testing.assert_close(mu, mu0, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(sig, sig0, rtol=2e-3, atol=2e-5)
    with pytest.raises(NotImplementedError, match="K6 maps at most 16384"):
        refine_kernel.refine(*args, window=_past_envelope(S, "K6"))


@pytest.mark.cuda
@pytest.mark.parametrize("S,W,D", [(6, 4, 2), (3, 7, 3), (3, 8, 1)])
def test_cuda_k6_global_publish_areas_match_shared(cuda, S, W, D,
                                                   monkeypatch):
    # the scan kernel with its publish areas in global scratch, forced
    # onto registers whose publish areas fit shared memory (the opt-in
    # patched to 0), gives the shared-memory scan's results
    from extrack_tpu_torch.ops import cuda_lib
    args = _refine_args(cuda, S, W, 8, 7, D, D == 1)
    want = refine_kernel.refine(*args, window=W)
    monkeypatch.setattr(cuda_lib, "smem_bytes", lambda *a: 0)
    got = refine_kernel.refine(*args, window=W)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)


# the tiled wide mapping (csrc/refine.cu refine_scan_kernel,
# refine_pairs_kernel, refine_merge_kernel): (S, W, D, B, T) at 6^4 (1-D,
# as phase 11), 3^7, 5^5, 4^7, 5^6 and 2^14, D = 1..3; tracks of 1, 2 and
# T frames in every case
TILED_K6_CASES = [(6, 4, 1, 24, 5)] + [
    (S, W, D, B, T) for S, W, B, T in ((3, 7, 12, 9), (5, 5, 10, 7),
                                       (4, 7, 6, 6), (5, 6, 6, 6),
                                       (2, 14, 4, 5))
    for D in (1, 2, 3)]


def _tiled_args(dev, S, W, D, B, T, per_peak):
    pos, lens, l2, lt, s2 = _refine_args(dev, S, W, B, T, D, per_peak)
    lens[:4] = torch.tensor([T, 2, 1, 0])
    return pos, lens, l2, lt, s2


@pytest.mark.cuda
@pytest.mark.parametrize("S,W,D,B,T", TILED_K6_CASES)
def test_cuda_tiled_k6_matches_plain_bit_for_bit_twice(cuda, S, W, D, B, T):
    args = _tiled_args(cuda, S, W, D, B, T, D != 2)
    before = refine_kernel.LAUNCHES, refine_kernel.PLAIN_CALLS
    mu, sig = refine_kernel.refine(*args, window=W)
    mu2, sig2 = refine_kernel.refine(*args, window=W)
    assert (refine_kernel.LAUNCHES, refine_kernel.PLAIN_CALLS) == (
        before[0] + 2, before[1])
    assert torch.equal(mu, mu2) and torch.equal(sig, sig2)
    mu0, sig0 = refine_kernel.refine_plain(*args, window=W)
    torch.testing.assert_close(mu, mu0, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(sig, sig0, rtol=2e-3, atol=2e-5)
    pos, l2 = args[0], args[2].expand(B, T, D)
    assert torch.equal(mu[2, 0], pos[2, 0])
    assert torch.equal(sig[2, 0], l2[2, 0].sqrt())
    assert not mu[3].any() and not sig[3].any()


# every block size of the pair kernel that plan picks (pair_threads, two
# rows a thread), each at two shapes: (S, W, D, its threads)
TILED_K6_PAIR_SHAPES = [(6, 4, 1, 128), (6, 4, 2, 128), (5, 5, 2, 160),
                        (5, 5, 3, 160), (3, 7, 1, 192), (3, 7, 3, 192),
                        (5, 6, 2, 224), (3, 8, 3, 224), (4, 6, 2, 256),
                        (4, 7, 1, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("S,W,D,threads", TILED_K6_PAIR_SHAPES)
def test_cuda_tiled_k6_every_pair_shape(cuda, S, W, D, threads):
    # through the entry point, against the plain version
    from extrack_tpu_torch.ops import cuda_lib
    B, T = 6, 7
    args = _tiled_args(cuda, S, W, D, B, T, True)
    pl = refine_kernel.plan(T, D, S ** W, S, cuda_lib.smem_bytes(
        "extrack_refine_smem", cuda.index or 0))
    assert pl.wide and pl.pair_threads == threads
    mu, sig = refine_kernel.refine(*args, window=W)
    mu0, sig0 = refine_kernel.refine_plain(*args, window=W)
    torch.testing.assert_close(mu, mu0, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(sig, sig0, rtol=2e-3, atol=2e-5)


@pytest.mark.cuda
def test_cuda_tiled_k6_chunks_match_one_launch(cuda, monkeypatch):
    # a budget of two tracks' carries cuts 4^7's batch in chunks of two:
    # the same results bit for bit
    from extrack_tpu_torch.ops import cuda_lib
    args = _tiled_args(cuda, 4, 7, 2, 7, 6, False)
    want = refine_kernel.refine(*args, window=7)
    carry = refine_kernel.plan(6, 2, 4 ** 7, 4, cuda_lib.smem_bytes(
        "extrack_refine_smem", cuda.index or 0)).carry
    monkeypatch.setattr(cuda_lib, "scratch_budget",
                        lambda *a, **k: 2 * carry)
    got = refine_kernel.refine(*args, window=7)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    monkeypatch.setattr(cuda_lib, "scratch_budget",
                        lambda *a, **k: carry - 1)
    with pytest.raises(RuntimeError, match="K6 scratch"):
        refine_kernel.refine(*args, window=7)


# ---- K4 past 16384 slots, up to 65536 ----------------------------------

# (S, W, D, dt): K = 16807 (predict_Bs at 7 states, its carries in shared
# memory), 46656 (6 states at frame_len 6), 59049 (the GUI's labeling
# window at 3 states) and 65536 (2 states at 16), in global scratch
PAST_16384_K4_CASES = [
    (7, 5, 2, None), (7, 5, 3, "track"), (6, 6, 1, "step"),
    (3, 10, 2, None), (3, 10, 3, "track"), (2, 16, 2, "step")]


@pytest.mark.cuda
@pytest.mark.parametrize("S,W,D,dt", PAST_16384_K4_CASES)
def test_cuda_k4_past_16384_slots_matches_plain(cuda, S, W, D, dt):
    # tracks longer than the window, so that frames leave it, and K4 alone
    # through predict (no plain call), bit-repeatable
    T = W + 3
    args = _case(cuda, S, 1, 8, T, D, seed=S + W + D, per_peak=(D == 2),
                 dt=dt)
    kw = dict(window=W, min_len=2)
    logl0, preds0 = predict_kernel.predict_plain(*args, **kw)
    before = predict_kernel.LAUNCHES, predict_kernel.PLAIN_CALLS
    logl, preds = predict_kernel.predict(*args, **kw)
    again = predict_kernel.predict(*args, **kw)
    assert (predict_kernel.LAUNCHES, predict_kernel.PLAIN_CALLS) == (
        before[0] + 2, before[1])
    assert torch.equal(logl, again[0]) and torch.equal(preds, again[1])
    torch.testing.assert_close(logl, logl0, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(preds, preds0, rtol=2e-3, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(2, 11, 1, 2, None), (3, 7, 2, 3, "step"),
                                  (16, 3, 2, 2, None)])
def test_cuda_k5_global_publish_on_smaller_registers(cuda, case):
    # the wide kernel with its publish areas and weights in global scratch
    # (wide = 2) against the one with them in shared memory, at registers
    # where both run
    S, W, n, D, dt = case
    T = (W - 1) // n + 5
    pos, lens, isbl, tb = _case(cuda, S, n, 16, T, D, seed=W, dt=dt)
    data_, tabs = _kernel_args((pos, lens, isbl, tb), W, n)
    want = hist_kernel.launch(data_, tabs, 2, S, W, n, mapping="wide")
    saved = cuda_lib.smem_bytes
    try:
        cuda_lib.smem_bytes = lambda query, index: 0
        got = hist_kernel.launch(data_, tabs, 2, S, W, n, mapping="wide")
    finally:
        cuda_lib.smem_bytes = saved
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("S,W,D", [(2, 11, 2), (3, 7, 3), (5, 5, 1)])
def test_cuda_k4_global_carries_on_smaller_registers(cuda, S, W, D):
    # K4's wide walk with its carries in global scratch against the one
    # with them in shared memory, at registers where both run
    T = W + 3
    args = _case(cuda, S, 1, 12, T, D, seed=S * W)
    data_, tabs = _kernel_args(args, W)
    want = predict_kernel.launch(data_, tabs, 2, S, W, stash="global")
    saved = cuda_lib.smem_bytes
    try:
        cuda_lib.smem_bytes = lambda query, index: 0
        got = predict_kernel.launch(data_, tabs, 2, S, W)
    finally:
        cuda_lib.smem_bytes = saved
    torch.testing.assert_close(got[0], want[0], rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(got[1], want[1], rtol=2e-3, atol=2e-4)


@pytest.mark.cuda
def test_cuda_sampler_runs_k2_alone_for_any_chunking(cuda):
    tracks, _, _ = simulate.sim_fov(nb_tracks=300, max_track_len=8,
                                    min_track_len=3, Ds=(0.0, 0.08),
                                    cell_dims=(0.5,), seed=3)
    C, W, S, L = 2, 9, 11, 4
    kw = dict(nb_states=2, num_chains=C, num_warmup=W, num_samples=S,
              n_leapfrog=L, cell_dims=(0.5,), seed=5)
    n_b = len(data.from_dict_bucketed(tracks, device=cuda))
    mods = (forward_kernel, grad_kernel, hvp_kernel)
    for m in mods:
        m.LAUNCHES = m.PLAIN_CALLS = 0
    a = sample.sample_posterior(tracks, 0.02, dispatch_chunk=4, **kw)
    steps_a = max(2 * W // 3, 1)
    iters = steps_a + max(W - steps_a, 1) + S
    assert grad_kernel.LAUNCHES == C * n_b * (1 + iters * (L + 1))
    assert forward_kernel.LAUNCHES == hvp_kernel.LAUNCHES == 0
    assert sum(m.PLAIN_CALLS for m in mods) == 0
    b = sample.sample_posterior(tracks, 0.02, dispatch_chunk=10_000, **kw)
    for k in a.samples:
        assert a.samples[k].dtype == np.float32
        np.testing.assert_array_equal(a.samples[k], b.samples[k])


@pytest.mark.cuda
def test_cuda_simulators_default_to_the_card(cuda):
    batches, states = simulate.sim_fov_batch(nb_tracks=2000,
                                             max_track_len=10, seed=1)
    for b, s in zip(batches, states):
        assert b.positions.device.type == "cuda" == s.device.type
        assert b.positions.dtype == torch.float32
        np.testing.assert_array_equal(b.lengths.cpu().numpy(), b.np_lengths)
    x, s = simulate.brownian_frames(None, 100, 6, (0.0, 0.1), (0.5, 0.5),
                                    [[0.9, 0.1], [0.1, 0.9]], 0.02, 0.02)
    assert x.device.type == "cuda" and x.dtype == torch.float32
    assert tuple(s.shape) == (100, 6)


def _kernel_counts():
    mods = (forward_kernel, grad_kernel, hvp_kernel, predict_kernel,
            hist_kernel, refine_kernel, topk_kernel)
    return ({f"K{i + 1}": m.LAUNCHES for i, m in enumerate(mods)},
            sum(m.PLAIN_CALLS for m in mods))


def _reset_counts():
    for m in (forward_kernel, grad_kernel, hvp_kernel, predict_kernel,
              hist_kernel, refine_kernel, topk_kernel):
        m.LAUNCHES = m.PLAIN_CALLS = 0


@pytest.fixture(scope="module")
def small_csv(tmp_path_factory):
    tracks, _, _ = simulate.sim_fov(
        nb_tracks=600, max_track_len=9, min_track_len=3, LocErr=0.02,
        Ds=(0.0, 0.08), dt=0.02, pBL=0.1, cell_dims=(0.5, None, None),
        seed=2)
    from extrack_tpu_torch.io import exporters
    path = tmp_path_factory.mktemp("csv") / "tracks.csv"
    exporters.save_extrack_2_CSV(str(path), tracks, {
        k: np.zeros(v.shape[:2] + (2,)) for k, v in tracks.items()}, 0.02)
    return path


@pytest.mark.cuda
def test_cuda_analyze_runs_the_kernels_alone(cuda, small_csv, tmp_path):
    """pipeline.analyze on the card: K2 for the fit, K4, K5 and K6 for the
    stages, no plain call; its stages equal the drivers on the card."""
    from extrack_tpu_torch import pipeline, predict, refine
    _reset_counts()
    res = pipeline.analyze(str(small_csv), dt=0.02, cell_dims=(0.5,),
                           export_csv=str(tmp_path / "out.csv"),
                           fit_kwargs={"max_iter": 20})
    counts, plain = _kernel_counts()
    assert plain == 0
    assert all(counts[k] > 0 for k in ("K2", "K4", "K5", "K6"))
    values = res.fit.params.resolve()
    preds = predict.predict_Bs(res.tracks, 0.02, values, cell_dims=(0.5,),
                               frame_len=fit.default_window(2))
    loc_err, ds, Fs, tr = refine.refinement_args(values, 2, 0.02)
    mus, _ = refine.position_refinement(
        res.tracks, loc_err, ds, Fs, tr,
        frame_len=refine.default_window(2, 9))
    for k in preds:
        np.testing.assert_allclose(res.preds[k], preds[k], rtol=2e-3,
                                   atol=2e-4)
        np.testing.assert_allclose(res.mus[k], mus[k], rtol=2e-4,
                                   atol=2e-5)
    hist = histograms.len_hist(res.tracks, values, 0.02, cell_dims=(0.5,),
                               window=7)
    # analyze's histogram has the JAX package's rows: zeros past the
    # longest track, up to its canonical length
    T = hist.shape[0]
    assert res.hist.shape == (pipeline._hist_rows(T), 2)
    np.testing.assert_allclose(res.hist[:T], hist, rtol=2e-3, atol=2e-4)
    assert not res.hist[T:].any()
    assert sum(1 for _ in open(tmp_path / "out.csv")) - 1 == sum(
        int(k) * len(v) for k, v in res.tracks.items())


@pytest.mark.cuda
@pytest.mark.parametrize("command,kernels", [
    (["fit"], ("K2", "K3")), (["predict"], ("K4",)),
    (["histogram"], ("K5",)), (["refine"], ("K6",)),
    (["sample", "--samples", "4", "--warmup", "4", "--n-leapfrog", "2"],
     ("K2", "K3"))])
def test_cuda_cli_runs_the_kernels_alone(cuda, small_csv, tmp_path, command,
                                         kernels):
    """Each analysis subcommand on the card (``-v`` reports the kernel
    launches of the process): its kernels launched, no plain call."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args = [command[0], str(small_csv), "--dt", "0.02", "--min-len", "3",
            "--max-len", "9", "--cell-dims", "0.5", "-o",
            str(tmp_path / "out"), *command[1:]]
    if command[0] != "fit":
        p = params.generate_params(nb_states=2, estimated_Ds=[0.0, 0.08])
        from extrack_tpu_torch.io import exporters
        exporters.save_params(p, str(tmp_path))
        args += ["--params", str(tmp_path / "params.json")]
    out = subprocess.run([sys.executable, "-m", "extrack_tpu_torch.cli",
                          "-v", *args], capture_output=True, text=True,
                         cwd=root, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines()
            if x.startswith("kernel launches: ")][-1]
    counts = json.loads(line[len("kernel launches: "):])
    assert all(counts[k]["launches"] > 0 for k in kernels), counts
    assert sum(v["plain_calls"] for v in counts.values()) == 0


@pytest.mark.cuda
def test_cuda_sharded_drivers_on_one_card(cuda, small_csv):
    """Every driver with ``sharded=True`` on a mesh of the one card: the
    unsharded drivers bit for bit (one shard, the same buckets), K2, K3,
    K4, K5 and K6 launched, no plain call; the one-card mesh has no
    process group."""
    from extrack_tpu_torch import predict, refine
    from extrack_tpu_torch.io import readers
    from extrack_tpu_torch.parallel import mesh as pmesh
    tracks, _, _ = readers.read_table(str(small_csv),
                                      lengths=list(range(3, 10)))
    mesh = pmesh.make_mesh()
    assert mesh.group is None
    assert mesh.devices == tuple(torch.device("cuda", i)
                                 for i in range(torch.cuda.device_count()))
    if mesh.size != 1:
        pytest.skip("the bit-for-bit check needs a mesh of one card")
    values = params.generate_params(nb_states=2,
                                    estimated_Ds=[0.0, 0.08]).resolve()
    loc_err, ds, Fs, tr = refine.refinement_args(values, 2, 0.02)

    def run(sharded):
        res = fit.param_fitting(tracks, 0.02, cell_dims=(0.5,), verbose=0,
                                compute_errors=True, max_iter=15,
                                sharded=sharded)
        return (res, predict.predict_Bs(tracks, 0.02, values,
                                        cell_dims=(0.5,), sharded=sharded),
                histograms.len_hist(tracks, values, 0.02, cell_dims=(0.5,),
                                    sharded=sharded),
                refine.position_refinement(tracks, loc_err, ds, Fs, tr,
                                           sharded=sharded))

    want = run(False)
    _reset_counts()
    got = run(True)
    counts, plain = _kernel_counts()
    assert plain == 0
    assert all(counts[k] > 0 for k in ("K2", "K3", "K4", "K5", "K6"))
    assert got[0].logl == want[0].logl
    assert got[0].std_errors == want[0].std_errors
    for k in want[1]:
        np.testing.assert_array_equal(got[1][k], want[1][k])
        np.testing.assert_array_equal(got[3][0][k], want[3][0][k])
    np.testing.assert_array_equal(got[2], want[2])


# ---- K2 and K3 past 1024 slots: the wide mapping ----------------------

# (S, W, n, D, dt): K = 1296, 2048 (two sub-steps), 2187, 3125 and 4096,
# D = 1..3, constant dt and variable dt per step and per track
WIDE_GRAD_CASES = [
    (6, 4, 1, 1, None), (6, 4, 1, 3, "track"), (2, 11, 2, 2, None),
    (2, 11, 2, 1, "step"), (3, 7, 1, 2, "track"), (3, 7, 1, 3, None),
    (5, 5, 1, 1, "step"), (5, 5, 1, 2, None), (4, 6, 1, 1, "track"),
    (4, 6, 1, 2, None), (4, 6, 1, 3, "step"), (4, 6, 1, 3, None)]


def _table_hvp64(args, seed, **kw):
    """K3's H.v along a random tangent of every table, and the plain
    double backward's in float64 on the same inputs."""
    pos, lens, isbl, tb = args
    gen = torch.Generator(device="cpu").manual_seed(seed)
    dot = tables.ModelTables(*(
        1e-2 * torch.randn(f.shape, generator=gen).to(f.device)
        for f in tb))
    _, _, hv = hvp_kernel.table_hvp(pos, lens, isbl, tb, dot, **kw)
    _, _, hv0 = hvp_kernel.table_hvp_plain(
        pos.double(), lens, isbl.double(),
        tables.ModelTables(*(f.double() for f in tb)),
        tables.ModelTables(*(f.double() for f in dot)), **kw)
    return hv, hv0


@pytest.mark.cuda
@pytest.mark.parametrize("S,W,n,D,dt", WIDE_GRAD_CASES)
def test_cuda_wide_k2_k3_match_plain(cuda, S, W, n, D, dt):
    # through the wrappers, whose default mapping past 1024 slots is the
    # wide one; tracks longer than the window, so that the register fuses
    T = W + 3
    args = _case(cuda, S, n, 24, T, D, seed=S + W + D, per_peak=(D == 2),
                 dt=dt)
    kw = dict(window=W, nb_substeps=n, min_len=2)
    data_, tabs = _kernel_args(args, W, n)
    K, A = S ** W, S ** n
    dev_index = cuda.index or 0
    pl, _, _ = grad_kernel.setup(
        cuda_lib.library(), "grad", 24, T, D, K, A,
        torch.device("cuda", dev_index), 4)
    assert pl.warps == grad_kernel.WIDE
    before = (grad_kernel.LAUNCHES, hvp_kernel.LAUNCHES,
              grad_kernel.PLAIN_CALLS + hvp_kernel.PLAIN_CALLS)
    v, g = grad_kernel.value_and_table_grads(*args, **kw)
    v0, g0 = grad_kernel.value_and_table_grads_plain(*args, **kw)
    torch.testing.assert_close(v, v0, rtol=2e-5, atol=0.0)
    for k in g:
        torch.testing.assert_close(g[k], g0[k], rtol=2e-3, atol=2e-3)
    # two launches bit-equal (no atomics), and the exchange in global
    # scratch against it in shared memory
    a = grad_kernel.launch(data_, tabs, 2)
    b = grad_kernel.launch(data_, tabs, 2)
    c = grad_kernel.launch(data_, tabs, 2, stash="global")
    for x, y, z in zip((a[0], a[1], *a[2]), (b[0], b[1], *b[2]),
                       (c[0], c[1], *c[2])):
        assert torch.equal(x, y) and torch.equal(x, z)
    hv, hv0 = _table_hvp64(args, S + W, **kw)
    for name in hv0:
        scale = float(hv0[name].abs().max())
        torch.testing.assert_close(hv[name].double(), hv0[name], rtol=5e-3,
                                   atol=1e-3 * scale)
    assert (grad_kernel.LAUNCHES, hvp_kernel.LAUNCHES,
            grad_kernel.PLAIN_CALLS + hvp_kernel.PLAIN_CALLS) == (
        before[0] + 4, before[1] + 1, before[2] + 2)
    # past 65536 slots or 16384 fusion groups: K2 and K3 raise, naming
    # the kernel and the window that fits
    W_past = _past_envelope(S, "K2")
    for fn, name in ((grad_kernel.value_and_table_grads, "K2"),
                     (lambda *a_, **k_: hvp_kernel.table_hvp(
                         *a_, args[3], **k_), "K3")):
        with pytest.raises(NotImplementedError,
                           match=rf"{name} maps at most (65536|16384).*"
                                 rf"window that fits is {W_past - 1}"):
            fn(*args, window=W_past, nb_substeps=1, min_len=2)


# (S, W, D): the wide mapping forced onto registers the warp and block
# mappings hold (K = 8 .. 1024; G from 4 to 512), against the block
# mapping, K2 and K3
WIDE_SMALL_GRAD_CASES = [(2, 3, 2), (2, 6, 1), (3, 5, 3), (2, 10, 2),
                         (4, 5, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("S,W,D", WIDE_SMALL_GRAD_CASES)
def test_cuda_k2_k3_wide_mapping_on_small_registers(cuda, S, W, D):
    args = _case(cuda, S, 1, 60, W + 3, D, seed=W, dt="track")
    data_, tabs = _kernel_args(args, W)
    K = S ** W
    wide = grad_kernel.launch(data_, tabs, 2, mapping="wide")
    block = grad_kernel.launch(data_, tabs, 2, mapping="block")
    torch.testing.assert_close(wide[0], block[0], rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(wide[1], block[1], rtol=2e-4,
                               atol=2e-5 * float(block[1].abs().max()))
    for c, c0 in zip(wide[2], block[2]):
        torch.testing.assert_close(c, c0, rtol=2e-4,
                                   atol=2e-5 * float(c0.abs().max()))
    rng = np.random.default_rng(K)
    dots = [torch.tensor(rng.normal(0, 1, t.shape), dtype=torch.float32,
                         device=cuda) for t in tabs]
    l2_dot = torch.zeros_like(data_[1])
    hw = hvp_kernel.launch(data_, tabs, l2_dot, dots, 2, mapping="wide")
    hb = hvp_kernel.launch(data_, tabs, l2_dot, dots, 2, mapping="block")
    for (a, a_dot), (b, b_dot) in zip(hw[:2], hb[:2]):
        torch.testing.assert_close(a, b, rtol=2e-4,
                                   atol=2e-5 * float(b.abs().max()))
        torch.testing.assert_close(a_dot, b_dot, rtol=2e-4,
                                   atol=2e-5 * float(b_dot.abs().max()))
    for a, b in zip(hw[2][0] + hw[2][1], hb[2][0] + hb[2][1]):
        torch.testing.assert_close(a, b, rtol=2e-4,
                                   atol=2e-5 * float(b.abs().max()))


@pytest.mark.cuda
def test_grad_layout(cuda):
    """K2's and K3's wide block as the source defines it
    (``extrack_grad_layout``) against the host twin ``wide_layout``, at
    every register of the envelope's shapes, every cluster size, both
    exchanges, float and dual numbers; below 1024 slots the default
    mappings stay the warp and block ones, above them the wide mapping's
    clusters, each of which the card keeps resident."""
    for S, W, n in ((6, 4, 1), (2, 11, 2), (3, 7, 1), (5, 5, 1), (4, 6, 1),
                    (2, 12, 1), (3, 5, 1), (6, 5, 1), (3, 8, 1), (5, 6, 1),
                    (4, 7, 1), (2, 13, 1), (2, 14, 1), (2, 14, 2),
                    (6, 6, 1), (4, 8, 1), (2, 15, 1), (3, 9, 1)):
        K, A = S ** W, S ** n
        for D in (1, 2, 3):
            for T in (2, 9, 40):
                for warps in (grad_kernel.WIDE, grad_kernel.WIDE_GLOBAL):
                    for C in grad_kernel.CLUSTER_SIZES:
                        for item in (4, 8):
                            assert cuda_lib.layout(
                                "grad", K, A, D, T, warps, C,
                                item) == tuple(grad_kernel.wide_layout(
                                    K, A, D, T, C,
                                    warps == grad_kernel.WIDE_GLOBAL, item))
    smem = cuda_lib.smem_bytes("extrack_grad_smem", cuda.index or 0)
    lib = cuda_lib.library()
    for K, A, want in ((64, 2, 4), (243, 3, 0), (1024, 4, 0),
                       (4096, 4, grad_kernel.WIDE),
                       (16384, 4, grad_kernel.WIDE),
                       (46656, 6, grad_kernel.WIDE),
                       (65536, 4, grad_kernel.WIDE)):
        pl = grad_kernel.plan(K, A, 3, 20, smem, lambda w, s: 1, 8)
        assert pl.warps == want
        if want < 0:
            for query in (lib.extrack_grad_cluster_occupancy,
                          lib.extrack_hvp_cluster_occupancy):
                assert query(3, K, A, 20, pl.warps, pl.cluster, 0) > 0


# K1, K2 and K3 past 4096 slots (S, W, n, D, dt): 6^5 (one block a
# cluster) and 3^8, 5^6 (the GUI's frame_len 6 at 5 states), 4^7 and 2^14
# on clusters of several blocks; K1's publish areas in global scratch at
# 2^14 from D = 2
PAST_4096_GRAD_CASES = [
    (6, 5, 1, 1, None), (3, 8, 1, 2, "track"), (5, 6, 1, 1, "step"),
    (5, 6, 1, 3, None), (4, 7, 1, 2, None), (4, 7, 1, 3, "track"),
    (2, 14, 1, 2, "step"), (2, 14, 1, 3, None), (2, 14, 2, 1, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("S,W,n,D,dt", PAST_4096_GRAD_CASES)
def test_cuda_k1_k2_k3_past_4096_slots_match_plain(cuda, S, W, n, D, dt):
    # through the wrappers; K1 and K2 repeatable bit for bit, K2 with its
    # exchange in global scratch equal to the plan's, K1 with its publish
    # areas forced to global scratch against the plain version (the two
    # instantiations may round differently: not bit-equal at D = 1); K3
    # against the plain double backward in float64
    T = 9
    args = _case(cuda, S, n, 20, T, D, seed=S * W + D, per_peak=(D == 2),
                 dt=dt)
    kw = dict(window=W, nb_substeps=n, min_len=2)
    before = (forward_kernel.LAUNCHES, grad_kernel.LAUNCHES,
              hvp_kernel.LAUNCHES)
    logl = forward_kernel.forward(*args, **kw)
    torch.testing.assert_close(logl, forward_kernel.forward_plain(*args,
                                                                  **kw),
                               rtol=2e-5, atol=2e-4)
    v, g = grad_kernel.value_and_table_grads(*args, **kw)
    v0, g0 = grad_kernel.value_and_table_grads_plain(*args, **kw)
    torch.testing.assert_close(v, v0, rtol=2e-5, atol=0.0)
    for k in g:
        torch.testing.assert_close(g[k], g0[k], rtol=2e-3, atol=2e-3)
    hv, hv0 = _table_hvp64(args, S + W + D, **kw)
    for name in hv0:
        scale = float(hv0[name].abs().max())
        torch.testing.assert_close(hv[name].double(), hv0[name], rtol=5e-3,
                                   atol=1e-3 * scale)
    assert (forward_kernel.LAUNCHES, grad_kernel.LAUNCHES,
            hvp_kernel.LAUNCHES) == (before[0] + 1, before[1] + 1,
                                     before[2] + 1)
    data_, tabs = _kernel_args(args, W, n)
    a = grad_kernel.launch(data_, tabs, 2)
    b = grad_kernel.launch(data_, tabs, 2)
    c = grad_kernel.launch(data_, tabs, 2, stash="global")
    for x, y, z in zip((a[0], a[1], *a[2]), (b[0], b[1], *b[2]),
                       (c[0], c[1], *c[2])):
        assert torch.equal(x, y) and torch.equal(x, z)
    k1 = forward_kernel.launch(data_, tabs, 2)
    assert torch.equal(k1, forward_kernel.launch(data_, tabs, 2))
    saved = cuda_lib.smem_bytes
    try:
        cuda_lib.smem_bytes = lambda query, index: 0
        k1g = forward_kernel.launch(data_, tabs, 2)
    finally:
        cuda_lib.smem_bytes = saved
    torch.testing.assert_close(k1g, forward_kernel.forward_plain(*args,
                                                                 **kw),
                               rtol=2e-5, atol=2e-4)


# K1, K2 and K3 past 16384 slots (S, W, n, D, dt): 6^6 (the GUI's frame_len
# 6 at 6 states) and 4^8 (16384 groups) at D =
# 1..3 with constant and variable dt, 2^15 (16384 groups) with K3's
# columns; 2^16 at two sub-steps (16384 groups of 4)
PAST_16384_GRAD_CASES = [
    (6, 6, 1, 1, None), (6, 6, 1, 2, "track"), (6, 6, 1, 3, "step"),
    (4, 8, 1, 1, "step"), (4, 8, 1, 2, None), (4, 8, 1, 3, "track"),
    (2, 15, 1, 2, None), (2, 16, 2, 1, "track")]


@pytest.mark.cuda
@pytest.mark.parametrize("S,W,n,D,dt", PAST_16384_GRAD_CASES)
def test_cuda_k1_k2_k3_past_16384_slots_match_plain(cuda, S, W, n, D, dt):
    # through the wrappers against the plain versions (K3 against the
    # plain double backward in float64), K1 and K2 bit for bit on a second
    # launch; one window more raises, naming the kernel
    T = 7
    args = _case(cuda, S, n, 8, T, D, seed=S * W + D, per_peak=(D == 2),
                 dt=dt)
    kw = dict(window=W, nb_substeps=n, min_len=2)
    before = (forward_kernel.LAUNCHES, grad_kernel.LAUNCHES,
              hvp_kernel.LAUNCHES, forward_kernel.PLAIN_CALLS,
              grad_kernel.PLAIN_CALLS, hvp_kernel.PLAIN_CALLS)
    logl = forward_kernel.forward(*args, **kw)
    v, g = grad_kernel.value_and_table_grads(*args, **kw)
    hv, hv0 = _table_hvp64(args, S + W + D, **kw)
    assert (forward_kernel.LAUNCHES, grad_kernel.LAUNCHES,
            hvp_kernel.LAUNCHES, forward_kernel.PLAIN_CALLS,
            grad_kernel.PLAIN_CALLS) == (
        before[0] + 1, before[1] + 1, before[2] + 1, before[3],
        before[4])
    torch.testing.assert_close(logl, forward_kernel.forward_plain(*args,
                                                                  **kw),
                               rtol=2e-5, atol=2e-4)
    v0, g0 = grad_kernel.value_and_table_grads_plain(*args, **kw)
    torch.testing.assert_close(v, v0, rtol=2e-5, atol=0.0)
    for k in g:
        torch.testing.assert_close(g[k], g0[k], rtol=2e-3, atol=2e-3)
    for name in hv0:
        scale = float(hv0[name].abs().max())
        torch.testing.assert_close(hv[name].double(), hv0[name], rtol=5e-3,
                                   atol=1e-3 * scale)
    data_, tabs = _kernel_args(args, W, n)
    a = grad_kernel.launch(data_, tabs, 2)
    b = grad_kernel.launch(data_, tabs, 2)
    for x, y in zip((a[0], a[1], *a[2]), (b[0], b[1], *b[2])):
        assert torch.equal(x, y)
    k1 = forward_kernel.launch(data_, tabs, 2)
    assert torch.equal(k1, forward_kernel.launch(data_, tabs, 2))
    with pytest.raises(NotImplementedError,
                       match="K2 maps at most (65536|16384)"):
        grad_kernel.value_and_table_grads(*args, window=W + 1,
                                          nb_substeps=n, min_len=2)


# K2 and K3 on the wide mapping's clusters past 2048 fusion groups (S, W,
# D, dt): 5^6 (two blocks a cluster), 6^6 (4 to 16) and 4^8 (8 and 16)
CLUSTER_GRAD_CASES = [
    (5, 6, 1, None), (5, 6, 2, "track"), (5, 6, 3, "step"),
    (6, 6, 1, "track"), (6, 6, 2, None), (6, 6, 3, None),
    (4, 8, 1, None), (4, 8, 2, "step"), (4, 8, 3, "track")]


@pytest.mark.cuda
@pytest.mark.parametrize("S,W,D,dt", CLUSTER_GRAD_CASES)
def test_cuda_cluster_k2_k3_match_plain(cuda, S, W, D, dt):
    # through the wrappers (whose plan is a cluster of more than one
    # block) against the plain versions; two launches of K2 and of K3 bit
    # for bit; K2 with its exchange in global scratch bit for bit; K2 on
    # twice the plan's cluster size (another order of block sums) within
    # the float32 tolerances
    T = 7
    args = _case(cuda, S, 1, 8, T, D, seed=3 * S * W + D, per_peak=(D == 2),
                 dt=dt)
    kw = dict(window=W, nb_substeps=1, min_len=2)
    data_, tabs = _kernel_args(args, W)
    K = S ** W
    P = forward_kernel.stream_patterns(tabs)
    dev = torch.device("cuda", cuda.index or 0)
    lib = cuda_lib.library()
    pl, nblk, _ = grad_kernel.setup(lib, "grad", 8, T, D, K, S, dev, 4, P=P)
    assert pl.warps == grad_kernel.WIDE and pl.cluster > 1
    assert nblk % pl.cluster == 0
    v, g = grad_kernel.value_and_table_grads(*args, **kw)
    v0, g0 = grad_kernel.value_and_table_grads_plain(*args, **kw)
    torch.testing.assert_close(v, v0, rtol=2e-5, atol=0.0)
    for k in g:
        torch.testing.assert_close(g[k], g0[k], rtol=2e-3, atol=2e-3)
    hv, hv0 = _table_hvp64(args, S + W + D, **kw)
    for name in hv0:
        scale = float(hv0[name].abs().max())
        torch.testing.assert_close(hv[name].double(), hv0[name], rtol=5e-3,
                                   atol=1e-3 * scale)
    a = grad_kernel.launch(data_, tabs, 2)
    b = grad_kernel.launch(data_, tabs, 2)
    c = grad_kernel.launch(data_, tabs, 2, stash="global")
    for x, y, z in zip((a[0], a[1], *a[2]), (b[0], b[1], *b[2]),
                       (c[0], c[1], *c[2])):
        assert torch.equal(x, y) and torch.equal(x, z)
    if pl.cluster < 16:
        d = grad_kernel.launch(data_, tabs, 2, cluster=2 * pl.cluster)
        for x, y in zip((a[0], a[1], *a[2]), (d[0], d[1], *d[2])):
            torch.testing.assert_close(x, y, rtol=2e-4,
                                       atol=2e-5 * float(y.abs().max()))
    rng = np.random.default_rng(K + D)
    dots = [torch.tensor(rng.normal(0, 1e-2, t.shape), dtype=torch.float32,
                         device=cuda) for t in tabs]
    l2_dot = torch.zeros_like(data_[1])
    h1 = hvp_kernel.launch(data_, tabs, l2_dot, dots, 2)
    h2 = hvp_kernel.launch(data_, tabs, l2_dot, dots, 2)
    for x, y in zip([*h1[0], *h1[1], *h1[2][0], *h1[2][1]],
                    [*h2[0], *h2[1], *h2[2][0], *h2[2][1]]):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_cuda_hessian_columns_at_32768_slots(cuda):
    # K3's Hessian columns at 2^15 (16384 fusion groups, clusters of 16)
    # through hessian_hvp_exact against the plain double backward, and
    # symmetric
    tr = np.full((2, 2), 0.1) + np.eye(2) * 0.8
    tracks, _, _ = simulate.sim_fov(
        nb_tracks=60, max_track_len=8, min_track_len=3, Ds=(0.0, 0.08),
        TrMat=tr, cell_dims=(0.5,), seed=3)
    spec = params.generate_params(nb_states=2, D_max=1.0,
                                  estimated_Ds=[0.001, 0.05])
    z = spec.to_unconstrained()
    kw = dict(cell_dims=(0.5,), window=15, min_len=2)
    gpu = data.from_dict_bucketed(tracks, device=cuda)
    cpu64 = data.from_dict_bucketed(tracks, device="cpu",
                                    dtype=torch.float64)
    before = hvp_kernel.LAUNCHES, hvp_kernel.PLAIN_CALLS
    H = fit.hessian_hvp_exact(gpu, spec, z, 0.02, 2, **kw)
    assert (hvp_kernel.LAUNCHES - before[0], hvp_kernel.PLAIN_CALLS) == (
        len(spec.free_names()) * len(gpu), before[1])
    H0 = fit.hessian_hvp_exact(cpu64, spec, z, 0.02, 2, **kw)
    scale = float(np.abs(H0).max())
    np.testing.assert_allclose(H, H0, rtol=5e-3, atol=1e-3 * scale)
    np.testing.assert_allclose(H, H.T, atol=2e-3 * scale)


# K7 past 1024 register rows (S, n, M, B, T, D, dt): 2048 and 4096 rows,
# pruned (3 states) and unpruned (2 states, 2^11 = 2048 sequences), the
# walk in shared memory (2048 rows at D = 1, 2) and in global scratch
PAST_1024_TOPK_CASES = [
    (3, 1, 2048, 60, 10, 2, None), (3, 1, 4096, 60, 10, 3, "track"),
    (2, 1, 2048, 40, 11, 1, None), (2, 1, 4096, 40, 12, 2, "step"),
    (2, 2, 4096, 30, 8, 2, None), (3, 1, 4096, 8, 30, 3, "step")]


@pytest.mark.cuda
@pytest.mark.parametrize("S,n,M,B,T,D,dt", PAST_1024_TOPK_CASES)
def test_cuda_topk_past_1024_rows_matches_plain(cuda, S, n, M, B, T, D, dt):
    # fused and raw, through the wrappers, against the plain version; the
    # same bits on a second launch; the fused rows against the raw
    # backpointers decoded; unpruned, every backpointer the plain one's
    pos, lens, isbl, tb = _case(cuda, S, n, B, T, D, seed=M + T + D, dt=dt)
    kw = dict(max_nb_states=M, min_len=3, nb_substeps=n)
    smem = cuda_lib.smem_bytes("extrack_topk_smem", cuda.index or 0)
    assert topk_kernel.wide(M, D, S ** n, smem)
    lay = topk_kernel.wide_layout(M, D, S ** n, S, T, smem)
    if T > 20:
        # at 4096 rows the walk passes the opt-in and, past 20 frames, so
        # do the fused backpointers: both in the block's global scratch
        assert not lay.walk_smem and not lay.bp_smem
    before = topk_kernel.LAUNCHES, topk_kernel.PLAIN_CALLS
    got = topk_kernel.segment_topk(pos, lens, isbl, tb, **kw)
    again = topk_kernel.segment_topk(pos, lens, isbl, tb, **kw)
    assert (topk_kernel.LAUNCHES, topk_kernel.PLAIN_CALLS) == (
        before[0] + 2, before[1])
    assert torch.equal(got, again)
    want = topk_kernel.segment_topk_plain(pos, lens, isbl, tb, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    par, st, wf = topk_kernel.backpointers(pos, lens, isbl, tb, **kw)
    par2, st2, wf2 = topk_kernel.backpointers(pos, lens, isbl, tb, **kw)
    assert torch.equal(par, par2) and torch.equal(st, st2)
    assert torch.equal(wf, wf2)
    data_, tabs = topk_kernel.kernel_inputs(pos, lens, isbl, tb, M, n)
    rows = torch.empty((B, T * S), device=cuda)
    topk_kernel.launch_fused(data_, tabs, rows, S, n, 3)
    dec = histograms.decode_backpointers(
        par, st, wf, lens, tables.state_codes(S, n + 1), S, M,
        per_track=True)
    torch.testing.assert_close(rows.view(B, T, S), dec, rtol=1e-5,
                               atol=1e-6)
    if S ** (n + 1) * (S ** n) ** (T - 2) <= M:
        par0, st0, wf0 = histograms.segment_backpointers(pos, lens, isbl,
                                                         tb, **kw)
        assert torch.equal(par.long(), par0) and torch.equal(st, st0)
        torch.testing.assert_close(wf, wf0, rtol=1e-4, atol=1e-5)
    with pytest.raises(NotImplementedError,
                       match="largest max_nb_states that fits is 4096"):
        topk_kernel.segment_topk(pos, lens, isbl, tb, max_nb_states=4097,
                                 nb_substeps=n)


@pytest.mark.cuda
def test_forward_layout(cuda):
    """K1's team as its source defines it (``extrack_forward_layout``):
    the wide mapping's two publish areas of (2D+1) floats a fusion group
    and the closings' partials in shared memory, or (-2) the partials
    alone there and the publish areas in the block's global scratch; a
    thread a group up to 1024; no block mapping."""
    import ctypes
    lib = cuda_lib.library()
    out = (ctypes.c_longlong * 3)()
    for S, W, n, D in ((3, 7, 1, 2), (6, 5, 1, 1), (5, 6, 1, 3),
                       (4, 7, 1, 3), (2, 14, 1, 2), (2, 14, 2, 1)):
        K, G = S ** W, S ** (W - n)
        for P in (0, S ** (n + 1)):
            assert lib.extrack_forward_layout(
                10, D, K, S ** n, -1, P, ctypes.addressof(out)) == 0
            assert tuple(out) == (min(1024, -(-G // 32) * 32),
                                  4 * (2 * (2 * D + 1) * G + 128), 0)
            assert lib.extrack_forward_layout(
                10, D, K, S ** n, -2, P, ctypes.addressof(out)) == 0
            assert tuple(out) == (min(1024, -(-G // 32) * 32), 4 * 128,
                                  4 * 2 * (2 * D + 1) * G)
    for warps in (0, -3):
        assert lib.extrack_forward_layout(10, 2, 243, 3, warps, 0,
                                          ctypes.addressof(out)) != 0
    assert lib.extrack_forward_layout(10, 2, 3 ** 11, 3, -1, 0,
                                      ctypes.addressof(out)) != 0
    # the plan: 2^14 at D = 3 passes the opt-in, 4^7 at D = 3 fits it
    smem = cuda_lib.smem_bytes("extrack_predict_smem", cuda.index or 0)
    for K, A, D, want in ((2 ** 14, 2, 3, forward_kernel.WIDE_GLOBAL),
                          (4 ** 7, 4, 3, forward_kernel.WIDE)):
        fixed = forward_kernel.layout(10, D, K, A, forward_kernel.WIDE)[0]
        assert forward_kernel.plan("K1", K, fixed, 0, smem, None).warps == (
            want)


@pytest.mark.cuda
def test_cuda_cli_fit_at_5_states_window_6(cuda, tmp_path):
    """``cli fit --states 5 --window 6`` (K = 15,625, the GUI's frame_len
    at 5 states) on a few hundred tracks: K2 and K3 launched, no plain
    call, a fit with error bars written."""
    import json
    import os
    import subprocess
    import sys
    tr = np.full((5, 5), 0.03) + np.eye(5) * 0.85
    tracks, _, _ = simulate.sim_fov(
        nb_tracks=400, max_track_len=8, min_track_len=3, LocErr=0.02,
        Ds=(0.0, 0.01, 0.03, 0.06, 0.1), TrMat=tr, dt=0.02, pBL=0.1,
        cell_dims=(0.5, None, None), seed=17)
    from extrack_tpu_torch.io import exporters
    csv = tmp_path / "tracks5.csv"
    exporters.save_extrack_2_CSV(str(csv), tracks, {
        k: np.zeros(v.shape[:2] + (2,)) for k, v in tracks.items()}, 0.02)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "extrack_tpu_torch.cli", "-v", "fit",
         str(csv), "--dt", "0.02", "--min-len", "3", "--max-len", "8",
         "--cell-dims", "0.5", "--states", "5", "--window", "6", "-o",
         str(tmp_path / "fit5.json")], capture_output=True, text=True,
        cwd=root, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines()
            if x.startswith("kernel launches: ")][-1]
    counts = json.loads(line[len("kernel launches: "):])
    assert counts["K2"]["launches"] > 0 and counts["K3"]["launches"] > 0
    assert sum(v["plain_calls"] for v in counts.values()) == 0
    assert (tmp_path / "fit5.json").exists()


@pytest.mark.cuda
def test_cuda_fit_at_4096_slots_runs_k2_k3_alone(cuda):
    # param_fitting at 4 states and the GUI's frame_len 6 (K = 4096) with
    # error bars: every gradient a K2 launch, every Hessian column a K3
    # one, no plain call
    tr = np.full((4, 4), 0.04) + np.eye(4) * 0.84
    tracks, _, _ = simulate.sim_fov(
        nb_tracks=400, max_track_len=9, min_track_len=3,
        Ds=(0.0, 0.01, 0.04, 0.1), TrMat=tr, cell_dims=(0.5,), seed=8)
    mods = (forward_kernel, grad_kernel, hvp_kernel)
    for m in mods:
        m.LAUNCHES = m.PLAIN_CALLS = 0
    res = fit.param_fitting(tracks, 0.02, nb_states=4, frame_len=6,
                            compute_errors=True, max_iter=3, verbose=0,
                            cell_dims=(0.5,))
    n_b = len(data.from_dict_bucketed(tracks, device=cuda))
    assert grad_kernel.LAUNCHES >= n_b
    assert hvp_kernel.LAUNCHES == len(res.std_errors) * n_b
    assert sum(m.PLAIN_CALLS for m in mods) == 0
    assert np.isfinite(res.logl)
    assert all(np.isfinite(v) for v in res.std_errors.values())
