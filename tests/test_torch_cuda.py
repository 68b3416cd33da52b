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
weights of an unpruned register rtol 1e-4 / atol 1e-5.
"""
import numpy as np
import pytest
import torch

from extrack_tpu_torch import data, fit, histograms, params
from extrack_tpu_torch.core import tables
from extrack_tpu_torch.ops import (forward_kernel, grad_kernel, hist_kernel,
                                   hvp_kernel, predict_kernel, refine_kernel,
                                   topk_kernel)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _case(dev, S, n, B, T, D, seed=5):
    rng = np.random.default_rng(seed)
    xs = rng.normal(0, 0.06, (B, T, D)).cumsum(1)
    lengths = rng.integers(0, T + 1, B)
    lengths[:2] = (T, 2)
    isbl = (lengths < T).astype(np.float32)
    f32 = dict(dtype=torch.float32, device=dev)
    rates = torch.full((S, S), 0.08, **f32)
    rates[0, -1] = 0.0
    tb = tables.build_tables(
        torch.linspace(0, 0.12, S, **f32), torch.tensor(0.02, **f32),
        torch.full((S,), 1.0 / S, **f32), rates, torch.tensor(0.1, **f32),
        0.02, cell_dims=(0.8,), nb_substeps=n)
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
    per_track = tb._replace(sig2=tb.sig2.expand(50, 5, -1))
    with pytest.raises(NotImplementedError, match="dt"):
        grad_kernel.neg_log_likelihood(pos, lens, isbl, per_track, window=4)
    # a float64 input raises instead of running the kernel in float32
    with pytest.raises(NotImplementedError, match="float64"):
        grad_kernel.neg_log_likelihood(pos.double(), lens, isbl, tb, window=4)
    with pytest.raises(NotImplementedError, match="float64"):
        forward_kernel.forward(pos, lens, isbl,
                               tb._replace(log_trans=tb.log_trans.double()),
                               window=4)
    assert (forward_kernel.LAUNCHES, grad_kernel.LAUNCHES) == (
        before[0] + 1, before[1])


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


@pytest.mark.cuda
@pytest.mark.parametrize("S,W,B,T,D", [(2, 5, 300, 9, 2), (3, 3, 77, 12, 3),
                                       (2, 4, 5, 2, 1), (2, 9, 40, 60, 2)])
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
        hist_kernel.hist(pos, lens, isbl, tb, window=11 if S == 2 else 7)


@pytest.mark.cuda
@pytest.mark.parametrize("S,W,B,T,D,per_peak", [
    (2, 5, 300, 9, 2, False), (3, 4, 77, 12, 3, True), (4, 3, 5, 2, 1, False),
    (2, 8, 16, 60, 2, True)])               # stash in global scratch
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
        topk_kernel.segment_topk(pos, lens, isbl, tb, max_nb_states=2048,
                                 nb_substeps=n)
    per_track = tb._replace(sig2=tb.sig2.expand(B, T - 1, -1))
    with pytest.raises(NotImplementedError, match="dt"):
        topk_kernel.segment_topk(pos, lens, isbl, per_track, **kw)


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
