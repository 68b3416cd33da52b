"""K6's tiled wide mapping (csrc/refine.cu, past 1024 slots): the scan
kernel writes both sides' precision forms of every interior frame; the pair
kernel takes one (track, interior position, state block, row tile) a block,
R prefix rows a thread against the block's columns in shared-memory tiles,
J = 8/R columns a rescale; a block's partial goes to a fixed slot and the
merge adds a position's partials in their fixed order.

* a float64 model of that decomposition (``_tiled_model``: rows dealt to
  threads as the kernel deals them, the column tiles and J-groups with
  pair_tile's tile-max rescale, warp and block partials, the merge in its
  order) against the port's ``refine.refine_positions`` at 1e-12 and the
  JAX package's XLA ``refine_positions`` at 1e-7, at 3^7 and 4^6, D =
  1..3, per-peak errors, tracks of 1, 2 and T frames, for
  ``pair_threads``' pick there and the block sizes it picks elsewhere;
* the host twin of the kernel's layout and grid (``_layout``, csrc/refine.cu
  refine_layout) at 4^7, 5^6, 3^8 and 2^14, D = 1..3, on a model of an
  80 GB card with 132 SMs: the scan block's shared bytes within the opt-in
  (the publish areas in global scratch exactly where they pass it), the
  pair kernel's tiles within 48 KB, the chunks' scratch under the budget,
  the grid within 2^31 blocks, and the raise where one track's carry
  passes the budget.

The kernels themselves run only on a card (tests/test_torch_cuda.py).
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from extrack_tpu import refine as jrefine
from extrack_tpu_torch import refine as trefine
from extrack_tpu_torch.ops import cuda_lib, forward_kernel, refine_kernel
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)
from tests.refine_tiled_twin import layout as _layout

LOG2E = 1.0 / math.log(2.0)
TILE = 512                # csrc/refine.cu kTileCols
SMEM = 232448             # shared bytes a block may opt in to on an H100
CARD = 80 * 10 ** 9       # an 80 GB card: half of it is the budget's bound
SMS = 132


def _case(S, B, T, D, seed, per_peak):
    """Random walks, lengths (T, 2, 1, 0, T-1, ...), a transition matrix
    with a forbidden move (its log floored at log 1e-300, as both packages
    take it), per-state displacement variances."""
    rng = np.random.default_rng(seed)
    xs = rng.normal(0.0, 0.05, (B, T, D)).cumsum(1)
    lengths = rng.integers(3, T + 1, B)
    lengths[:5] = (T, 2, 1, 0, T - 1)[:B]
    tr = np.full((S, S), 0.1 / (S - 1))
    np.fill_diagonal(tr, 0.9)
    tr[0, -1] = 0.0
    tr /= tr.sum(1, keepdims=True)
    l2 = (rng.uniform(1e-4, 9e-4, (B, T, D)) if per_peak
          else np.full((1, 1, 1), 4e-4))
    return (xs, lengths, l2, np.log(np.maximum(tr, 1e-300)),
            2 * np.linspace(0.001, 0.1, S) * 0.02)


def _forms(m, s2, lp, x, l2, obs):
    """A side's precision forms (csrc/refine.cu make_form): b in base 2
    with the slot's normalizer, Pt = l2/s2 (+ obs), Nt = (m - x)/s2 *
    sqrt(l2 log2(e) / 2)."""
    p = 1.0 / s2
    a = m - x[..., None, :]
    b = (LOG2E * (lp - 0.5 * (a * a * p).sum(-1))
         - 0.5 * torch.log2(s2.prod(-1)))
    kn = torch.sqrt(0.5 * LOG2E * l2)
    return b, l2[..., None, :] * p + obs, a * p * kn[..., None, :]


def _pair_groups(b1, A, C, b2, B2, N2, mx, acc):
    """csrc/refine.cu pair_tile, called once a J-group in turn, on every
    thread at once: rows (..., R) b1 and (..., R, D) A, C; columns (..., G,
    J) of G groups in their order (a masked column's b2 is -inf); the
    running max mx (...) and sums acc (..., 1+2D).  Group g rescales to
    top_g = max(top_{g-1}, max_r(row max + b1)) and weighs its pairs by
    2^(arg - max(top_g - b1, row max)), as the kernel's loop does; the
    sums are carried to the last group's top."""
    P = A[..., :, None, None, :] + B2[..., None, :, :, :]  # (.., R, G, J, D)
    N = C[..., :, None, None, :] + N2[..., None, :, :, :]
    D = P.shape[-1]
    o = torch.stack([torch.prod(P[..., [e for e in range(D) if e != d]], -1)
                     for d in range(D)], -1)
    r = torch.rsqrt(P[..., 0] * o[..., 0])
    av = N * o
    arg = (N * av).sum(-1) * r * r + b2[..., None, :, :]
    rmax = arg.amax(-1)                                   # (..., R, G)
    top = torch.cummax(torch.maximum(
        (rmax + b1[..., None]).amax(-2), mx[..., None]), -1).values
    off = torch.maximum(top[..., None, :] - b1[..., None], rmax)
    e = torch.exp2(arg - off[..., None])
    z = (e * r ** 3)[..., None]
    part = torch.cat([(e * r).sum(-1)[..., None], (z * av).sum(-2),
                      (z * o).sum(-2)], -1).sum(-3)       # (..., G, 1+2D)
    last = top[..., -1]
    acc = (acc * torch.exp2(mx - last)[..., None]
           + (part * torch.exp2(top - last[..., None])[..., None]).sum(-2))
    return last, acc


def _pairs_model(pre, suf, S, R, NT, tile_of=None, order=None):
    """The pair and merge kernels on (..., K) forms of one position each:
    (max, sums) of every position.  ``tile_of`` maps a tile index to the
    tile read (the identity; the mutation check changes it), ``order`` the
    merge's order of a position's partials (s-major, then row tiles)."""
    (b1, A1, C1), (b2, A2, C2) = pre, suf
    lead, (K, D) = b1.shape[:-1], A1.shape[-2:]
    KS = K // S
    J = 8 // R
    nrt = -(-KS // (R * NT))

    def blocks(t):
        return t.reshape(lead + (S, KS) + t.shape[len(lead) + 1:])

    b1, A1, C1, b2, A2, C2 = map(blocks, (b1, A1, C1, b2, A2, C2))
    # thread t of row tile rt: rows rt*R*NT + rr*NT + t
    rows = (torch.arange(nrt)[:, None, None] * R * NT
            + torch.arange(R)[None, None, :] * NT
            + torch.arange(NT)[None, :, None])            # (nrt, NT, R)
    live = rows < KS
    idx = rows.clamp(max=KS - 1)
    rb1 = torch.where(live, b1[..., idx], -math.inf)      # (.., S, nrt, NT, R)
    rA, rC = A1[..., idx, :], C1[..., idx, :]
    # the columns in the kernel's order: tile k (copied from tile
    # tile_of(k)), its J-groups, the last one masked past the tile's n
    cols, masks = [], []
    ntile = -(-KS // TILE)
    for k in range(ntile):
        kt = k if tile_of is None else tile_of(k, ntile)
        n = min(TILE, KS - kt * TILE)
        j = torch.arange(0, min(TILE, KS - k * TILE), J)[:, None] \
            + torch.arange(J)
        cols.append(kt * TILE + j.clamp(max=n - 1))
        masks.append(j < n)
    cols, masks = torch.cat(cols), torch.cat(masks)       # (groups, J)
    mx = torch.full(rb1.shape[:-1], -1e30, dtype=b1.dtype)
    acc = torch.zeros(rb1.shape[:-1] + (1 + 2 * D,), dtype=b1.dtype)
    for g in range(0, len(cols), 64 // J):
        c, m = cols[g:g + 64 // J], masks[g:g + 64 // J]
        cb2 = torch.where(m, b2[..., c], -math.inf)
        mx, acc = _pair_groups(
            rb1, rA, rC, cb2[..., None, None, :, :],
            A2[..., c, :][..., None, None, :, :, :],
            C2[..., c, :][..., None, None, :, :, :], mx, acc)
    # warp partials (lanes), then thread 0 in warp order
    w_mx = mx.reshape(mx.shape[:-1] + (NT // 32, 32))
    w_acc = acc.reshape(acc.shape[:-2] + (NT // 32, 32, 1 + 2 * D))
    wm = w_mx.amax(-1)
    v = (w_acc * torch.exp2(w_mx - wm[..., None])[..., None]).sum(-2)
    top = wm.amax(-1)                                     # (.., S, nrt)
    sm = (v * torch.exp2(wm - top[..., None])[..., None]).sum(-2)
    # the merge: a position's S * nrt partials in their order
    top = top.flatten(-2)
    sm = sm.flatten(-3, -2)
    if order is not None:
        top, sm = top[..., order(S * nrt)], sm[..., order(S * nrt), :]
    best = top.amax(-1)
    return best, (sm * torch.exp2(top - best[..., None])[..., None]).sum(-2)


def _tiled_model(xs, lengths, l2, log_trans, sig2, W, R, NT, **mutate):
    """(mu, sigma) (B, T, D) of the tiled wide K6 in float64: the two
    sides' registers from the plain scans, their forms, the interior
    positions through ``_pairs_model``, the ends one side each."""
    B, T, D = xs.shape
    S = log_trans.shape[0]
    l2 = l2.expand(B, T, D)
    pre, suf = trefine._sides(xs, lengths, l2, log_trans, sig2, W)
    mu = torch.zeros((B, T, D), dtype=xs.dtype)
    var = torch.zeros((B, T, D), dtype=xs.dtype)
    # the interior positions (c, p), 1 <= p <= L-2 (the pair kernel's
    # other blocks exit at once)
    c, p = torch.nonzero((torch.arange(T)[None, :] >= 1)
                         & (torch.arange(T)[None, :] < lengths[:, None] - 1),
                         as_tuple=True)
    if c.numel():
        x, l2p = xs[c, p], l2[c, p]
        fp = _forms(pre[0][c, p], pre[1][c, p], pre[2][c, p], x, l2p, 1.0)
        fs = _forms(suf[0][c, p], suf[1][c, p], suf[2][c, p], x, l2p, 0.0)
        _, sm = _pairs_model(fp, fs, S, R, NT, **mutate)
        kn = torch.sqrt(0.5 * LOG2E * l2p)
        mu[c, p] = x + sm[..., 1:1 + D] * (l2p / kn) / sm[..., :1]
        var[c, p] = sm[..., 1 + D:] * l2p / sm[..., :1]

    def end(m, s2, lp, x, l2_):
        a = m - x[:, None, :]
        tot = l2_[:, None, :] + s2
        w = LOG2E * (lp - 0.5 * (a * a / tot).sum(-1))
        r = torch.exp2(w - w.amax(-1, keepdim=True)) * tot.prod(-1).rsqrt()
        mean = (r[..., None] * a * l2_[:, None, :] / tot).sum(1)
        v = (r[..., None] * s2 * l2_[:, None, :] / tot).sum(1)
        s = r.sum(-1, keepdim=True)
        return x + mean / s, v / s

    last = (lengths - 1).clamp(min=0)
    ar = torch.arange(B)
    m0, v0 = end(suf[0][:, 0], suf[1][:, 0], suf[2][:, 0], xs[:, 0],
                 l2[:, 0])
    m1, v1 = end(pre[0][ar, last], pre[1][ar, last], pre[2][ar, last],
                 xs[ar, last], l2[ar, last])
    mu[:, 0], var[:, 0] = m0, v0
    mu[ar, last], var[ar, last] = m1, v1
    lone = lengths == 1
    mu[lone, 0], var[lone, 0] = xs[lone, 0], l2[lone, 0]
    valid = (torch.arange(T)[None, :] < lengths[:, None])[..., None]
    return (torch.where(valid, mu, 0.0),
            torch.where(valid, var.clamp(min=0.0).sqrt(), 0.0))


# (S, W, D, per-peak, B, T): 3^7 (KS = 729: a partial tile, rows padded)
# and 4^6 (KS = 1024: two full tiles); tracks of T, 2 and 1 frames (T = 3
# but once: the plain version takes 1.6 M and 4.2 M pairs a position and
# track on the CPU, interior or not), D = 1..3
MODEL_CASES = [(3, 7, 1, True, 5, 5), (3, 7, 2, False, 3, 3),
               (3, 7, 3, True, 3, 3), (4, 6, 1, False, 3, 3),
               (4, 6, 2, True, 3, 3), (4, 6, 3, False, 3, 3)]


@pytest.mark.parametrize("S,W,D,per_peak,B,T", MODEL_CASES)
def test_tiled_model_matches_refine_positions(S, W, D, per_peak, B, T):
    args = [torch.tensor(a) for a in _case(S, B, T, D, S * W + D, per_peak)]
    want = trefine.refine_positions(*args, window=W)
    got = _tiled_model(*args, W, refine_kernel.PAIR_ROWS,
                       refine_kernel.pair_threads(S ** (W - 1)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12,
                                   atol=1e-15)


@pytest.mark.parametrize("NT", [128, 160, 224, 256])
def test_tiled_model_other_pair_shapes(NT):
    """The block sizes ``pair_threads`` picks at other shapes (6^4, 5^5,
    5^6, 4^7), here at 3^7: row tiles of 256 to 512 rows over K/S = 729
    (two or three tiles, the last padded)."""
    args = [torch.tensor(a) for a in _case(3, 3, 3, 2, 11, True)]
    want = trefine.refine_positions(*args, window=7)
    got = _tiled_model(*args, 7, refine_kernel.PAIR_ROWS, NT)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12,
                                   atol=1e-15)


@pytest.mark.parametrize("S,W,D", [(3, 7, 2), (4, 6, 3)])
def test_tiled_model_matches_jax_xla(S, W, D):
    """Against the JAX package's XLA refinement (its path past the Pallas
    kernel's VMEM budget) at 1e-7, as tests/test_torch_refine_past_4096.py
    holds the plain version; a track of three frames and one of two."""
    xs, lengths, l2, lt, s2 = _case(S, 2, 3, D, S + W, True)
    lengths[:] = (3, 2)
    got = _tiled_model(*(torch.tensor(a) for a in (xs, lengths, l2, lt, s2)),
                       W, refine_kernel.PAIR_ROWS,
                       refine_kernel.pair_threads(S ** (W - 1)))
    want = jrefine.refine_positions(
        *(jnp.asarray(a) for a in (xs, lengths, l2, lt, s2)), window=W)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-7,
                                   atol=1e-12)


def test_mutated_tiles_and_merge_order_are_caught():
    """The comparison sees every tile read from the first one's columns,
    tiles read in turn from the next (3^7: the 217-column tile read where
    512 are due) and a merge that reads every other partial twice; a
    permuted merge order stays within rounding (a max-shifted sum)."""
    args = [torch.tensor(a) for a in _case(3, 3, 5, 1, 9, False)]
    want = trefine.refine_positions(*args, window=7)
    got = _tiled_model(*args, 7, 2, 64,
                       order=lambda n: torch.arange(n).flip(0))
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-12,
                               atol=1e-15)
    for bad in (dict(tile_of=lambda k, n: 0),
                dict(tile_of=lambda k, n: (k + 1) % n),
                dict(order=lambda n: torch.arange(n) // 2 * 2)):
        got = _tiled_model(*args, 7, 2, 64, **bad)
        assert not np.allclose(got[0].numpy(), want[0].numpy(), rtol=1e-7)


@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("S,W", [(4, 7), (5, 6), (3, 8), (2, 14)])
def test_tiled_layout_and_grid_on_an_h100(S, W, D):
    K = S ** W
    KS = K // S
    nt = refine_kernel.pair_threads(KS)
    assert nt % 32 == 0 and nt <= refine_kernel.PAIR_THREADS
    rows = refine_kernel.PAIR_ROWS * nt
    nrt = -(-KS // rows)
    assert (nrt - 1) * rows < KS <= nrt * rows
    budget = min(cuda_lib.WIDE_SCRATCH_BUDGET, CARD // 2)
    for T in (3, 10, 20, 60):
        pl = refine_kernel.plan(T, D, K, S, SMEM, layout=_layout)
        w1 = _layout(T, D, K, S, 1, rows)
        assert pl.wide == (2 if w1[1] > SMEM else 1)
        assert pl.pair_threads == nt
        assert pl.threads == 1024 and pl.fixed <= SMEM
        # the pair kernel's two tiles of forms and its static partials
        tile = min(TILE, -(-KS // 4) * 4)
        assert 2 * {1: 4, 2: 5, 3: 8}[D] * tile * 4 + 16 + 8 * (2 + 2 * D) \
            * 4 <= 48 * 1024
        B = 1 << 14
        n = refine_kernel.chunk_tracks(B, pl.carry, budget)
        assert 1 <= n <= B and n * pl.carry <= budget
        assert n == B or (n + 1) * pl.carry > budget
        assert n * (T - 2) * S * nrt < 2 ** 31
    # the publish areas pass the opt-in at 2^14 from D = 2 only
    assert refine_kernel.plan(10, D, K, S, SMEM, layout=_layout).wide == (
        2 if (S, W) == (2, 14) and D >= 2 else 1)


def test_tiled_chunks_raise_past_the_budget():
    """One track's carry past the budget raises, naming the batch and the
    bytes; a budget of a few carries cuts the batch in chunks."""
    pl = refine_kernel.plan(40, 3, 4 ** 7, 4, SMEM, layout=_layout)
    with pytest.raises(RuntimeError, match=rf"K6 scratch \({pl.carry} "
                                           r"bytes.*of 300 tracks"):
        refine_kernel.chunk_tracks(300, pl.carry, pl.carry - 1)
    assert refine_kernel.chunk_tracks(300, pl.carry, 3 * pl.carry + 1) == 3
    assert refine_kernel.chunk_tracks(2, pl.carry, 30 * pl.carry) == 2


def test_pair_threads_cover_every_wide_register():
    """Every register past 1024 slots up to 16384 (S <= 8) gets the wide
    mapping and pair-kernel blocks of a multiple of 32 threads up to 256
    whose row tiles pad K/S by less than one tile; the scan block stages
    its forms in shared memory exactly where they, its publish areas and
    partials take at most 200 KB."""
    picks = set()
    for S in range(2, 9):
        for W in range(2, 15):
            K = S ** W
            if not 1024 < K <= 16384:
                continue
            assert forward_kernel.mapping_warps("K6", K) == \
                forward_kernel.WIDE
            nt = refine_kernel.pair_threads(K // S)
            rows = refine_kernel.PAIR_ROWS * nt
            nrt = -(-(K // S) // rows)
            assert nrt * rows - K // S < rows
            assert nt % 32 == 0 and 32 <= nt <= 256
            picks.add(nt)
    # the card tests' TILED_K6_PAIR_SHAPES take each of these
    assert picks == {128, 160, 192, 224, 256}
    # 6^4 and 3^7 stage at D = 1..3, 4^6 at D = 1 only, 4^7 never
    for (S, W, D), staged in (((6, 4, 1), True), ((6, 4, 3), True),
                              ((3, 7, 3), True), ((4, 6, 1), True),
                              ((4, 6, 2), False), ((4, 7, 1), False)):
        K = S ** W
        frames = 2 * {1: 4, 2: 5, 3: 8}[D] * K // S * S
        fixed = _layout(10, D, K, S, 1, 512)[1]
        assert (fixed >= 4 * frames) == staged
