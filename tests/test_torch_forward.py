"""The algorithms of K1 (csrc/forward.cu) and K4 (csrc/predict.cu) as the
kernels run them (csrc/walk.cuh), rendered in float64 torch on the CPU and
held to the plain engine, which tests/test_torch_engine.py and
tests/test_torch_predict.py hold to the JAX package.

The rendition follows the kernels step for step: the fusion in base 2 with
each step's normalizers as rsqrt factors; the one-pass closings (an online
log-sum-exp in base 2 per lane of a warp, then the lanes' largest maximum
and their rescaled sums); and K4's posteriors without a history: each
fusion that drops a frame stashes its weights, and at the last frame the
register's softmax is carried back through them (group masses, then member
masses in place of the weights, whose sums over the groups are the dropped
frames' posteriors), while the frames still in the window come from the
slots' digit codes.  In float64 every operation is exact to rounding, so
it matches the engine within 1e-10.  Also here: the pure-Python ``plan``
and ``grid`` that map a K1 or K4 launch onto the card, each kernel's
register limit, and the wide mapping's blocks (K1, K4, K5 and K6 past
1024 slots; K1, K4 and K5 past 4096 with their carries in global scratch
where shared memory cannot hold them, and K2's and K3's, a thread up to
eight fusion groups, with their exchange there) at every register of its
envelope.
"""
import math

import numpy as np
import pytest
import torch

from extrack_tpu_torch.core import engine, tables
from extrack_tpu_torch.ops import cuda_lib, forward_kernel, grad_kernel
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)

LOG2E = 1.0 / math.log(2.0)
NEG_BIG = -1e30


def _case(S, n, B, T, D, seed):
    """Tracks of lengths 0..T (0, 1, 2 and T among them), per-peak
    localization errors and a forbidden transition, in float64."""
    rng = np.random.default_rng(seed)
    xs = torch.tensor(rng.normal(0, 0.06, (B, T, D)).cumsum(1))
    lengths = rng.integers(0, T + 1, B)
    lengths[:4] = (T, 2, 1, 0)
    isbl = torch.tensor((rng.random(B) < 0.5).astype(np.float64))
    rates = torch.tensor(rng.uniform(0.03, 0.2, (S, S)))
    rates[0, -1] = 0.0                                # forbidden
    tb = tables.build_tables(
        torch.linspace(0.0, 0.12, S, dtype=torch.float64),
        torch.tensor(0.02, dtype=torch.float64),
        torch.full((S,), 1.0 / S, dtype=torch.float64), rates,
        torch.tensor(0.1, dtype=torch.float64), 0.02, cell_dims=(0.8,),
        nb_substeps=n)
    tb = tb._replace(loc_err2=torch.tensor(rng.uniform(1e-4, 9e-4,
                                                       (B, T, D))))
    return xs, torch.tensor(lengths), isbl, tb


def _slot_tables(tb, W, n, D):
    """The kernels' ten tables in float64 (forward_kernel.kernel_inputs
    without the cast to float32): the per-step 2 pi constant folded into
    lt."""
    lp0, sig2v, lt, lsurv, end, _ = forward_kernel.build_slot_tables(
        tb, W, n)
    lt = lt - 0.5 * D * math.log(2 * math.pi)
    return ([lp0, sig2v, lt, lsurv, end, sig2v],
            forward_kernel.build_next_tables(tb, W, n))


def _lse2_add(acc, g, r):
    """lse2_add: a term r * 2^g into (mx, s), rescaling on a new max."""
    mx, s = acc
    if g > mx:
        return g, s * 2.0 ** (mx - g) + r
    return mx, s + r * 2.0 ** (g - mx)


def _team_lse2(lanes):
    """warp_lse2: the lanes' largest maximum, each lane's sum rescaled to
    it once, then summed."""
    m = max(mx for mx, _ in lanes)
    return m, sum(s * 2.0 ** (mx - m) for mx, s in lanes)


def _warp_lse2(terms):
    """The one-pass closing of a warp: lane l accumulates the terms of its
    slots l, l+32, ... in order, then the lanes combine."""
    lanes = [(NEG_BIG, 0.0)] * 32
    for k, g, r in terms:
        lanes[k % 32] = _lse2_add(lanes[k % 32], g, r)
    return _team_lse2(lanes)


def walk_rendition(xs, lengths, isbl, tb, W, n=1, min_len=3, preds=False):
    """logL (B,) and, with ``preds``, the posteriors (B, T, S) as K1 / K4
    compute them, track by track."""
    B, T, D = xs.shape
    S = tb.nb_states
    K, A = S ** W, S ** n
    G = K // A
    (lp0, s20, lt, lsurv, endv, sig2v), (ltn, s2n, lsn, endn) = _slot_tables(
        tb, W, n, D)
    l2s = tb.loc_err2.expand(B, T, D)
    cl2pi = 0.5 * D * math.log(2 * math.pi)
    bits = max(S - 1, 1).bit_length()
    codes = [sum(((k // S ** i) % S) << (bits * i) for i in range(W))
             for k in range(K)]
    slot = torch.arange(K)
    logl = torch.zeros(B, dtype=torch.float64)
    post = torch.zeros((B, T, S), dtype=torch.float64)
    for b in range(B):
        L = min(int(lengths[b]), T)
        if L < 2:
            continue
        x, l2, bl = xs[b], l2s[b], float(isbl[b])
        m = x[0].expand(K, D).clone()
        s2 = l2[0] + s20[:, None]
        lp = lp0.clone()
        stash = torch.full((max(T - W, 0), K), float("nan"),
                           dtype=torch.float64)
        for t in range(1, L):
            # update2: the slot's Gaussian update against frame t
            tot = l2[t] + s2
            quad = (0.5 * (x[t] - m) ** 2 / tot).sum(1)
            prod = tot.prod(1)
            nm = (m * l2[t] + x[t] * s2) / tot
            tl = l2[t] * s2 / tot
            if t == L - 1:
                fin = LOG2E * (lp + bl * endv - quad)
                r = prod ** -0.5
                mx, s = _warp_lse2(zip(range(K), fin.tolist(), r.tolist()))
                if L == 2:
                    logl[b] = (mx + math.log2(s)) * math.log(2) - cl2pi
                if preds:
                    p = 2.0 ** (fin - mx) * r / s
                    nh = L - W
                    for i in range(max(-nh, 0), W):
                        dig = torch.tensor([(c >> (bits * i)) & ((1 << bits)
                                                                 - 1)
                                            for c in codes])
                        for st in range(S):
                            post[b, nh + i, st] = p[dig == st].sum()
                    # carry the softmax back through the stashed weights:
                    # group masses (slot c = a*G + g is g's child a), then
                    # member c = g*A + o of the step gets mass_g * w_{g,o}
                    q = p
                    for f in range(nh - 1, -1, -1):
                        mass = q.view(A, G).sum(0)
                        stash[f] = mass.repeat_interleave(A) * stash[f]
                        q = stash[f]
                    if nh > 0:
                        post[b, :nh] = stash[:nh].view(nh, G, A).sum(1)
                break
            gate = 1.0 if t + 1 >= min_len else 0.0
            if t == L - 2:
                # the look-ahead closing, each child once
                terms = []
                for k in range(K):
                    for a in range(A):
                        totn = s2n[k, a] + tl[k] + l2[t + 1]
                        quad_n = (0.5 * (x[t + 1] - nm[k]) ** 2 / totn).sum()
                        c = ltn[k, a] + gate * lsn[k, a] + bl * endn[k, a]
                        g = LOG2E * (lp[k] - quad[k] + c - quad_n)
                        rr = (prod[k] * (2 * math.pi) ** D
                              * totn.prod()) ** -0.5
                        terms.append((k, float(g), float(rr)))
                mx, s = _warp_lse2(terms)
                logl[b] = (mx + math.log2(s)) * math.log(2) - cl2pi
                if not preds:
                    break
            # publish2 / group2: base-2 weights of each group's members
            base = (LOG2E * (lp - quad)).view(G, A)
            rq = (prod ** -0.5).view(G, A)
            gmx = base.max(1, keepdim=True).values
            w = 2.0 ** (base - gmx) * rq
            sw = w.sum(1, keepdim=True)
            w = w / sw                                 # (G, A) weights
            mf = torch.einsum("go,god->gd", w, nm.view(G, A, D))
            tf = torch.einsum("go,god->gd", w, tl.view(G, A, D))
            lse = (gmx[:, 0] + torch.log2(sw[:, 0])) * math.log(2)
            g_of = slot % G                            # child c = a*G + g
            m = mf[g_of]
            s2 = sig2v[:, None] + tf[g_of]
            lp = lse[g_of] + lt + gate * lsurv
            fd = t + 1 - W
            if preds and fd >= 0:
                # member g*A + o's fusion weight, for the backward pass
                stash[fd] = w.reshape(K)
    return (logl, post) if preds else logl


@pytest.mark.parametrize("S,W,T,D", [
    (2, 5, 10, 2), (2, 3, 9, 1), (2, 4, 3, 3), (3, 3, 8, 2), (2, 6, 5, 2),
    (4, 2, 7, 2), (3, 4, 9, 3)])
def test_k4_rendition_matches_engine(S, W, T, D):
    # group-level frame-major history with the fusion's own weights,
    # digit-masked window harvest; T = 3 and W >= T give tracks shorter
    # than the window, and every case has 0-, 1- and 2-frame tracks
    xs, lengths, isbl, tb = _case(S, 1, 9, T, D, seed=S * 100 + W * 10 + T)
    logl, post = walk_rendition(xs, lengths, isbl, tb, W, preds=True)
    l0, p0 = engine.forward(xs, lengths, isbl, tb, window=W, min_len=3,
                            return_preds=True)
    torch.testing.assert_close(logl, l0, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(post, p0, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("S,W,n,T,D", [
    (2, 6, 1, 9, 2), (2, 4, 2, 8, 1), (3, 3, 1, 7, 3), (2, 5, 3, 6, 2),
    (2, 3, 1, 2, 2), (5, 2, 1, 6, 2)])
def test_k1_one_pass_closing_matches_engine(S, W, n, T, D):
    # the look-ahead closing in one pass (online max and sum per lane, a
    # butterfly merge), at one to three sub-steps; T = 2 closes on the
    # register itself
    xs, lengths, isbl, tb = _case(S, n, 9, T, D, seed=S * 100 + W * 10 + n)
    logl = walk_rendition(xs, lengths, isbl, tb, W, n=n, min_len=2)
    want = engine.forward(xs, lengths, isbl, tb, window=W, nb_substeps=n,
                          min_len=2)
    torch.testing.assert_close(logl, want, rtol=1e-10, atol=1e-10)


def test_lse2_lanes_without_slots_add_nothing():
    # lanes without a slot stay at (kNegBig, 0) and must not turn a real
    # sum into NaN; a floored log weight (-1e15 in base 2) stays finite
    assert _team_lse2([(NEG_BIG, 0.0)] * 32) == (NEG_BIG, 0.0)
    assert _team_lse2([(NEG_BIG, 0.0)] * 31 + [(3.0, 2.0)]) == (3.0, 2.0)
    mx, s = _lse2_add(_lse2_add((NEG_BIG, 0.0), -1.4e15, 1.0), 2.0, 0.5)
    assert (mx, s) == (2.0, 0.5)


def _occupancy(fixed, hist, regs_warps=24, K=0):
    """Blocks an SM keeps resident on an H100-like SM: 228 KB of shared
    memory (1 KB reserved a block) and ``regs_warps`` warps by the
    registers; a team is a warp (warps > 0) or a block of K slots."""
    def occ(warps, smem):
        block = max(warps, 1) * (fixed + (hist if smem else 0))
        by_regs = regs_warps // (warps or -(-K // 32))
        return min(by_regs, (228 * 1024) // (block + 1024))
    return occ


def _team_bytes(K, S, D, T, W, warp=True):
    """A K4 team's shared bytes besides its stash of fusion weights, and
    the stash's (csrc/walk.cuh walk_layout; the card test
    test_predict_layout reads the kernel's own)."""
    G = K // S
    pub = 2 * (2 + 2 * D) * K
    fixed = pub + (4 * T * D + 4 if warp else 128 + W * S * 32) + K + G
    return 4 * fixed, 4 * max(T - W, 0) * (K | 1)


@pytest.mark.parametrize("S,W,T,plan", [
    (2, 3, 10, (4, True)), (2, 4, 10, (4, True)), (2, 5, 10, (4, True)),
    (3, 3, 20, (4, True)), (2, 5, 20, (4, True)), (2, 6, 20, (4, True)),
    (2, 6, 40, (4, False)), (2, 5, 60, (4, False))])
def test_walk_plan_warp_mapping_up_to_64_slots(S, W, T, plan):
    # every register up to 64 slots walks one track a warp.  The stash
    # stays in shared memory while 24 warps an SM still fit there; at
    # K = 64, T = 40 a warp's slice is 14 KB and at K = 32, T = 60 11 KB:
    # global scratch keeps more tracks resident
    K = S ** W
    fixed, stash = _team_bytes(K, S, 2, T, W)
    occ = _occupancy(fixed, stash)
    pl = forward_kernel.plan("K4", K, fixed, stash, 227 * 1024, occ)
    assert pl == forward_kernel.Plan(*plan)
    assert forward_kernel.plan("K4", K, fixed, stash, 227 * 1024, occ,
                               stash="smem").stash_smem
    assert forward_kernel.plan("K4", K, fixed, stash, 227 * 1024, occ,
                               stash="global") == forward_kernel.Plan(4, False)
    # K1 has no stash: four warps a block
    assert forward_kernel.plan("K1", K, fixed, 0, 227 * 1024, None) == (
        forward_kernel.Plan(4, False))


@pytest.mark.parametrize("S,W,T,smem", [
    (3, 5, 10, True), (2, 10, 14, True), (4, 4, 9, True), (3, 4, 10, True),
    (3, 4, 30, False)])
def test_walk_plan_block_mapping_above_64_slots(S, W, T, smem):
    # one block a track above 64 slots.  At K = 81 and T = 30 the stash
    # would cost 7 of 21 resident blocks, so it goes to global scratch; at
    # T = 10 it costs none, and at K = 243, 256 and 1024 the registers bind
    # first.  K1 (no stash) runs the wide mapping there
    K = S ** W
    fixed, stash = _team_bytes(K, S, 2, T, W, warp=False)
    occ = _occupancy(fixed, stash, regs_warps=64, K=K)
    assert forward_kernel.plan("K4", K, fixed, stash, 227 * 1024, occ) == (
        forward_kernel.Plan(0, smem))
    assert forward_kernel.plan("K1", K, fixed, 0, 227 * 1024, None) == (
        forward_kernel.Plan(forward_kernel.WIDE, False))
    with pytest.raises(ValueError, match="K <= 64"):
        forward_kernel.plan("K4", K, fixed, stash, 227 * 1024, occ,
                            mapping="warp")
    assert forward_kernel.plan("K4", 32, fixed, stash, 227 * 1024, occ,
                               mapping="block", stash="smem") == (
        forward_kernel.Plan(0, True))


def test_walk_plan_stash_in_global_scratch_when_it_does_not_fit():
    # T = 2000 at K = 32: one warp's stash alone is 263 KB
    fixed, stash = _team_bytes(32, 2, 2, 2000, 5)
    occ = _occupancy(fixed, stash)
    assert forward_kernel.plan("K4", 32, fixed, stash, 227 * 1024, occ) == (
        forward_kernel.Plan(4, False))
    with pytest.raises(ValueError, match="does not fit"):
        forward_kernel.plan("K4", 32, fixed, stash, 227 * 1024, occ,
                            stash="smem")
    # K = 243 at T = 200: it fits, but one block an SM against eight
    fixed, stash = _team_bytes(243, 3, 2, 200, 5, warp=False)
    assert forward_kernel.plan("K4", 243, fixed, stash, 227 * 1024,
                               _occupancy(fixed, stash, 64, 243)) == (
        forward_kernel.Plan(0, False))


def test_walk_grid():
    # resident blocks fill the card, no more blocks than the tracks need
    pl = forward_kernel.Plan(4, True)
    assert forward_kernel.grid(1 << 20, pl, 132, 6, 4096) == (792, 0)
    assert forward_kernel.grid(5, pl, 132, 6, 4096) == (2, 0)
    # K1 (no history) and the block mapping: one track a block
    assert forward_kernel.grid(1 << 20, forward_kernel.Plan(0, False), 132,
                               3) == (396, 0)
    # global scratch: one history a warp, capped by the budget
    nblk, nbytes = forward_kernel.grid(1 << 20, forward_kernel.Plan(4, False),
                                       132, 6, 4096)
    assert (nblk, nbytes) == (792, 792 * 4 * 4096)
    big = 1 << 22
    nblk, nbytes = forward_kernel.grid(1 << 20, forward_kernel.Plan(4, False),
                                       132, 6, big)
    assert nblk == (1 << 30) // (4 * big) and nbytes == nblk * 4 * big


# ---- the wide mapping: 1024 < K <= 4096 (K1, K6), 16384 (K4, K5) -------

SMEM = 232448             # shared bytes a block may opt in to on an H100
# every register of the wide mapping's envelope, K = S^W in (1024, 4096],
# and K4's and K5's past it, in (4096, 16384]
WIDE_REGISTERS = [(S, W) for S in range(2, 65) for W in range(2, 13)
                  if 1024 < S ** W <= 4096]
PAST_4096_REGISTERS = [(S, W) for S in range(2, 129) for W in range(2, 15)
                       if 4096 < S ** W <= 16384]
# and K4's past that, in (16384, 65536]
PAST_16384_REGISTERS = [(S, W) for S in range(2, 257) for W in range(2, 17)
                        if 16384 < S ** W <= 65536]


def _wide_threads(G):
    return min(1024, -(-G // 32) * 32)


def _wide_walk_bytes(K, A, S, D, T, W, pred, carries_global=False):
    """A K1/K4 block of the wide mapping: its shared bytes besides K4's
    stash, the stash's bytes and its threads (csrc/walk.cuh wide_layout;
    with ``carries_global`` wide_global_layout: the partials' bytes, and
    the publish areas (K4: softmax and stash too) in global scratch; the
    card tests test_predict_layout and test_forward_layout read the
    kernel's own)."""
    G = K // A
    carries = 2 * (2 * D + 1) * G + ((W * S * 32 + K) if pred else 0)
    stash = (T - W) * (K | 1) if pred and T > W else 0
    if carries_global:
        return (4 * (128 + (W * S * 32 if pred else 0)),
                4 * (2 * (2 * D + 1) * G + (K if pred else 0) + stash),
                _wide_threads(G))
    return 4 * (carries + 128), 4 * stash, _wide_threads(G)


def _wide_hist_bytes(K, A, S, D, T, pub_global=False):
    """K5's wide block (csrc/hist.cu hist_layout): threads, shared bytes
    besides the rows, the rows' bytes a track (with ``pub_global`` the
    publish areas and member weights too, in global scratch after the
    rows; test_hist_layout reads the kernel's own)."""
    G = K // A
    pub, rows = 4 * (2 * (2 * D + 1) * G + K), 4 * 2 * G * (1 + S) * T
    if pub_global:
        return _wide_threads(G), 0, rows + pub
    return _wide_threads(G), pub, rows


def _wide_refine_bytes(K, S, D, T):
    """K6's wide block (csrc/refine.cu refine_layout): threads, shared
    bytes besides the forms, the forms' bytes a track (two prefix frames
    and the stash; test_refine_layout reads the kernel's own)."""
    frame = {1: 4, 2: 5, 3: 8}[D] * (-(-K // 4) * 4)
    return (1024, 4 * (2 * (2 * D + 1) * (K // S) + 32 * 32 * (2 + 2 * D)),
            4 * T * frame if T > 2 else 0)


def test_mapping_choice_and_per_kernel_limits():
    # K1: a warp up to 64 slots, a thread a fusion group above, up to
    # 16384; K4: a warp up to 64, a thread a slot up to 1024, a thread a
    # fusion group up to 65536; K5 and K6 (a block a track) go wide past
    # 1024, K5 up to 2^19, K6 up to 16384; K2 and K3 (grad_kernel.plan) to
    # 65536
    W = forward_kernel.WIDE
    Ks = (64, 65, 1024, 1025, 4096)
    assert [forward_kernel.mapping_warps("K1", K) for K in Ks] == [
        1, W, W, W, W]
    assert [forward_kernel.mapping_warps("K4", K) for K in Ks] == [
        1, 0, 0, W, W]
    for k in ("K5", "K6"):
        assert [forward_kernel.mapping_warps(k, K) for K in Ks] == [
            0, 0, 0, W, W]
    for K in (243, 2187):
        assert forward_kernel.plan("K1", K, 0, 0, 0, None) == (
            forward_kernel.Plan(W, False))
    # K4 on tracks no longer than its window has no stash: still a block
    assert forward_kernel.plan("K4", 243, 0, 0, 0, None) == (
        forward_kernel.Plan(0, False))
    assert forward_kernel.plan("K4", 729, 0, 0, 0, None, mapping="wide") == (
        forward_kernel.Plan(W, False))
    assert [forward_kernel.mapping_warps("K4", 64, m)
            for m in ("warp", "block", "wide")] == [1, 0, W]
    assert forward_kernel.mapping_warps("K5", 243, "wide") == W
    with pytest.raises(ValueError, match="block mapping takes K <= 1024"):
        forward_kernel.plan("K4", 2048, 0, 0, 0, None, mapping="block")
    for k in ("K4", "K5"):
        assert forward_kernel.mapping_warps(k, 16384) == W
    # K4 goes on to 65536 (7^5, 6^6, 3^10, 2^16); K5 to 2^19 (5^7, 6^7,
    # 4^8, 5^8), K6 to 16384 (6^5, 3^8, 5^6, 4^7)
    for K in (16807, 46656, 59049, 65536):
        assert forward_kernel.mapping_warps("K4", K) == W
        assert forward_kernel.mapping_warps("K4", K, "wide") == W
    with pytest.raises(ValueError, match="wide mapping takes K <= 65536"):
        forward_kernel.mapping_warps("K4", 65537, "wide")
    for K in (78125, 279936, 65536, 390625, 1 << 19):
        assert forward_kernel.mapping_warps("K5", K, "wide") == W
    with pytest.raises(ValueError, match="wide mapping takes K <= 524288"):
        forward_kernel.mapping_warps("K5", 3 ** 12, "wide")
    for K in (7776, 6561, 15625, 16384):
        assert forward_kernel.mapping_warps("K6", K) == W
    with pytest.raises(ValueError, match="wide mapping takes K <= 16384"):
        forward_kernel.mapping_warps("K6", 16807)
    # K1 goes on to 65536 (6^5, 5^6, 4^7, 2^14, 6^6, 4^8) and stops there
    for K in (7776, 15625, 16384, 46656, 65536):
        assert forward_kernel.mapping_warps("K1", K) == W
    with pytest.raises(ValueError, match="wide mapping takes K <= 65536"):
        forward_kernel.mapping_warps("K1", 78125)
    with pytest.raises(ValueError, match="K1 has the mappings"):
        forward_kernel.plan("K1", 243, 0, 0, 0, None, mapping="block")
    with pytest.raises(ValueError, match="K6 has the mappings"):
        forward_kernel.mapping_warps("K6", 64, "warp")
    # a zero warp limit (the card tests' and chip_smoke's way to force
    # the team mappings) moves K1 to the wide mapping and K4 to the block
    saved = forward_kernel.WARP_MAX_K
    try:
        forward_kernel.WARP_MAX_K = 0
        assert [forward_kernel.mapping_warps(k, 32)
                for k in ("K1", "K4")] == [W, 0]
    finally:
        forward_kernel.WARP_MAX_K = saved
    assert forward_kernel.MAX_SLOTS == {"K1": 65536, "K2": 65536,
                                        "K3": 65536, "K4": 65536,
                                        "K5": 524288, "K6": 16384}
    assert forward_kernel.MAX_GROUPS == {"K1": 16384, "K2": 16384,
                                         "K3": 16384}


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4", "K5", "K6"])
def test_check_envelope_names_each_kernels_limit(kernel):
    limit = forward_kernel.MAX_SLOTS[kernel]
    forward_kernel.check_envelope(10, 2, 2, 10, 1, kernel=kernel)  # 1024
    if limit >= 4096:
        forward_kernel.check_envelope(10, 2, 2, 12, 1, kernel=kernel)
        forward_kernel.check_envelope(10, 2, 3, 7, 1, kernel=kernel)
    if limit >= 16384:
        # the JAX package's defaults: predict_Bs at 6 states (6^5),
        # len_hist at two sub-steps (2^13) and at 4 states (4^7)
        forward_kernel.check_envelope(10, 2, 6, 5, 1, kernel=kernel)
        forward_kernel.check_envelope(10, 2, 2, 13, 2, kernel=kernel)
        forward_kernel.check_envelope(10, 2, 4, 7, 1, kernel=kernel)
    groups = forward_kernel.MAX_GROUPS.get(kernel)
    if limit >= 65536:
        # K4: predict_Bs at 7 states (7^5) and 6 states at frame_len 6
        # (6^6), the GUI's labeling window at 3 states (3^10); K5 too.
        # K1, K2 and K3 stop at 16384 fusion groups (3^10, 2^16), naming
        # the largest window that fits
        for S, W in ((7, 5), (6, 6), (3, 10), (4, 8), (2, 16)):
            if groups is None or S ** (W - 1) <= groups:
                forward_kernel.check_envelope(10, 2, S, W, 1, kernel=kernel)
                continue
            with pytest.raises(NotImplementedError,
                               match=rf"K/A={S ** (W - 1)} > {groups} "
                                     rf"fusion groups \({kernel} maps at "
                                     rf"most {groups}.*window that fits is "
                                     rf"{W - 1}\)"):
                forward_kernel.check_envelope(10, 2, S, W, 1, kernel=kernel)
    if limit == 1 << 19:
        # K5: len_hist's default window 7 at 5 and 6 states, window 8 at 5
        for S, W in ((5, 7), (6, 7), (5, 8), (2, 19)):
            forward_kernel.check_envelope(10, 2, S, W, 1, kernel=kernel)
    # past the limit: the bucket, the kernel, its limit and the largest
    # window that fits (3 states: 6 for 1024 slots, 7 for 4096, 8 for
    # 16384, 10 for 65536 (9 within 16384 fusion groups), 11 for 2^19)
    fits = {1024: 6, 4096: 7, 16384: 8, 65536: 10, 524288: 11}[limit]
    past = fits + 1                  # the first window past the slots
    if groups is not None:
        fits = 9
    K = 3 ** past
    with pytest.raises(NotImplementedError,
                       match=(rf"bucket 2 .*K=S\*\*window={K} > {limit} "
                              rf"register slots \({kernel} maps at most "
                              rf"{limit}.*window that fits is {fits}")):
        forward_kernel.check_envelope(10, 2, 3, past, 1, what="bucket 2",
                                      kernel=kernel)


@pytest.mark.parametrize("D", [1, 2, 3])
def test_wide_walk_blocks_fit_every_register(D):
    # K1 and K4 at every register of the envelope: at most 1024 threads,
    # the publish areas and partials always fit a block's shared memory
    # (so the block launches with its stash in global scratch), the stash
    # in shared memory only where it fits, and global scratch within the
    # budget
    def occ_of(fixed, stash, threads):
        def occ(warps, smem):
            assert warps == forward_kernel.WIDE
            block = fixed + (stash if smem else 0)
            return min(2048 // threads, (228 * 1024) // (block + 1024))
        return occ

    for S, W in WIDE_REGISTERS:
        K = S ** W
        assert forward_kernel.mapping_warps("K4", K) == forward_kernel.WIDE
        fixed, _, threads = _wide_walk_bytes(K, S, S, D, 0, W, False)
        assert threads % 32 == 0 and 32 <= threads <= 1024
        assert fixed <= SMEM
        assert forward_kernel.plan("K1", K, fixed, 0, SMEM, None) == (
            forward_kernel.Plan(forward_kernel.WIDE, False))
        for T in (W + 1, 20, 60):
            fixed, stash, threads = _wide_walk_bytes(K, S, S, D, T, W, True)
            assert fixed <= SMEM
            occ = occ_of(fixed, stash, threads)
            pl = forward_kernel.plan("K4", K, fixed, stash, SMEM, occ)
            assert pl.warps == forward_kernel.WIDE
            assert not pl.stash_smem or fixed + stash <= SMEM
            nblk, nbytes = forward_kernel.grid(1 << 17, pl, 132,
                                               occ(pl.warps, pl.stash_smem),
                                               stash)
            assert 1 <= nblk <= 132 * (2048 // threads)
            assert nbytes == (0 if pl.stash_smem else nblk * stash)
            assert nbytes <= cuda_lib.SCRATCH_BUDGET


# K1, K2 and K3 past 4096 slots: every (S, W, n) with 4096 < S^W <= 16384,
# S <= 8 states and n <= 2 sub-steps (A = S^n children a fusion group)
PAST_4096_FIT = [(S, W, n) for S in range(2, 9) for W in range(2, 15)
                 for n in (1, 2) if 4096 < S ** W <= 16384 and n < W]


@pytest.mark.parametrize("D", [1, 2, 3])
def test_k1_past_4096_slots_plans_fit_every_register(D):
    # K1's wide team past 4096 slots: WIDE_GLOBAL exactly where its two
    # publish areas and partials pass a block's opt-in, and then nonzero
    # scratch from grid (the publish areas, no stash), within the budget
    def occ(warps, smem):
        return 1
    n_global = 0
    for S, W, n in PAST_4096_FIT:
        K, A = S ** W, S ** n
        assert forward_kernel.mapping_warps("K1", K) == forward_kernel.WIDE
        fixed, stash, threads = _wide_walk_bytes(K, A, S, D, 20, W, False)
        assert stash == 0 and threads <= 1024
        pl = forward_kernel.plan("K1", K, fixed, 0, SMEM, occ)
        if fixed > SMEM:
            n_global += 1
            assert pl == forward_kernel.Plan(forward_kernel.WIDE_GLOBAL,
                                             False)
            fixed, team, threads = _wide_walk_bytes(K, A, S, D, 20, W,
                                                    False, True)
            assert fixed <= SMEM and team == 4 * 2 * (2 * D + 1) * (K // A)
            nblk, nbytes = forward_kernel.grid(1 << 17, pl, 132, occ(0, 0),
                                               team)
            assert nbytes == nblk * team > 0 and nblk == 132
            assert nbytes <= cuda_lib.SCRATCH_BUDGET
            # the card's free memory bounds the grid
            assert forward_kernel.grid(1 << 17, pl, 132, 1, team,
                                       5 * team) == (5, 5 * team)
        else:
            assert pl == forward_kernel.Plan(forward_kernel.WIDE, False)
            assert forward_kernel.grid(1 << 17, pl, 132, 1) == (132, 0)
    # 2 states at W = 14 (8192 groups) pass the opt-in from D = 2 on
    # (327,680 bytes of publish areas; 196,608 at D = 1); 4 states at W = 7
    # (4096 groups) fit it even at D = 3, 229,376 bytes
    assert (n_global > 0) == (D > 1)
    assert (_wide_walk_bytes(2 ** 14, 2, 2, D, 20, 14, False)[0] > SMEM) == (
        D > 1)
    assert _wide_walk_bytes(4 ** 7, 4, 4, 3, 20, 7, False)[0] == (
        229376 + 512) <= SMEM
    with pytest.raises(ValueError, match="K1's wide team"):
        forward_kernel.plan("K1", 2 ** 14, SMEM + 4, 0, SMEM, occ,
                            stash="smem")


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("D", [1, 2, 3])
def test_k2_k3_past_4096_slots_plans_fit_every_register(D, itemsize):
    # K2 (floats) and K3 (dual numbers) past 4096 slots: the wide mapping
    # in clusters of C blocks of at most 1024 threads, a thread at most
    # WIDE_GROUPS groups; each block's slice of the exchange in its shared
    # memory (every register here fits at some C); the clusters' scratch
    # and partial rows within the budget handed in
    clustered = 0
    for S, W, n in PAST_4096_FIT:
        K, A = S ** W, S ** n
        G = K // A
        for T in (2, 9, 20, 40):
            pl = grad_kernel.plan(K, A, D, T, SMEM, None, itemsize)
            assert pl.warps == grad_kernel.WIDE
            C = pl.cluster
            assert C in grad_kernel.CLUSTER_SIZES
            lay = grad_kernel.wide_layout(K, A, D, T, C, False, itemsize)
            Gc = -(-G // C)
            assert lay.threads % 32 == 0 and lay.threads <= 1024
            assert -(-Gc // lay.threads) <= grad_kernel.WIDE_GROUPS
            xch = (2 * D + 1) * Gc * A
            assert lay.smem == (64 + xch) * itemsize <= SMEM
            assert lay.scratch == max(T - 3, 0) * (2 * D + 1) * G * itemsize
            # the smallest such C: one size less leaves a thread more
            # than two groups or a slice past the opt-in
            if C > 1:
                half = grad_kernel.wide_layout(K, A, D, T, C // 2, False,
                                               itemsize)
                assert (-(-G // (C // 2)) > 2 * 1024
                        or half.smem > SMEM)
                clustered += 1
            per = lay.scratch + grad_kernel.partial_bytes(K, A, itemsize)
            resident = 132 // C
            for budget in (cuda_lib.SCRATCH_BUDGET, 7 * per):
                nblk, floats = grad_kernel.grid(1 << 14, T, D, K, pl, 132,
                                                resident, itemsize, A,
                                                budget)
                assert nblk == C * min(resident, budget // per)
                assert floats * 4 == nblk // C * lay.scratch
                assert nblk // C * per <= budget
    # past 2048 groups (3 states at W = 8, 4 at W = 7, 5 at W = 6, 2 at W
    # = 13 and 14) a cluster of more than one block
    assert clustered > 0
    assert [grad_kernel.cluster_size(S ** W, S, D, 20, SMEM, itemsize)[0]
            > 1 for S, W in ((3, 8), (4, 7), (5, 6), (2, 14))] == [True] * 4
    # past 16384 groups the wide mapping refuses
    with pytest.raises(ValueError, match="at most 16384 fusion groups"):
        grad_kernel.plan(2 ** 15, 1, D, 20, SMEM, None, itemsize,
                         mapping="wide")


@pytest.mark.parametrize("D", [1, 2, 3])
def test_k4_past_4096_slots_plans_fit_every_register(D):
    # K4 at every register of (4096, 16384]: where its wide team passes a
    # block's shared memory the plan takes WIDE_GLOBAL (carries and stash
    # in global scratch, the partials alone in shared memory), else the
    # wide mapping as below 4096; global scratch within the budget
    def occ(warps, smem):
        return 2
    n_global = 0
    for S, W in PAST_4096_REGISTERS:
        K = S ** W
        assert forward_kernel.mapping_warps("K4", K) == forward_kernel.WIDE
        for T in (W, W + 1, 20, 60):
            fixed, stash, threads = _wide_walk_bytes(K, S, S, D, T, W, True)
            pl = forward_kernel.plan("K4", K, fixed, stash, SMEM, occ)
            if fixed > SMEM:
                n_global += 1
                assert pl == forward_kernel.Plan(forward_kernel.WIDE_GLOBAL,
                                                 False)
                fixed, stash, threads = _wide_walk_bytes(K, S, S, D, T, W,
                                                         True, True)
            else:
                assert pl.warps == forward_kernel.WIDE
            assert fixed <= SMEM and threads <= 1024
            nblk, nbytes = forward_kernel.grid(1 << 17, pl, 132, 2, stash)
            assert 1 <= nblk <= 264
            assert nbytes == (0 if pl.stash_smem else nblk * stash)
            assert nbytes <= cuda_lib.SCRATCH_BUDGET
    # 4^7 at D = 3 and 2^14 at every D pass shared memory; 6^5 never does
    assert n_global > 0
    with pytest.raises(ValueError, match="does not fit"):
        forward_kernel.plan("K4", 2 ** 14, SMEM + 4, 0, SMEM, occ,
                            stash="smem")
    fixed, _, _ = _wide_walk_bytes(6 ** 5, 6, 6, D, 20, 5, True)
    assert fixed <= SMEM
    assert _wide_walk_bytes(2 ** 14, 2, 2, D, 20, 14, True)[0] > SMEM


@pytest.mark.parametrize("D", [1, 2, 3])
def test_k4_past_16384_slots_plans_fit_every_register(D):
    # K4 at every register of (16384, 65536]: where the wide team fits a
    # block's shared memory it stays there (its stash in global scratch),
    # else WIDE_GLOBAL; a team's scratch grows with the bucket's length,
    # and the grid takes no more blocks than the budget holds
    def occ(warps, smem):
        return 1
    shared = set()
    for S, W in PAST_16384_REGISTERS:
        K = S ** W
        assert forward_kernel.mapping_warps("K4", K) == forward_kernel.WIDE
        for T in (W, W + 1, 20, 60):
            fixed, stash, threads = _wide_walk_bytes(K, S, S, D, T, W, True)
            pl = forward_kernel.plan("K4", K, fixed, stash, SMEM, occ)
            if fixed > SMEM:
                assert pl == forward_kernel.Plan(forward_kernel.WIDE_GLOBAL,
                                                 False)
                fixed, stash, threads = _wide_walk_bytes(K, S, S, D, T, W,
                                                         True, True)
            else:
                shared.add((S, W))
                assert pl.warps == forward_kernel.WIDE
            assert fixed <= SMEM and threads <= 1024
            nblk, nbytes = forward_kernel.grid(1 << 17, pl, 132, 1, stash)
            assert nbytes == (0 if pl.stash_smem else nblk * stash)
            assert nbytes <= cuda_lib.SCRATCH_BUDGET
            # a smaller budget (the card's free memory) takes fewer blocks
            if stash and not pl.stash_smem:
                nblk, nbytes = forward_kernel.grid(1 << 17, pl, 132, 1,
                                                   stash, 20 * stash + 1)
                assert nblk == min(20, 132) and nbytes == 20 * stash
    # many states keep few groups: 7^5 (2401) in shared memory; the
    # labeling and predict_Bs registers of 2, 3, 4 and 6 states do not
    assert (7, 5) in shared
    assert not shared & {(2, 16), (3, 10), (4, 8), (6, 6)}
    # the GUI's labeling window at 3 states: 3^10 slots, 19683 groups, a
    # thread 19 or 20 of them; the carries 1.0 MB and 236,196 bytes a
    # stash row
    fixed, stash, threads = _wide_walk_bytes(3 ** 10, 3, 3, 2, 40, 10, True,
                                             True)
    assert threads == 1024 and 4 * (2 * 5 * 3 ** 9 + 3 ** 10) == 1023516
    assert stash == 1023516 + 30 * 4 * 3 ** 10 == 8109396
    # one team's scratch past the budget raises, naming its bytes
    pl = forward_kernel.Plan(forward_kernel.WIDE_GLOBAL, False)
    with pytest.raises(RuntimeError, match=r"scratch \(8109396 bytes"):
        forward_kernel.grid(64, pl, 132, 1, stash, stash - 1)


@pytest.mark.parametrize("D", [1, 2, 3])
def test_wide_hist_and_refine_blocks_fit_every_register(D):
    # K5 at every sub-step count whose frames align and K6, at every
    # register of the envelope: the fixed part fits (less K5's 132 static
    # bytes), the rows / forms go to global scratch where they do not, and
    # the scratch stays within the budget
    for S, W in WIDE_REGISTERS:
        K = S ** W
        for n in (n for n in range(1, W) if (W - 1) % n == 0):
            for T in (2, 8, 20, 60):
                threads, fixed, carry = _wide_hist_bytes(K, S ** n, S, D, T)
                assert threads % 32 == 0 and threads <= 1024
                assert fixed <= SMEM - 132
                if fixed + carry > SMEM - 132:
                    nblk = cuda_lib.scratch_blocks(1 << 17, 132, threads,
                                                   carry)
                    assert nblk * carry <= cuda_lib.SCRATCH_BUDGET
                    assert nblk <= 132 * (2048 // threads)
        for T in (2, 5, 20, 60):
            threads, fixed, carry = _wide_refine_bytes(K, S, D, T)
            assert fixed <= SMEM
            nblk = cuda_lib.scratch_blocks(1 << 17, 132, threads,
                                           max(carry, 1))
            assert nblk * carry <= cuda_lib.SCRATCH_BUDGET
    # 3 states at len_hist's default window 7 (K = 2187): 729 groups, a
    # track's rows at T = 20 466,560 bytes, in global scratch
    threads, fixed, carry = _wide_hist_bytes(3 ** 7, 3, 3, D, 20)
    assert (threads, carry) == (736, 466560) and fixed + carry > SMEM
    # past 4096 slots: where the publish areas and member weights pass a
    # block's shared memory (less K5's static bytes) they go to global
    # scratch after the rows; the scratch stays within the budget
    for S, W in PAST_4096_REGISTERS:
        K = S ** W
        for n in (n for n in range(1, W) if (W - 1) % n == 0):
            for T in (2, 8, 20, 60):
                threads, fixed, carry = _wide_hist_bytes(K, S ** n, S, D, T)
                if fixed > SMEM - 132:
                    threads, fixed, carry = _wide_hist_bytes(
                        K, S ** n, S, D, T, pub_global=True)
                assert threads % 32 == 0 and threads <= 1024
                if fixed + carry > SMEM - 132:
                    nblk = cuda_lib.scratch_blocks(1 << 17, 132, threads,
                                                   carry)
                    assert nblk * carry <= cuda_lib.SCRATCH_BUDGET
    # len_hist's defaults past 4096 slots: 4 states at window 7 (K =
    # 16384, 4096 groups) passes shared memory at D = 3; 2 states at two
    # sub-steps (window 13 sub-steps, K = 8192, A = 4) never does
    pub = _wide_hist_bytes(4 ** 7, 4, 4, D, 20)[1]
    assert (pub > SMEM - 132) == (D == 3)
    assert _wide_hist_bytes(2 ** 13, 4, 2, D, 20)[1] <= SMEM - 132
