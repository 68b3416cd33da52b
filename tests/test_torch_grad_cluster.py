"""K2's cluster mapping (csrc/grad.cuh grad_cluster_kernel) on the CPU.

Past 2048 fusion groups the card walks a track with a cluster of C blocks:
rank r owns the Gc = ceil(G/C) groups from r*Gc, a thread one or two of
them; each rank keeps its members' carry cotangents (the exchange) in its
shared memory and the owner of group g reads its children g + a*G from the
ranks that own them.  The kernel runs only on the card, so this file holds
a float64 model of its algorithm, with the kernel's own decomposition:
groups dealt over ranks and threads, the exchange as C slices read by the
kernel's index arithmetic, every sum in the kernel's order (a group's
children in a order, its members' online log-sum-exp in member order, the
track's sums per rank and then in rank order, a cluster's partial row over
its tracks in track order, the rows in cluster order).

* the model's value and table gradients (through ``kernel_inputs``' VJP,
  as K2's autograd Function takes them) against
  ``grad_kernel.value_and_table_grads_plain`` in float64 at 1e-10, at 3^7
  and 4^6 with toy blocks of 32 threads and C = 2 and 4, constant and
  per-track dt, D = 1..3;
* the same against the JAX package's K2 (``pallas_grad`` in interpret
  mode, as tests/test_pallas_grad.py runs it) where its VMEM budget takes
  the register (3^6, 4^5), at the JAX suite's float32 tolerances (value
  rtol 2e-5, gradients 2e-3), and at 3^7 and 4^6 against the XLA engine
  the JAX package fits through there, in float64 at 1e-10;
* the host twin of the cluster layout (``grad_kernel.cluster_layout``,
  ``cluster_size``, ``plan``, ``grid``) at 5^6, 6^6, 4^8 and 3^9, D =
  1..3, K2's floats and K3's dual numbers: C, the shared bytes of a block
  within an H100's opt-in, the exchange in global scratch where a slice
  does not fit, and the live bytes of the clusters in flight.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from extrack_tpu.core import engine as jengine, tables as jtables
from extrack_tpu.ops import pallas_grad
from extrack_tpu_torch.core import tables as ttables
from extrack_tpu_torch.core.tables import ModelTables
from extrack_tpu_torch.ops import cuda_lib, forward_kernel, grad_kernel
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)

H100_OPTIN = 232448           # bytes of shared memory a block may opt in to
TINY = 1e-30                  # csrc/common.cuh kTiny
LOG_2PI = math.log(2 * math.pi)


def deal(G: int, C: int, nt: int):
    """The kernel's dealing: for each rank r, thread i and round j, the
    group r*Gc + i + j*nt it owns (-1 where none), as a (C, rounds, nt)
    array."""
    Gc = -(-G // C)
    rounds = -(-Gc // nt)
    own = np.full((C, rounds, nt), -1)
    for r in range(C):
        Gr = max(0, min(Gc, G - r * Gc))
        for j in range(rounds):
            lg = np.arange(nt) + j * nt
            own[r, j] = np.where(lg < Gr, r * Gc + lg, -1)
    return own


def cluster_walk(data, tabs, min_len: int, C: int, nt: int, ncl: int = 3):
    """A float64 model of grad_cluster_kernel: returns logL (B,),
    d(sum logL)/d l2 (B, T, D) and the table cotangents (ten, then the
    stream's with variable dt), every sum in the kernel's order (the block
    sums' tree inside a rank aside: a rank's sum here runs over its
    members in order)."""
    xs, l2s, lens, isbls = (np.asarray(t.detach(), np.float64)
                            for t in data)
    lens = lens.astype(int)
    tb = [np.asarray(t.detach(), np.float64) for t in tabs]
    lp0, s20, lt, lsurv, endv, sig2v, ltn, s2n, lsn, endn = tb[:10]
    P = tb[10].shape[-1] if len(tb) > 10 else 0
    B, T, D = xs.shape
    K, A = ltn.shape
    G, F = K // A, 2 * D + 1
    Gc = -(-G // C)
    M = Gc * A
    if P:
        S, KP, KS = P // A, K // P, K * A // P
    own = deal(G, C, nt)
    # every group owned once; the writer of member c's cotangent (the
    # owner of group c // A) is the rank the readers compute
    owner = np.full(G, -1)
    for r in range(C):
        g = own[r][own[r] >= 0]
        assert (owner[g] == -1).all()
        owner[g] = r
    assert (owner >= 0).all()
    members = np.arange(K)
    assert (owner[members // A] == members // A // Gc).all()
    slot_rank = members // A // Gc
    slot_local = members - slot_rank * M

    def rank_sums(v):
        """A track's sum over the slots (axis 0): per rank, then the
        ranks in order."""
        out = 0.0
        for r in range(C):
            out = out + v[slot_rank == r].sum(axis=0)
        return out

    partial = np.zeros((ncl, 6, K))
    partial_ka = np.zeros((ncl, 4, K, A))
    logl = np.zeros(B)
    ct_l2 = np.zeros((B, T, D))
    ct_s2 = np.zeros((B, max(T - 1, 0), P))
    for cid in range(ncl):
        part, pka = partial[cid], partial_ka[cid]
        for b in range(cid, B, ncl):
            L = min(lens[b], T)
            if L < 2:
                continue
            x, l2, isbl = xs[b], l2s[b], isbls[b]
            sg = tb[10][b] if P else None
            tlast = 1 if L == 2 else L - 2
            hist = np.zeros((max(T - 3, 0), F, G))

            def carry(t):
                if t == 1:
                    s0 = sg[0, members // KP] if P else s20
                    return (np.broadcast_to(x[0], (K, D)).copy(),
                            l2[0][None, :] + s0[:, None], lp0.copy())
                prev = hist[t - 2]
                gp = members % G
                gate_prev = 1.0 if t >= min_len else 0.0
                sv = sg[t - 1, members // KP] if P else sig2v
                return (prev[:D, gp].T.copy(), sv[:, None] + prev[D:2 * D,
                                                                  gp].T,
                        prev[2 * D, gp] + lt + gate_prev * lsurv)

            def prep(m, s2, xt, l2t):
                tot = l2t[None, :] + s2
                inv = 1.0 / tot
                diff = xt[None, :] - m
                return dict(inv=inv, diff=diff, prod=tot.prod(axis=1),
                            quad=(0.5 * diff * diff * inv).sum(axis=1),
                            nm=(m * l2t + xt * s2) * inv, tl=l2t * s2 * inv)

            def group_online(p, lp):
                """Each group's online sums over its members in order."""
                mx = np.full(G, -np.inf)
                sw = np.zeros(G)
                mf = np.zeros((G, D))
                tf = np.zeros((G, D))
                for i in range(A):
                    c = np.arange(G) * A + i
                    base = lp[c] - p["quad"][c]
                    new = base > mx
                    nmx = np.where(new, base, mx)
                    sc = np.where(new, np.exp(mx - nmx), 1.0)
                    sw, mf, tf, mx = sw * sc, mf * sc[:, None], \
                        tf * sc[:, None], nmx
                    w = np.exp(base - mx) / np.sqrt(p["prod"][c])
                    sw = sw + w
                    mf = mf + w[:, None] * p["nm"][c]
                    tf = tf + w[:, None] * p["tl"][c]
                return mx, sw, mf, tf

            def look_terms(p, lp, t, xn, l2n):
                """The closing's (K, A) log terms and factors on the
                look-ahead children."""
                gate = 1.0 if t + 1 >= min_len else 0.0
                base_n = (lp - p["quad"] - 0.5 * np.log(p["prod"])
                          - 0.5 * D * LOG_2PI)
                s2na = (np.stack([sg[t, a * S + members // KS]
                                  for a in range(A)], 1) if P else s2n)
                totn = s2na[:, :, None] + p["tl"][:, None, :] + l2n
                invn = 1.0 / totn
                diffn = xn - p["nm"][:, None, :]
                r = 1.0 / np.sqrt((2 * math.pi * totn).prod(axis=2))
                gl = (base_n[:, None] + ltn + gate * lsn + isbl * endn
                      - (0.5 * diffn * diffn * invn).sum(axis=2))
                return gl, r, invn, diffn, gate

            # forward walk
            for t in range(1, tlast + 1):
                xt, l2t = x[t], l2[t]
                m, s2, lp = carry(t)
                p = prep(m, s2, xt, l2t)
                if t == tlast:
                    if L == 2:
                        fin = (lp + isbl * endv - 0.5 * np.log(p["prod"])
                               - p["quad"] - 0.5 * D * LOG_2PI)
                        cmx = fin.max()
                        csum = rank_sums(np.exp(fin - cmx))
                    else:
                        gl, r, _, _, _ = look_terms(p, lp, t, x[t + 1],
                                                    l2[t + 1])
                        cmx = gl.max()
                        csum = rank_sums((np.exp(gl - cmx) * r).sum(axis=1))
                    logl[b] = cmx + math.log(csum)
                else:
                    mx, sw, mf, tf = group_online(p, lp)
                    sw_ = np.maximum(sw, TINY)
                    hist[t - 1, :D] = (mf / sw_[:, None]).T
                    hist[t - 1, D:2 * D] = (tf / sw_[:, None]).T
                    hist[t - 1, 2 * D] = mx + np.log(sw_)

            # backward walk: the exchange as C slices of (2D+1, M)
            xch = np.zeros((C, F, M))
            p_s2n = np.zeros((K, A))

            def publish(t, xch):
                if not P:
                    return
                if t == tlast and L > 2:
                    for q in range(P):
                        a, s0 = q // S, (q % S) * KS
                        ct_s2[b, t, q] = p_s2n[s0:s0 + KS, a].sum()
                for q in range(P):
                    kk = np.arange(q * KP, (q + 1) * KP)
                    r = kk // A // Gc
                    v = xch[r, 1 + D:, kk - r * M]       # (KP, D)
                    ct_s2[b, t - 1, q] = v.sum()

            for t in range(tlast, 0, -1):
                xt, l2t = x[t], l2[t]
                gate_prev = 1.0 if t >= min_len else 0.0
                fuse = t < tlast
                look = t == tlast and L > 2
                if fuse:
                    gc = np.zeros((G, F))
                    for a in range(A):
                        c = np.arange(G) + a * G
                        r = c // A // Gc
                        gc += xch[r, :, c - r * M]
                    publish(t + 1, xch)
                m, s2, lp = carry(t)
                p = prep(m, s2, xt, l2t)
                cnm = np.zeros((K, D))
                ctl = np.zeros((K, D))
                if L == 2:
                    fin = (lp + isbl * endv - 0.5 * np.log(p["prod"])
                           - p["quad"] - 0.5 * D * LOG_2PI)
                    cb = np.exp(fin - cmx) / csum
                    part[4] += isbl * cb
                elif look:
                    gl, r, invn, diffn, gate = look_terms(p, lp, t, x[t + 1],
                                                          l2[t + 1])
                    q = np.exp(gl - cmx) * r * (1.0 / csum)
                    pka[0] += q
                    pka[2] += gate * q
                    pka[3] += isbl * q
                    dn = diffn * invn
                    ct_totn = 0.5 * q[:, :, None] * (diffn * dn - 1.0) * invn
                    cnm = (q[:, :, None] * dn).sum(axis=1)
                    ctl = ct_totn.sum(axis=1)
                    cs = ct_totn.sum(axis=2)
                    if P:
                        p_s2n[:] = cs
                    else:
                        pka[1] += cs
                    cb = q.sum(axis=1)
                    ct_l2[b, t + 1] = rank_sums(ct_totn.sum(axis=1))
                else:
                    mx, sw, mf, tf = group_online(p, lp)
                    inv_sw = 1.0 / np.maximum(sw, TINY)
                    ok = (sw >= TINY).astype(float)
                    fac = ok * (gc[:, 0] - ((gc[:, 1:1 + D] * mf
                                             + gc[:, 1 + D:] * tf).sum(1))
                                * inv_sw)
                    g = members // A
                    wn = (np.exp(lp - p["quad"] - mx[g]) / np.sqrt(p["prod"])
                          * inv_sw[g])
                    own = (gc[g, 1:1 + D] * p["nm"]
                           + gc[g, 1 + D:] * p["tl"]).sum(axis=1)
                    cb = (fac[g] + own) * wn
                    cnm = gc[g, 1:1 + D] * wn[:, None]
                    ctl = gc[g, 1 + D:] * wn[:, None]
                # prep_bwd
                inv, diff = p["inv"], p["diff"]
                e = diff * inv
                cn, cl = cnm * inv, ctl * inv
                ct_tot = (0.5 * cb[:, None] * (diff * e - 1.0) * inv
                          - cn * p["nm"] - cl * p["tl"])
                dm = cb[:, None] * e + cn * l2t
                ds2 = ct_tot + cn * xt + cl * l2t
                dl2 = ct_tot + cn * m + cl * s2
                xch = np.zeros((C, F, M))
                xch[slot_rank, 0, slot_local] = cb
                xch[slot_rank, 1:1 + D, slot_local] = dm
                xch[slot_rank, 1 + D:, slot_local] = ds2
                cs = ds2.sum(axis=1)
                if t == 1:
                    part[0] += cb
                    if not P:
                        part[1] += cs
                    ct_l2[b, 0] = rank_sums(ds2)
                else:
                    part[2] += cb
                    part[3] += gate_prev * cb
                    if not P:
                        part[5] += cs
                ct_l2[b, t] = rank_sums(dl2)
            publish(1, xch)
    ct = partial[0].copy()
    ct_ka = partial_ka[0].copy()
    for cid in range(1, ncl):
        ct += partial[cid]
        ct_ka += partial_ka[cid]
    cts = list(ct) + list(ct_ka)
    if P:
        cts.append(ct_s2)
    return logl, ct_l2, cts


class _ModelNLL(torch.autograd.Function):
    """-sum logL with the model's cotangents as its gradient (K2's
    NegLogLikelihood with the model in place of the kernel)."""

    @staticmethod
    def forward(ctx, xs, lens, isbl, min_len, C, nt, l2, *tabs):
        logl, ct_l2, cts = cluster_walk((xs, l2, lens, isbl), tabs, min_len,
                                        C, nt)
        ctx.save_for_backward(torch.tensor(ct_l2),
                              *(torch.tensor(np.asarray(c)) for c in cts))
        return torch.tensor(-logl.sum())

    @staticmethod
    def backward(ctx, g):
        ct_l2, *cts = ctx.saved_tensors
        return ((None,) * 6 + (-g * ct_l2,)
                + tuple(-g * c for c in cts))


def model_nll(C, nt):
    def fn(positions, lengths, is_bleached, tables, *, window, nb_substeps=1,
           min_len=3):
        (xs, l2, lens, isbl), tabs = forward_kernel.kernel_inputs(
            positions, lengths, is_bleached, tables, window, nb_substeps,
            dtype=torch.float64)
        return _ModelNLL.apply(xs, lens, isbl, min_len, C, nt, l2, *tabs)
    return fn


def _case(S, B, T, D, seed, dt=None):
    """Random walks (float64) and the tables of a model with S states, its
    Ds spread so that every state matters; ``dt`` "track": per-track
    intervals (the stream)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, T + 1, B)
    lengths[:3] = (T, 2, 3)
    xs = rng.normal(0, 0.05, (B, T, D)).cumsum(1)
    isbl = (rng.random(B) < 0.4).astype(np.float64)
    f64 = dict(dtype=torch.float64)
    rates = torch.full((S, S), 0.08, **f64)
    rates.fill_diagonal_(0.0)
    dt_arg = 0.02
    if dt == "track":
        dt_arg = torch.tensor(rng.uniform(0.01, 0.03, (B, 1)) *
                              np.ones((1, T - 1)), **f64)
    tb = ttables.build_tables(
        torch.linspace(0.0, 0.09, S, **f64), torch.tensor(0.02, **f64),
        torch.full((S,), 1.0 / S, **f64), rates, torch.tensor(0.1, **f64),
        dt_arg, cell_dims=(0.6,))
    return (torch.tensor(xs), torch.tensor(lengths), torch.tensor(isbl),
            tb)


def _model_and_plain(S, W, D, C, nt, seed, dt=None, B=9, T=7):
    pos, lens, isbl, tb = _case(S, B, T, D, seed, dt)
    kw = dict(window=W, nb_substeps=1, min_len=2)
    v, g = grad_kernel._table_grads(model_nll(C, nt), pos, lens, isbl, tb,
                                    **kw)
    v0, g0 = grad_kernel.value_and_table_grads_plain(pos, lens, isbl, tb,
                                                     **kw)
    return (v, g), (v0, g0)


@pytest.mark.parametrize("S,W", [(3, 7), (4, 6)])
@pytest.mark.parametrize("C", [2, 4])
@pytest.mark.parametrize("D,dt", [(1, None), (2, None), (3, None),
                                  (2, "track")])
def test_cluster_model_matches_plain_float64(S, W, C, D, dt):
    (v, g), (v0, g0) = _model_and_plain(S, W, D, C, 32, 10 * S + W + C + D,
                                        dt)
    np.testing.assert_allclose(float(v), float(v0), rtol=1e-10)
    for name in ModelTables._fields:
        if g0[name].numel() == 0:
            continue
        scale = float(g0[name].abs().max())
        np.testing.assert_allclose(g[name].numpy(), g0[name].numpy(),
                                   rtol=1e-10, atol=1e-10 * scale,
                                   err_msg=name)


def test_cluster_deal_owns_every_group_once_within_two_rounds():
    # at the card's blocks (1024 threads): a thread one or two groups at
    # the plans' cluster sizes; the last rank may own fewer groups (or
    # none) when C does not divide G
    for S, W in ((5, 6), (6, 6), (4, 8), (3, 9)):
        G = S ** W // S
        C, _ = grad_kernel.cluster_size(S ** W, S, 2, 10, H100_OPTIN)
        assert C > 1
        own = deal(G, C, 1024)
        assert own.shape[1] <= grad_kernel.WIDE_GROUPS
        got = np.sort(own[own >= 0])
        assert (got == np.arange(G)).all()
    own = deal(9, 4, 2)       # Gc = 3: the last rank holds no group
    assert (own[3] == -1).all() and sorted(own[own >= 0]) == list(range(9))


@pytest.fixture
def interpret_mode():
    pallas_grad.INTERPRET = True
    try:
        yield
    finally:
        pallas_grad.INTERPRET = False


def _jax_value_and_grads(pos, lens, isbl, tb, dtype, fn, **kw):
    """The JAX package's -sum logL and its gradients w.r.t. every table
    field, through ``fn`` (pallas_grad.neg_log_likelihood, or the XLA
    engine's -sum forward)."""
    fields = [jnp.asarray(f.numpy(), dtype) for f in tb]

    def nll(*fs):
        return fn(jnp.asarray(pos.numpy(), dtype), jnp.asarray(lens.numpy()),
                  jnp.asarray(isbl.numpy(), dtype),
                  jtables.ModelTables(*fs), **kw)

    return jax.value_and_grad(nll, argnums=tuple(range(len(fields))))(
        *fields)


@pytest.mark.parametrize("S,W,T,C", [(3, 6, 6, 2), (4, 5, 4, 4)])
def test_cluster_model_matches_pallas_grad(S, W, T, C, interpret_mode):
    # the JAX package's K2 (pallas_grad in interpret mode, float32) where
    # its VMEM budget takes the register (3^6, 4^5 at T <= 4), with 243
    # and 256 groups over two and four ranks of 32 threads: the JAX
    # suite's tolerances
    pos, lens, isbl, tb = _case(S, 5, T, 2, 100 + S * W)
    kw = dict(window=W, nb_substeps=1, min_len=2)
    v, g = grad_kernel._table_grads(model_nll(C, 32), pos, lens, isbl, tb,
                                    **kw)
    v_ref, g_ref = _jax_value_and_grads(pos, lens, isbl, tb, jnp.float32,
                                        pallas_grad.neg_log_likelihood, **kw)
    np.testing.assert_allclose(float(v), float(v_ref), rtol=2e-5)
    for name, gr in zip(ModelTables._fields, g_ref):
        np.testing.assert_allclose(g[name].numpy(), np.asarray(gr),
                                   rtol=2e-3, atol=2e-3, err_msg=name)


@pytest.mark.parametrize("S,W,C", [(3, 7, 2), (4, 6, 4)])
def test_cluster_model_matches_jax_xla_float64(S, W, C):
    # past pallas_grad's VMEM budget the JAX package fits through its XLA
    # engine (extrack_tpu/fit.py:104-119): its -sum forward and autodiff
    # in float64, at 1e-10
    pos, lens, isbl, tb = _case(S, 6, 6, 2, 200 + S * W)
    kw = dict(window=W, nb_substeps=1, min_len=2)
    v, g = grad_kernel._table_grads(model_nll(C, 32), pos, lens, isbl, tb,
                                    **kw)

    def xla(*args, **kw):
        return -jengine.forward(*args, **kw).sum()

    v_ref, g_ref = _jax_value_and_grads(pos, lens, isbl, tb, jnp.float64,
                                        xla, **kw)
    np.testing.assert_allclose(float(v), float(v_ref), rtol=1e-10)
    for name, gr in zip(ModelTables._fields, g_ref):
        gr = np.asarray(gr)
        np.testing.assert_allclose(g[name].numpy(), gr, rtol=1e-10,
                                   atol=1e-10 * float(np.abs(gr).max()),
                                   err_msg=name)


# ---- the host twin of the cluster layout ---------------------------------

PAST_2048 = [(5, 6), (6, 6), (4, 8), (3, 9)]


@pytest.mark.parametrize("S,W", PAST_2048)
@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_cluster_layout_and_plan_past_2048_groups(S, W, D, itemsize):
    K, A, T = S ** W, S, 20
    G = K // A
    C, glob = grad_kernel.cluster_size(K, A, D, T, H100_OPTIN, itemsize)
    assert C in grad_kernel.CLUSTER_SIZES and C > 1 and not glob
    Gc = -(-G // C)
    # by hand: a thread one or two groups (at most 1024 a block), the
    # block's slice of the exchange, (2D+1) scalars of each of its Gc*A
    # members, beside the reductions' 64 scalars in shared memory; the
    # history in the cluster's global scratch
    lay = grad_kernel.wide_layout(K, A, D, T, C, False, itemsize)
    xch = (2 * D + 1) * Gc * A
    assert lay == (min(1024, -(-Gc // 32) * 32), (64 + xch) * itemsize,
                   (T - 3) * (2 * D + 1) * G * itemsize)
    assert Gc <= 2 * lay.threads and lay.smem <= H100_OPTIN
    # the smallest such C: half of it either leaves a thread more than two
    # groups or a slice past the opt-in
    half = grad_kernel.wide_layout(K, A, D, T, C // 2, False, itemsize)
    assert -(-G // (C // 2)) > 2 * 1024 or half.smem > H100_OPTIN
    pl = grad_kernel.plan(K, A, D, T, H100_OPTIN, None, itemsize)
    assert pl == grad_kernel.Plan(grad_kernel.WIDE, False, C)
    # the exchange in global scratch where no cluster size's slice fits
    # (here: a limit of the reductions' scratch alone), at the smallest C
    # that keeps a thread within two groups: C slices after the history
    Cg = min(c for c in grad_kernel.CLUSTER_SIZES if -(-G // c) <= 2048)
    pg = grad_kernel.plan(K, A, D, T, 64 * itemsize, None, itemsize)
    assert pg == grad_kernel.Plan(grad_kernel.WIDE_GLOBAL, False, Cg)
    assert grad_kernel.plan(K, A, D, T, H100_OPTIN, None, itemsize,
                            stash="global") == (
        grad_kernel.Plan(grad_kernel.WIDE_GLOBAL, False, C))
    glay = grad_kernel.wide_layout(K, A, D, T, Cg, True, itemsize)
    slice_g = (2 * D + 1) * -(-G // Cg) * A * itemsize
    assert glay.smem == 64 * itemsize
    assert glay.scratch == (T - 3) * (2 * D + 1) * G * itemsize + (
        Cg * slice_g)
    with pytest.raises(ValueError, match="does not fit"):
        grad_kernel.plan(K, A, D, T, 64 * itemsize, None, itemsize,
                         stash="smem")
    # the grid: a cluster of C blocks a track, as many clusters as the
    # card keeps resident (at most 132 // C of one block an SM), one
    # history and one row of partials each; the exchange's live bytes in
    # global scratch are the clusters' slices
    resident = 132 // Cg
    nblk, floats = grad_kernel.grid(1 << 12, T, D, K, pg, 132, resident,
                                    itemsize, A, 16 << 30)
    assert nblk == resident * Cg
    assert floats * 4 == resident * glay.scratch
    live = resident * Cg * slice_g
    print(f"{S}^{W} D={D} itemsize={itemsize}: C={C} slice "
          f"{lay.smem - 64 * itemsize} B; global at C={Cg}: {resident} "
          f"clusters, exchange {live} B live")


def test_cluster_plan_past_1024_slots_and_forced():
    occ = None
    # one block (C = 1) where a thread owns at most two groups and the
    # exchange fits: 4^6, 6^5 (1296 groups), 2^12 (2048)
    for K, A in ((4 ** 6, 4), (6 ** 5, 6), (2 ** 12, 2)):
        assert grad_kernel.plan(K, A, 2, 10, H100_OPTIN, occ) == (
            grad_kernel.Plan(grad_kernel.WIDE, False, 1))
    assert grad_kernel.plan(5 ** 6, 5, 2, 10, H100_OPTIN, occ) == (
        grad_kernel.Plan(grad_kernel.WIDE, False, 2))
    # forced sizes, and sizes that do not take the groups
    assert grad_kernel.plan(4 ** 6, 4, 2, 10, H100_OPTIN, occ,
                            cluster=2) == (
        grad_kernel.Plan(grad_kernel.WIDE, False, 2))
    assert grad_kernel.plan(6 ** 6, 6, 2, 10, H100_OPTIN, occ,
                            cluster=16).cluster == 16
    for bad in (2, 3, 32):
        with pytest.raises(ValueError, match="do not take"):
            grad_kernel.plan(6 ** 6, 6, 2, 10, H100_OPTIN, occ, cluster=bad)
    with pytest.raises(ValueError, match="K <= 65536 and at most 16384"):
        grad_kernel.plan(5 ** 7, 5, 2, 10, H100_OPTIN, occ)


def test_cluster_grid_budget_counts_a_cluster():
    # one history and one partial row a cluster (not a block): a budget of
    # three clusters' buffers runs three clusters of C blocks
    K, A, D, T, it = 6 ** 6, 6, 2, 20, 8
    pl = grad_kernel.plan(K, A, D, T, H100_OPTIN, None, it)
    lay = grad_kernel.wide_layout(K, A, D, T, pl.cluster, False, it)
    per = lay.scratch + grad_kernel.partial_bytes(K, A, it)
    nblk, floats = grad_kernel.grid(1 << 12, T, D, K, pl, 132, 16, it, A,
                                    3 * per)
    assert (nblk, floats * 4) == (3 * pl.cluster, 3 * lay.scratch)
    with pytest.raises(RuntimeError, match="passes the"):
        grad_kernel.grid(1 << 12, T, D, K, pl, 132, 16, it, A, per - 1)
    # no more clusters than tracks
    assert grad_kernel.grid(5, T, D, K, pl, 132, 16, it, A,
                            16 << 30)[0] == 5 * pl.cluster
    assert cuda_lib.WIDE_SCRATCH_K < K
