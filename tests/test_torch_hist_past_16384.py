"""K5 past 16384 register slots (up to 2^19), where the port's card runs
``hist_runs_kernel`` (csrc/hist_wide.cu): the wide walk with its rows,
publish areas and member weights in global scratch, and a harvest that
takes each slot's runs from its digits in place of the static segment
tables.  The JAX package runs its XLA window engine there.

* the digit-derived runs (``histograms.slot_runs``, and the tables
  ``segment_tables`` builds from them, on the host and for the card)
  against the JAX package's slot-by-slot ``_segment_tables``, exactly, at
  every (S, W, n) with S^W <= 4096, S <= 6, n <= 2 and three T;
* the kernel's harvest (``harvest_runs``: a pass over the fusion groups,
  the window's runs into (state, length) bins, then a warp a bin over
  the carried rows) as a float64 model against the harvest from the
  dense tables, at every step of a track, to 1e-12;
* ``len_hist`` at 5 states and its default window 7 (K = 78,125) on the
  CPU in float64 against the JAX package's, with constant and per-track
  dt, at 1e-10;
* the GUI's State Lifetime Histogram options at 4 states (window 8, K =
  65,536) equal to the JAX package's, inside K5's envelope;
* the launch plan at every (S, W, n, D) with 16384 < S^W <= 2^19 (S <=
  8, n <= 2): 1024 threads at most, static shared memory within the
  opt-in, the block's scratch within the budget or a raise naming its
  bytes; and no segment table built past 16384 slots.
"""
import functools

import numpy as np
import pytest
import torch

from extrack_tpu import gui as jgui, histograms as jhist
from extrack_tpu.core import engine as jengine
from extrack_tpu_torch import gui as tgui, histograms as thist
from extrack_tpu_torch.ops import cuda_lib, forward_kernel, hist_kernel
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)

SMEM = 232448             # shared bytes a block may opt in to on an H100
STATIC = 4 * (33 + 32 * 64)   # hist_runs_kernel's red[] and warp bins

# every (S, W, n) of the host tables' range, three track lengths each
TABLE_CASES = [(S, W, n, T) for S in range(2, 7) for W in range(2, 13)
               if S ** W <= 4096 for n in (1, 2)
               if W >= n + 1 and (W - 1) % n == 0 for T in (2, 5, 9)]


@pytest.mark.parametrize("S,W,n,T", TABLE_CASES)
def test_slot_runs_equal_the_segment_tables(S, W, n, T):
    """The runs read from each slot's digits give the JAX package's
    segment tables and oldest-run lengths exactly, as K5 reads them (slot
    axis last, float32; built on the host and for the card alike)."""
    Wf = hist_kernel.window_frames(W, n)
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
    state, length = thist.slot_runs(S, W, n)
    np.testing.assert_array_equal(length[:, 0].numpy(), ext0)
    assert bool((length.sum(1) == Wf).all())
    np.testing.assert_array_equal(
        thist.slot_frames(S, W, n).numpy(), spec.codes[:, ::-1][:, ::n])


def _runs_harvest(pbar, run, hist, S, W, n, T, t):
    """csrc/hist_wide.cu ``harvest_runs`` in float64, statement by
    statement: the (S*T,) row of a track whose last step is t, from the
    register's softmax ``pbar`` (K,), its groups' carried run rows ``run``
    (T, G) and histogram rows ``hist`` (S*T, G)."""
    K, A = S ** W, S ** n
    G, AS, Wf = K // A, A // S, hist_kernel.window_frames(W, n)
    held, nw = t + 1 > Wf, min(t, T)
    lo, first = (0, 1) if held else (Wf - (t + 1), 0)
    sb = np.zeros(S * Wf)
    gu, gw0, gw1 = np.zeros(G), np.zeros(G), np.zeros(G)
    ge = np.zeros(G, np.int64)
    for g in range(G):
        U = sum(pbar[a * G + g] for a in range(A))
        q, cs, cl, r, e = g, -1, 0, -1, 0
        for j in range(Wf - 1):
            if j >= lo:
                f = q % S
                if f == cs:
                    cl += 1
                else:
                    if r >= first:
                        sb[cs * Wf + cl - 1] += U
                    if r == 0:
                        e = cl
                    cs, cl, r = f, 1, r + 1
            q //= A
        same = other = 0.0
        for f in range(S):
            uf = sum(pbar[a * G + g] for a in range(f * AS, (f + 1) * AS))
            if f == cs:
                same = uf
            else:
                other += uf
                sb[f * Wf] += uf
        if r >= first:
            sb[cs * Wf + cl] += same
            sb[cs * Wf + cl - 1] += other
        gu[g] = U
        if held:
            ge[g], gw0[g], gw1[g] = ((cl, other, same) if r == 0
                                     else (e, U, 0.0))
    row = np.zeros(S * T)
    for j in range(S * T):
        s, mb = divmod(j, T)
        v = (gu * hist[j]).sum() if mb < nw else 0.0
        if held:
            for g in range(s, G, S):
                src = mb - ge[g] + 1
                if 0 <= src < nw:
                    v += gw0[g] * run[src, g]
                if 1 <= src <= nw:
                    v += gw1[g] * run[src - 1, g]
        row[j] = v + (sb[s * Wf + mb] if mb < Wf else 0.0)
    return row


def _dense_harvest(pbar, run, hist, S, W, n, T, t):
    """The harvest of the kernels up to 16384 slots, from the static
    segment tables: per bin a sum over the slots of the softmax times the
    window's segments, the carried histogram and the carried run shifted
    by the oldest run's length."""
    K, A = S ** W, S ** n
    G, Wf = K // A, hist_kernel.window_frames(W, n)
    seg, ext = hist_kernel.segment_tables(S, W, T, n)
    held, nw = t + 1 > Wf, min(t, T)
    c = np.arange(K)
    row = seg[Wf + 1 if held else t + 1].astype(np.float64) @ pbar
    for j in range(S * T):
        s, mb = divmod(j, T)
        if mb < nw:
            row[j] += (pbar * hist[j][c % G]).sum()
        if held:
            src = mb - ext + 1
            ok = (c % S == s) & (src >= 0) & (src < nw)
            row[j] += (pbar * np.where(ok, run[np.clip(src, 0, T - 1),
                                           c % G], 0.0)).sum()
    return row


@pytest.mark.parametrize("S,W,n,T", [
    (2, 5, 1, 9), (3, 4, 1, 8), (4, 3, 1, 6), (2, 7, 2, 9), (3, 5, 2, 8),
    (2, 7, 3, 8),
    (2, 3, 2, 6),     # Wf = 2: A = 4 children, G = 2 groups
])
def test_runs_harvest_matches_the_dense_tables(S, W, n, T):
    """The harvest from the slots' digits (held windows, windows still
    filling, the oldest run reaching the newest frame) equals the harvest
    from the static tables at every last step t of a track."""
    rng = np.random.default_rng(S * 100 + W * 10 + n)
    K, G = S ** W, S ** W // S ** n
    for t in range(1, T):
        z = rng.normal(0.0, 2.0, K)
        pbar = np.exp(z - z.max())
        pbar /= pbar.sum()
        run = rng.uniform(0.0, 1.0, (T, G))
        hist = rng.uniform(0.0, 1.0, (S * T, G))
        np.testing.assert_allclose(
            _runs_harvest(pbar, run, hist, S, W, n, T, t),
            _dense_harvest(pbar, run, hist, S, W, n, T, t),
            rtol=1e-12, atol=1e-14)


_jax_segment_tables = jhist._segment_tables


@functools.lru_cache(maxsize=4)
def _jax_tables_once(key, W, T, S, stride):
    return _jax_segment_tables(np.frombuffer(key[0], key[1]).reshape(key[2]),
                               W, T, S, stride=stride)


@pytest.fixture
def one_jax_table_build(monkeypatch):
    """The JAX package's slot-by-slot ``_segment_tables`` (5 s at 5^7) is
    built once for the module's calls: the same arguments give the same
    tables."""
    def build(codes, W, T, S, stride=1):
        c = np.ascontiguousarray(codes)
        return _jax_tables_once((c.tobytes(), c.dtype.str, c.shape), W, T, S,
                                stride)
    monkeypatch.setattr(jhist, "_segment_tables", build)


@pytest.mark.parametrize("dt", ["constant", "per_track"])
def test_len_hist_at_5_states_default_window_matches_jax(
        one_jax_table_build, dt):
    """len_hist(nb_states=5) at its default window 7 (K = 78,125 slots:
    on the card K5's harvest from the slots' digits) on the CPU in
    float64 against JAX's len_hist on the same short tracks, with one dt
    and with a per-track dt dict; frames conserved."""
    S = 5
    rng = np.random.default_rng(21)
    tracks = {"4": rng.normal(0.0, 0.05, (3, 4, 2)).cumsum(1)}
    Ds = np.linspace(0.0, 0.1, S)
    values = {"LocErr": 0.02, "pBL": 0.1,
              **{f"D{i}": d for i, d in enumerate(Ds)},
              **{f"F{i}": 1 / S for i in range(S)},
              **{f"p{i}{j}": 0.05 for i in range(S) for j in range(S)
                 if i != j}}
    dts = (0.02 if dt == "constant" else
           {k: rng.uniform(0.01, 0.05, (v.shape[0], v.shape[1] - 1))
            for k, v in tracks.items()})
    kw = dict(cell_dims=(0.5,), nb_states=S)
    before = hist_kernel.PLAIN_CALLS
    got = thist.len_hist(tracks, values, dts, device="cpu", **kw)
    assert hist_kernel.PLAIN_CALLS > before
    want = np.asarray(jhist.len_hist(tracks, values, dts, **kw))
    assert got.shape == want.shape == (4, S)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    frames = (got * np.arange(1, 5)[:, None]).sum()
    np.testing.assert_allclose(frames, 3 * 4, rtol=1e-10)
    forward_kernel.check_envelope(4, 2, S, 7, 1, variable_dt=dt != "constant",
                                  what="len_hist", kernel="K5")


def test_gui_lifetime_options_at_4_states_are_jax_and_in_envelope():
    """The State Lifetime Histogram window seeds frame_len 8: 4^8 = 65,536
    slots at 4 states and 5^8 = 390,625 at 5, inside K5's 2^19; at 6
    states (6^8) the card raises, naming K5's limit and the largest
    window that fits."""
    for S, K in ((4, 65536), (5, 390625)):
        ts, js = tgui.Session(nb_states=S), jgui.Session(nb_states=S)
        got = tgui.seeded_options("State Lifetime Histogram", ts)
        assert got == jgui.seeded_options("State Lifetime Histogram", js)
        W = int(got["frame_len"])
        assert S ** W == K
        forward_kernel.check_envelope(int(ts.max_len), 2, S, W, 1,
                                      what="the GUI's lifetime histogram",
                                      kernel="K5")
    with pytest.raises(NotImplementedError,
                       match="the GUI's lifetime histogram.*K5 maps at most "
                             "524288.*digits past 16384.*window that fits "
                             "is 7"):
        forward_kernel.check_envelope(int(ts.max_len), 2, 6, W, 1,
                                      what="the GUI's lifetime histogram",
                                      kernel="K5")


# every register past 16384 slots up to 2^19 at S <= 8
PAST_16384_REGISTERS = [(S, W) for S in range(2, 9) for W in range(2, 20)
                        if 16384 < S ** W <= 1 << 19]


def _runs_block(K, A, S, D, T):
    """hist_runs_kernel's block (csrc/hist.cuh hist_layout at wide = 3):
    threads, dynamic shared bytes, and its global scratch: both row
    buffers, two publish areas of (2D+1)*G floats and K member weights
    (the card test test_hist_layout reads the kernel's own)."""
    G = K // A
    return (min(1024, -(-G // 32) * 32), 0,
            4 * (2 * G * (1 + S) * T + 2 * (2 * D + 1) * G + K))


@pytest.mark.parametrize("D", [1, 2, 3])
def test_k5_past_16384_slots_plans_fit_every_register(D):
    """At every register of (16384, 2^19] and sub-step count n <= 2 whose
    frames align, K5 takes its digits' harvest: at most 1024 threads, no
    dynamic shared memory and its static bytes within the opt-in, the
    (state, length) bins within the kernel's; the grid's scratch within
    the budget, or a raise naming the batch and its bytes."""
    budget = cuda_lib.WIDE_SCRATCH_BUDGET
    assert budget > cuda_lib.SCRATCH_BUDGET == 1 << 30
    assert STATIC <= SMEM
    for S, W in PAST_16384_REGISTERS:
        K = S ** W
        assert forward_kernel.mapping_warps("K5", K) == forward_kernel.WIDE
        for n in (n for n in (1, 2) if W >= n + 1 and (W - 1) % n == 0):
            Wf = hist_kernel.window_frames(W, n)
            forward_kernel.check_envelope(20, D, S, W, n, kernel="K5")
            assert S * Wf <= forward_kernel.HIST_MAX_BINS
            for T in (2, 8, 20, 60):
                threads, smem, blk = _runs_block(K, S ** n, S, D, T)
                assert threads % 32 == 0 and threads <= 1024 and smem == 0
                if blk > budget:
                    with pytest.raises(RuntimeError,
                                       match=rf"global scratch \({blk} bytes"):
                        hist_kernel.runs_grid(64, T, K, blk, 132, threads,
                                              budget)
                    continue
                nblk, floats = hist_kernel.runs_grid(1 << 12, T, K, blk,
                                                     132, threads, budget)
                assert 4 * floats == nblk * blk <= budget
                assert nblk <= min(1 << 12, 132 * (1024 // threads))
    # the configurations that must run on the card at T = 20: a block an
    # SM (1024 threads), 5^8's 132 blocks of 79.7 MB under the budget
    for S, W, n in ((5, 7, 1), (6, 7, 1), (4, 8, 1), (5, 8, 1), (2, 15, 2)):
        threads, _, blk = _runs_block(S ** W, S ** n, S, 2, 20)
        nblk, _ = hist_kernel.runs_grid(1 << 12, 20, S ** W, blk, 132,
                                        threads, budget)
        assert nblk == 132 <= budget // blk
    # 6 states at window 7: 46,656 groups, 52.3 MB of rows a block
    assert _runs_block(6 ** 7, 6, 6, 2, 20)[2] == 55_240_704
    # past 2^19 (3^12, 2^20) K5 raises, naming its limit and the window
    for S, fits in ((3, 11), (2, 19)):
        with pytest.raises(NotImplementedError,
                           match=rf"K5 maps at most 524288.*window that "
                                 rf"fits is {fits}"):
            forward_kernel.check_envelope(20, 2, S, fits + 1, 1,
                                          kernel="K5")


def test_no_segment_table_is_built_past_16384_slots(monkeypatch):
    """Up to 16384 slots K5's harvest reads the static tables, built once
    per shape; past them it reads none and none is built."""
    calls = []
    orig = thist.segment_tables

    def counted(*a, **kw):
        calls.append(a[:4])
        return orig(*a, **kw)
    monkeypatch.setattr(thist, "segment_tables", counted)
    hist_kernel.device_segment_tables.cache_clear()
    cpu = torch.device("cpu")
    for S, W, n in ((5, 7, 1), (6, 7, 1), (4, 8, 1), (2, 15, 2),
                    (5, 8, 1)):
        assert hist_kernel.harvest_tables(S, W, 20, n, cpu) == (None, None)
    assert calls == []
    seg, ext = hist_kernel.harvest_tables(4, 7, 6, 1, cpu)
    assert calls == [(4, 7, 6, 1)]
    assert seg.shape == (9, 24, 16384) and ext.shape == (16384,)
    hist_kernel.device_segment_tables.cache_clear()
