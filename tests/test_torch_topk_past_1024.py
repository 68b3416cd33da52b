"""The top-K histogram past 1024 register rows (up to 4096), where the
port's card runs K7's wide kernel (a thread several rows, persistent
blocks, the walk and the backpointers in shared memory or each block's
slice of global scratch) and the JAX package its XLA top-K engine.

On the CPU in float64: ``len_hist(engine="topk")`` at 3 states with
``max_nb_states`` 2000 and 4000 (registers of 2048 and 4096 rows) and with
a per-track dt dict at 2000, against the JAX package's ``len_hist`` at
1e-10; ``segment_backpointers`` at M = 2048 against the parents, states
and final weights of JAX's ``segment_histogram`` (exact, and 1e-10); and
the host twins of the wide kernel's launch (``check_envelope``, ``wide``,
``wide_layout``, ``wide_grid``) at M = 2048 and 4096, A = 2..6, D = 1..3.
The kernel itself is held to the plain version in tests/test_torch_cuda.py
(needs a GPU).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from extrack_tpu import histograms as jhist, simulate as jsim
from extrack_tpu_torch import histograms as thist
from extrack_tpu_torch.ops import topk_kernel
from tests.test_torch_histograms import _case
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)

SMEM = 232448             # shared bytes a block may opt in to on an H100
VALUES = {"LocErr": 0.02, "D0": 0.0, "D1": 0.02, "D2": 0.1,
          "F0": 0.3, "F1": 0.3, "F2": 0.4, "pBL": 0.1,
          **{f"p{i}{j}": 0.05 for i in range(3) for j in range(3)
             if i != j}}


@pytest.fixture(scope="module")
def tracks():
    tr = np.full((3, 3), 0.05) + np.eye(3) * 0.85
    tracks, _, _ = jsim.sim_fov(
        nb_tracks=40, max_track_len=10, min_track_len=3, LocErr=0.02,
        Ds=(0.0, 0.02, 0.1), TrMat=tr, dt=0.02, pBL=0.1,
        cell_dims=(0.5, None, None), seed=19)
    return tracks


@pytest.mark.parametrize("M,per_track_dt", [(2000, False), (4000, False),
                                            (2000, True)])
def test_len_hist_topk_past_1024_rows_matches_jax(tracks, M, per_track_dt):
    dt = 0.02
    if per_track_dt:
        rng = np.random.default_rng(M)
        dt = {k: rng.uniform(0.01, 0.05, (v.shape[0], v.shape[1] - 1))
              for k, v in tracks.items()}
    kw = dict(cell_dims=(0.5,), nb_states=3, engine="topk",
              max_nb_states=M)
    want = np.asarray(jhist.len_hist(tracks, VALUES, dt, **kw))
    before = topk_kernel.PLAIN_CALLS
    got = thist.len_hist(tracks, VALUES, dt, device="cpu", **kw)
    assert topk_kernel.PLAIN_CALLS > before
    T = max(int(k) for k in tracks)
    assert got.shape == want.shape == (T, 3)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    frames = (got * np.arange(1, T + 1)[:, None]).sum()
    np.testing.assert_allclose(
        frames, sum(v.shape[0] * v.shape[1] for v in tracks.values()),
        rtol=1e-10)
    # M rounds up to 128 rows (2048, 4096): past 1024, the wide kernel's
    assert topk_kernel.wide(-(-M // 128) * 128, 2, 3, SMEM)


def test_segment_backpointers_at_2048_rows_match_jax(monkeypatch):
    # 3 states, tracks of up to 10 frames: the register of 2048 rows fills
    # at frame 7 and prunes after
    xs, lengths, isbl, jt, tt = _case(71, 3, 12, 10)
    M = 2048
    seen = {}

    def capture(parents, states, w_final, *rest):
        seen.update(parents=parents, states=states, w_final=w_final)
        return decode(parents, states, w_final, *rest)

    decode = jhist.decode_backpointers
    monkeypatch.setattr(jhist, "decode_backpointers", capture)
    with jax.disable_jit():      # the backpointers as arrays, not tracers
        jhist.segment_histogram(jnp.asarray(xs), jnp.asarray(lengths),
                                jnp.asarray(isbl), jt, max_nb_states=M,
                                min_len=3)
    parents, states, w_final = thist.segment_backpointers(
        torch.tensor(xs), torch.tensor(lengths), torch.tensor(isbl), tt,
        max_nb_states=M, min_len=3)
    assert parents.shape == (9, 12, M)
    np.testing.assert_array_equal(parents.numpy(),
                                  np.asarray(seen["parents"]))
    np.testing.assert_array_equal(states.numpy(), np.asarray(seen["states"]))
    np.testing.assert_allclose(w_final.numpy(), np.asarray(seen["w_final"]),
                               rtol=1e-10, atol=1e-12)
    # the register pruned: the longest track's final rows are all live
    assert (w_final[0] > 0).sum() == M


def test_check_envelope_past_1024_rows():
    for M in (1152, 2048, 4000, 4096):
        for S, n in ((2, 1), (3, 1), (6, 1), (2, 2)):
            topk_kernel.check_envelope(20, 2, S, M, n)
            topk_kernel.check_envelope(20, 3, S, M, n, variable_dt=True)
    with pytest.raises(NotImplementedError,
                       match=r"max_nb_states=4097: K7 holds at most 4096 "
                             r"rows \(a thread up to 4 of them; the largest "
                             r"max_nb_states that fits is 4096\)"):
        topk_kernel.check_envelope(20, 2, 3, 4097)


@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("M", [2048, 4096])
def test_wide_layout_past_1024_rows(D, M):
    # 1024 threads, up to four rows a thread; the walk region in shared
    # memory only where it fits the opt-in (M = 2048 at A = 2 and 3 from
    # D = 1, at A = 3 and D = 2 212,992 bytes), the backpointers beside it
    # where they fit too, else each in the block's slice of scratch; the
    # decode's columns over the words and fold
    for A in range(2, 7):
        S = A
        for T in (2, 10, 20, 60):
            lay = topk_kernel.wide_layout(M, D, A, S, T, SMEM)
            assert topk_kernel.wide(M, D, A, SMEM)
            assert lay.threads == 1024 and -(-M // lay.threads) <= 4
            rows = 4 * (2 * D + 4) * M
            region = rows + topk_kernel.walk_bytes(M, D, A)
            assert lay.region == region
            assert lay.walk_smem == (region <= SMEM)
            bp = 3 * (T - 1) * M
            assert lay.bp_smem == (
                bp > 0 and (region if lay.walk_smem else 0) + bp <= SMEM)
            assert lay.smem == ((region if lay.walk_smem else 0)
                                + (bp if lay.bp_smem else 0)) <= SMEM
            scratch = ((0 if lay.walk_smem else region)
                       + (0 if lay.bp_smem else bp))
            assert lay.slice == -(-scratch // 16) * 16
            assert 1 <= lay.chunk <= T * S
            assert lay.chunk * 4 * 1024 <= region - rows
            raw = topk_kernel.wide_layout(M, D, A, S, T, SMEM, raw=True)
            assert not raw.bp_smem and raw.walk_smem == lay.walk_smem
            assert raw.slice == (0 if raw.walk_smem else region)
            # persistent blocks: one an SM for 2^15 tracks, fewer where the
            # slices pass the budget
            assert topk_kernel.wide_grid(1 << 15, lay, 132, 1 << 30) == (
                132 if lay.slice <= (1 << 30) // 132
                else (1 << 30) // lay.slice)
            assert topk_kernel.wide_grid(5, lay, 132, 1 << 30) == 5
    # the walk's bytes: M = 2048 fits at A = 3, D = 2 (212,992 bytes with
    # the rows) and not at A = 6, D = 3; M = 4096 never does
    assert topk_kernel.walk_bytes(2048, 2, 3) == 147456
    assert topk_kernel.wide_walk_bytes(2048, 2, 3) == 212992 <= SMEM
    assert topk_kernel.wide_walk_bytes(2048, 3, 6) > SMEM
    assert topk_kernel.walk_bytes(4096, 2, 2) == 262144 > SMEM
    with pytest.raises(RuntimeError, match="one K7 block's global scratch"):
        lay = topk_kernel.wide_layout(4096, 3, 6, 6, 20, SMEM)
        topk_kernel.wide_grid(10, lay, 132, lay.slice - 1)
