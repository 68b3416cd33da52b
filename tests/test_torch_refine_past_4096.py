"""K6 past 4096 register slots (up to 16384), where the port's card runs
the tiled wide mapping (csrc/refine.cu: the scan kernel, its publish
areas in global scratch where they pass what a block may opt in to, the
pair kernel and the merge); the JAX package runs its XLA mixture path
there.

* refinement at 6^5 and 3^8 (1-D) through the port's CPU path (the
  plain ``refine_positions``, which takes the mixture's moments block by
  block) against the JAX package's XLA ``refine_positions`` in float64,
  at 1e-7 (a track of three frames: both ends and one interior
  position);
* the block-by-block moments equal those of ``position_mixtures``' whole
  mixture (1e-12), ends, lone observations and padding included;
* the launch plan at every (S, W, D) with 4096 < S^W <= 16384 (S <= 8):
  a scan block of 1024 threads, its shared bytes within the opt-in, the
  publish areas in global scratch exactly where they do not fit, the
  chunks' scratch within the budget; past 16384 slots K6 raises naming
  16384.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from extrack_tpu import refine as jrefine
from extrack_tpu_torch import refine as trefine
from extrack_tpu_torch.ops import cuda_lib, forward_kernel, refine_kernel
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)
from tests.refine_tiled_twin import layout as _layout

SMEM = 232448             # shared bytes a block may opt in to on an H100


def _case(S, B, T, D, seed, per_peak=False):
    rng = np.random.default_rng(seed)
    xs = rng.normal(0.0, 0.05, (B, T, D)).cumsum(1)
    lengths = np.full(B, T)
    tr = np.full((S, S), 0.1 / (S - 1))
    np.fill_diagonal(tr, 0.9)
    tr[0, -1] = 0.0                                   # forbidden
    tr /= tr.sum(1, keepdims=True)
    l2 = (rng.uniform(1e-4, 9e-4, (B, T, D)) if per_peak
          else np.full((1, 1, 1), 4e-4))
    log_trans = np.log(np.maximum(tr, 1e-300))
    sig2 = 2 * np.linspace(0.001, 0.1, S) * 0.02
    return xs, lengths, l2, log_trans, sig2


@pytest.mark.parametrize("S,W,D,per_peak", [(6, 5, 1, False),
                                            (3, 8, 1, True)])
def test_refinement_past_4096_slots_matches_jax(S, W, D, per_peak):
    """K = 7776 (6 states, frame_len 5, 1-D) and 6561 (3 states, frame_len
    8): the port's CPU refinement against the JAX package's XLA path."""
    args = _case(S, 1, 3, D, seed=S * W, per_peak=per_peak)
    before = refine_kernel.PLAIN_CALLS
    mu, sig = refine_kernel.refine(*(torch.tensor(a) for a in args),
                                   window=W)
    assert refine_kernel.PLAIN_CALLS == before + 1
    mu_j, sig_j = jrefine.refine_positions(*(jnp.asarray(a) for a in args),
                                           window=W)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), rtol=1e-7,
                               atol=1e-12)
    np.testing.assert_allclose(sig.numpy(), np.asarray(sig_j), rtol=1e-7,
                               atol=1e-12)


@pytest.mark.parametrize("S,W,T,D", [(2, 4, 6, 2), (3, 3, 5, 3),
                                     (4, 2, 4, 1), (2, 5, 7, 1)])
def test_blockwise_moments_equal_the_whole_mixture(S, W, T, D):
    """refine_positions' moments, taken a state block at a time with a
    running maximum, are those of position_mixtures' whole mixture:
    interior positions, both ends, two-frame and one-frame tracks, and
    zeros past each length."""
    xs, _, l2, log_trans, sig2 = _case(S, 6, T, D, seed=S + W + T,
                                       per_peak=True)
    lengths = np.array([T, T - 1, 3, 2, 1, 0])
    args = [torch.tensor(a) for a in (xs, lengths, l2, log_trans, sig2)]
    mu, sig = trefine.refine_positions(*args, window=W)
    mu_c, var_c, lw, _ = trefine.position_mixtures(*args, window=W)
    mu0, var0 = trefine._moment_match_mixture(mu_c, var_c, lw)
    valid = (np.arange(T)[None, :] < lengths[:, None])[..., None]
    np.testing.assert_allclose(mu.numpy(), np.where(valid, mu0, 0.0),
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(sig.numpy(),
                               np.where(valid, var0.sqrt(), 0.0),
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(mu.numpy()[4, 0], xs[4, 0], rtol=1e-14)
    np.testing.assert_allclose(sig.numpy()[4, 0], np.sqrt(l2[4, 0]),
                               rtol=1e-14)


# every register past 4096 slots up to 16384 at S <= 8
PAST_4096_REGISTERS = [(S, W) for S in range(2, 9) for W in range(2, 15)
                       if 4096 < S ** W <= 16384]


@pytest.mark.parametrize("D", [1, 2, 3])
def test_k6_past_4096_slots_plans_fit_every_register(D):
    """At every register of (4096, 16384]: the tiled wide mapping; the
    scan's publish areas in global scratch exactly where its shared bytes
    pass the opt-in, and the chunks' scratch within the budget of an 80 GB
    card (``_layout``, the kernel's layout's host twin)."""
    global_at = set()
    budget = min(cuda_lib.WIDE_SCRATCH_BUDGET, 40 * 10 ** 9)
    for S, W in PAST_4096_REGISTERS:
        K = S ** W
        assert forward_kernel.mapping_warps("K6", K) == forward_kernel.WIDE
        forward_kernel.check_envelope(20, D, S, W, 1, kernel="K6")
        rows = refine_kernel.PAIR_ROWS * refine_kernel.pair_threads(K // S)
        for T in (2, 5, 20, 60):
            pl = refine_kernel.plan(T, D, K, S, SMEM, layout=_layout)
            assert pl.wide == (
                2 if _layout(T, D, K, S, 1, rows)[1] > SMEM else 1)
            assert pl.threads == 1024 and pl.fixed <= SMEM
            if pl.wide == 2:
                global_at.add((S, W))
            n = refine_kernel.chunk_tracks(1 << 17, pl.carry, budget)
            assert n * pl.carry <= budget
    # the scan's publish areas and partials fit the opt-in at 4^7 for
    # every D (2 * 7 * 4096 floats and two positions' partials at D = 3:
    # 231,424 bytes); 2^14 (8192 groups) passes it from D = 2; 8 at 3
    # states, 6 at 5 and 5 at 6 never do
    assert (4, 7) not in global_at
    assert ((2, 14) in global_at) == (D >= 2)
    assert not global_at & {(3, 8), (6, 5), (5, 6)}
    for S, fits in ((3, 8), (4, 7), (5, 6)):
        with pytest.raises(NotImplementedError,
                           match=rf"K6 maps at most 16384.*window that fits "
                                 rf"is {fits}"):
            forward_kernel.check_envelope(20, D, S, fits + 1, 1,
                                          kernel="K6")
