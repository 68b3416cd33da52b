"""K2's host side and its CPU path against the JAX gradient kernel.

The JAX side runs pallas_grad.neg_log_likelihood with the Pallas kernel in
interpret mode (``pallas_grad.INTERPRET``, restored afterwards).  The port's
``grad_kernel.neg_log_likelihood`` on CPU tensors runs its plain version
(torch autograd of the engine).  Tolerances (float32): value rtol 2e-5,
gradients rtol/atol 2e-3, as tests/test_pallas_grad.py holds the TPU kernel.

The CUDA kernels themselves are checked against their plain versions in
tests/test_torch_cuda.py (needs a GPU).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from extrack_tpu.core import tables as jtables
from extrack_tpu.ops import pallas_grad
from extrack_tpu_torch.core import tables as ttables
from extrack_tpu_torch.ops import cuda_lib, forward_kernel, grad_kernel
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)


@pytest.fixture
def interpret_mode():
    pallas_grad.INTERPRET = True
    try:
        yield
    finally:
        pallas_grad.INTERPRET = False


def _data(seed, B, T, S):
    rng = np.random.default_rng(seed)
    xs = rng.normal(0, 0.06, (B, T, 2)).cumsum(1).astype(np.float32)
    lengths = rng.integers(2, T + 1, B)
    lengths[:2] = (T, 2)
    isbl = (lengths < T).astype(np.float32)
    return xs, lengths.astype(np.int32), isbl


def _objective(S, W, n, xs, lengths, isbl, port):
    """-sum logL as a function of theta = (Ds, rates..., LocErr, pBL)."""
    def f(th, xp, tabmod, nll, data):
        Ds = th[:S]
        k = S
        rows = []
        for i in range(S):
            row = []
            for j in range(S):
                if i == j:
                    row.append(0.0 * th[0])
                else:
                    row.append(th[k])
                    k += 1
            rows.append(xp.stack(row))
        rates = xp.stack(rows)
        Fs = xp.stack([0.0 * th[0] + 1.0 / S] * S)
        tb = tabmod.build_tables(Ds, th[k], Fs, rates, th[k + 1], 0.02,
                                 cell_dims=(0.8,), nb_substeps=n)
        return nll(*data, tb, window=W, nb_substeps=n, min_len=2)

    if port:
        data = (torch.tensor(xs), torch.tensor(lengths), torch.tensor(isbl))
        return lambda th: f(th, torch, ttables,
                            grad_kernel.neg_log_likelihood, data)
    data = (jnp.asarray(xs), jnp.asarray(lengths), jnp.asarray(isbl))
    return lambda th: f(th, jnp, jtables, pallas_grad.neg_log_likelihood,
                        data)


@pytest.mark.parametrize("S,W,n", [(2, 4, 1), (2, 4, 2), (3, 3, 1)])
def test_cpu_path_matches_pallas_grad(S, W, n, interpret_mode):
    xs, lengths, isbl = _data(10 * S + W + n, 10, 6, S)
    theta = np.concatenate([np.linspace(1e-3, 0.12, S),
                            np.full(S * (S - 1), 0.1), [0.02, 0.06]]
                           ).astype(np.float32)
    theta[S] = 0.0                                     # a forbidden rate
    v_ref, g_ref = jax.value_and_grad(
        _objective(S, W, n, xs, lengths, isbl, port=False))(
            jnp.asarray(theta))
    th = torch.tensor(theta, requires_grad=True)
    plain = grad_kernel.PLAIN_CALLS, grad_kernel.LAUNCHES
    v = _objective(S, W, n, xs, lengths, isbl, port=True)(th)
    (g,) = torch.autograd.grad(v, th)
    assert (grad_kernel.PLAIN_CALLS, grad_kernel.LAUNCHES) == (
        plain[0] + 1, plain[1])
    np.testing.assert_allclose(float(v.detach()), float(v_ref), rtol=2e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("S,W,n", [(2, 6, 1), (3, 4, 2)])
def test_prepare_args_match_pallas(S, W, n):
    """The kernel inputs (2*pi fold, per-slot tables, l2 layout) equal the
    JAX kernel's, up to layout: JAX rides tracks on the lane axis."""
    rng = np.random.default_rng(S + W)
    xs, lengths, isbl = _data(1, 7, 5, S)
    rates = rng.uniform(0.02, 0.2, (S, S))
    jt = jtables.build_tables(
        jnp.asarray(np.linspace(0, 0.1, S), jnp.float32),
        jnp.asarray(0.02, jnp.float32),
        jnp.asarray(np.full(S, 1.0 / S), jnp.float32),
        jnp.asarray(rates, jnp.float32), jnp.asarray(0.1, jnp.float32),
        jnp.asarray(0.02, jnp.float32), cell_dims=(0.8,), nb_substeps=n)
    tt = ttables.tables_from_numpy(
        {f: np.asarray(getattr(jt, f)) for f in jt._fields}, "cpu",
        torch.float32)
    _, _, _, _, dargs = pallas_grad.prepare_args(
        jnp.asarray(xs), jnp.asarray(lengths), jnp.asarray(isbl), jt,
        window=W, nb_substeps=n)
    (pos, l2, lens, bl), tabs = forward_kernel.kernel_inputs(
        torch.tensor(xs), torch.tensor(lengths), torch.tensor(isbl), tt,
        W, n)
    B, T, D = xs.shape
    np.testing.assert_allclose(
        l2.numpy(), np.asarray(dargs[0])[:, :B].reshape(T, D, B)
        .transpose(2, 0, 1), rtol=1e-7)
    for mine, theirs in zip(tabs, dargs[1:11]):
        np.testing.assert_allclose(mine.numpy().reshape(theirs.shape),
                                   np.asarray(theirs), rtol=1e-6, atol=1e-6)
    assert tabs[1] is tabs[5]                 # s20 and sig2v: one table
    assert pos.dtype == torch.float32 and lens.dtype == torch.int32


def test_table_grads_cpu_equal_plain():
    xs, lengths, isbl = _data(3, 9, 6, 2)
    tt = ttables.build_tables(
        torch.tensor([0.0, 0.1]), torch.tensor(0.02), torch.tensor([.4, .6]),
        torch.tensor([[0.0, 0.1], [0.2, 0.0]]), torch.tensor(0.1), 0.02,
        cell_dims=(0.8,))
    args = (torch.tensor(xs), torch.tensor(lengths), torch.tensor(isbl), tt)
    v1, g1 = grad_kernel.value_and_table_grads(*args, window=4)
    v2, g2 = grad_kernel.value_and_table_grads_plain(*args, window=4)
    assert float(v1) == float(v2)
    assert set(g1) == set(ttables.ModelTables._fields)
    for k in g1:
        torch.testing.assert_close(g1[k], g2[k], rtol=0, atol=0)


def test_kernel_loader_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the loader would succeed")
    with pytest.raises(RuntimeError, match="CUDA device"):
        cuda_lib.library()
    # launching on CPU tensors raises instead of returning the plain result
    xs, lengths, isbl = _data(4, 3, 5, 2)
    tt = ttables.build_tables(
        torch.tensor([0.0, 0.1]), torch.tensor(0.02), torch.tensor([.4, .6]),
        torch.tensor([[0.0, 0.1], [0.2, 0.0]]), torch.tensor(0.1), 0.02)
    data, tabs = forward_kernel.kernel_inputs(
        torch.tensor(xs), torch.tensor(lengths), torch.tensor(isbl), tt, 4, 1)
    before = forward_kernel.LAUNCHES, grad_kernel.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        forward_kernel.launch(data, [t.detach() for t in tabs], 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        grad_kernel.launch(data, [t.detach() for t in tabs], 3)
    assert (forward_kernel.LAUNCHES, grad_kernel.LAUNCHES) == before


def _occupancy(K, A, T, itemsize=4):
    """Blocks per SM of a warp-mapping launch on an H100-like SM: 228 KB of
    shared memory (1 KB reserved per block) and at most 16 warps (the
    registers)."""
    def occ(warps, stash_smem):
        block = warps * grad_kernel.warp_slice_bytes(K, A, 2, T, stash_smem,
                                                     itemsize)
        return min(16 // warps, (228 * 1024) // (block + 1024))
    return occ


@pytest.mark.parametrize("K,A,T,plan", [
    (8, 2, 10, (4, True)), (16, 2, 10, (4, True)), (32, 2, 10, (4, True)),
    (27, 3, 10, (4, True)), (64, 2, 10, (4, False)), (64, 4, 10, (4, False)),
    (64, 2, 4, (4, True)), (64, 2, 7, (4, True))])
def test_k2_plan_warp_mapping_up_to_64_slots(K, A, T, plan):
    # every slot count up to 64 walks one track per warp.  Up to 32 slots
    # 16 warps fit an SM with the carry history in shared memory however
    # they are grouped (the largest block wins the tie).  At K = 64 and
    # T = 10 a warp's slice is 18 KB: the best grouping keeps 12 warps
    # resident against 16 with the history in global scratch, so it goes
    # there; at T = 4 or 7 the slices keep 16 resident
    pl = grad_kernel.plan(K, A, 2, T, 227 * 1024, _occupancy(K, A, T))
    assert pl == grad_kernel.Plan(*plan)
    assert grad_kernel.plan(K, A, 2, T, 227 * 1024, _occupancy(K, A, T),
                            stash="smem").stash_smem
    assert grad_kernel.warp_slice_bytes(64, 2, 2, 10, True) == 4 * (
        17 * 64 + 8 * 64 + 4 * 10 * 2 + 4 + 9 * 5 * 64)


@pytest.mark.parametrize("K,A", [(81, 3), (243, 3), (256, 4), (1024, 2)])
def test_k2_plan_block_mapping_above_64_slots(K, A):
    occ = _occupancy(K, A, 10)
    assert grad_kernel.plan(K, A, 2, 10, 227 * 1024, occ) == (
        grad_kernel.Plan(0, False))
    with pytest.raises(ValueError, match="K <= 64"):
        grad_kernel.plan(K, A, 2, 10, 227 * 1024, occ, mapping="warp")


def test_k2_plan_history_in_global_scratch_when_it_does_not_fit():
    # T = 400 at K = 64: one warp's history alone is 456 KB
    occ = _occupancy(64, 2, 400)
    assert grad_kernel.plan(64, 2, 2, 400, 227 * 1024, occ) == (
        grad_kernel.Plan(4, False))
    with pytest.raises(ValueError, match="does not fit"):
        grad_kernel.plan(64, 2, 2, 400, 227 * 1024, occ, stash="smem")
    occ = _occupancy(64, 2, 10)
    assert grad_kernel.plan(64, 2, 2, 10, 227 * 1024, occ,
                            stash="global") == grad_kernel.Plan(4, False)
    assert grad_kernel.plan(32, 2, 2, 10, 227 * 1024, occ,
                            mapping="block") == grad_kernel.Plan(0, False)
    # dual numbers (K3) double every slice
    assert grad_kernel.warp_slice_bytes(64, 2, 2, 10, True, 8) == 2 * (
        grad_kernel.warp_slice_bytes(64, 2, 2, 10, True))


def test_k2_grid():
    pl = grad_kernel.Plan(2, True)
    # resident blocks fill the card, no more blocks than the tracks need
    assert grad_kernel.grid(1 << 20, 10, 2, 64, pl, 132, 7) == (924, 0)
    assert grad_kernel.grid(5, 10, 2, 64, pl, 132, 7) == (3, 0)
    # global scratch: one history per warp, capped by the budget of the
    # block's global memory (its histories and its row of partials)
    nblk, floats = grad_kernel.grid(1 << 20, 10, 2, 64,
                                    grad_kernel.Plan(4, False), 132, 4)
    assert (nblk, floats) == (528, 528 * 4 * 9 * 5 * 64)
    hist = grad_kernel.history_floats(2000, 2, 64) * 4
    part = grad_kernel.partial_bytes(64, 2)
    assert part == 4 * (6 * 64 + 4 * 64 * 2)
    nblk, floats = grad_kernel.grid(1 << 20, 2000, 2, 64,
                                    grad_kernel.Plan(4, False), 132, 4, A=2)
    assert nblk == cuda_lib.SCRATCH_BUDGET // (4 * hist + part)
    assert floats * 4 == nblk * 4 * hist
    # a smaller budget (the card's free memory) takes fewer blocks
    assert grad_kernel.grid(1 << 20, 2000, 2, 64, grad_kernel.Plan(4, False),
                            132, 4, A=2, budget=3 * (4 * hist + part))[0] == 3
    # block mapping: one history per block
    assert grad_kernel.grid(1 << 20, 10, 2, 243, grad_kernel.Plan(0, False),
                            132, 8) == (1056, 1056 * 9 * 5 * 243)


# ---- the wide mapping: 1024 < K <= 4096 (a thread a fusion group) ------

H100_OPTIN = 232448           # bytes of shared memory a block may opt in to


@pytest.mark.parametrize("K,A,want", [
    (243, 3, 0), (1024, 2, 0), (1024, 4, 0), (1296, 6, -1), (2048, 4, -1),
    (2187, 3, -1), (3125, 5, -1), (4096, 4, -1), (4096, 2, -1)])
def test_k2_plan_wide_mapping_exactly_past_1024_slots(K, A, want):
    occ = _occupancy(min(K, 64), 2, 10)
    for itemsize in (4, 8):               # K2, and K3's dual numbers
        pl = grad_kernel.plan(K, A, 3, 20, H100_OPTIN, occ, itemsize)
        assert pl == grad_kernel.Plan(want, False)
    assert grad_kernel.WIDE == -1 and grad_kernel.WIDE_GLOBAL == -2
    if want == 0:
        # forced: the wide mapping at any register up to 4096 slots
        assert grad_kernel.plan(K, A, 2, 10, H100_OPTIN, occ,
                                mapping="wide").warps == grad_kernel.WIDE
    else:
        with pytest.raises(ValueError, match="K <= 1024"):
            grad_kernel.plan(K, A, 2, 10, H100_OPTIN, occ, mapping="block")
    for K_past, A_past in ((5 ** 7, 5), (2 ** 16, 2), (3 ** 10, 3)):
        with pytest.raises(ValueError, match="K <= 65536 and at most 16384 "
                                             "fusion groups"):
            grad_kernel.plan(K_past, A_past, 2, 10, H100_OPTIN, occ)


@pytest.mark.parametrize("K,A", [(1296, 6), (2048, 2), (2187, 3),
                                 (3125, 5), (4096, 4), (4096, 2)])
@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_k2_wide_layout_and_its_global_variant(K, A, D, itemsize):
    T = 12
    G = K // A
    # by hand, a cluster of one block: a thread a group, at most 1024;
    # shared memory holds the 64 scalars of the block reductions and the
    # (2D+1)K exchange; global scratch the (T-3)(2D+1)G history, and the
    # exchange in the global variant
    lay = grad_kernel.wide_layout(K, A, D, T, 1, False, itemsize)
    assert lay == (min(1024, -(-G // 32) * 32),
                   (64 + (2 * D + 1) * K) * itemsize,
                   (T - 3) * (2 * D + 1) * G * itemsize)
    glob = grad_kernel.wide_layout(K, A, D, T, 1, True, itemsize)
    assert glob == (lay.threads, 64 * itemsize,
                    lay.scratch + (2 * D + 1) * K * itemsize)
    assert lay.threads * grad_kernel.WIDE_GROUPS >= G
    # every register up to 4096 slots fits an H100 block's opt-in in one
    # block, dual numbers at K = 4096 and D = 3 with 2,560 bytes to spare
    assert lay.smem <= H100_OPTIN
    # one block where its exchange fits the opt-in limit; a byte less and
    # the exchange splits over a cluster of two blocks; the global variant
    # where no cluster's slice fits
    occ = _occupancy(64, 2, 10)
    assert grad_kernel.plan(K, A, D, T, lay.smem, occ, itemsize) == (
        grad_kernel.Plan(grad_kernel.WIDE, False))
    half = grad_kernel.wide_layout(K, A, D, T, 2, False, itemsize)
    assert half.smem < lay.smem
    assert grad_kernel.plan(K, A, D, T, lay.smem - 1, occ, itemsize) == (
        grad_kernel.Plan(grad_kernel.WIDE, False, 2))
    assert grad_kernel.plan(K, A, D, T, 64 * itemsize, occ, itemsize) == (
        grad_kernel.Plan(grad_kernel.WIDE_GLOBAL, False))
    with pytest.raises(ValueError, match="does not fit"):
        grad_kernel.plan(K, A, D, T, 64 * itemsize, occ, itemsize,
                         stash="smem")
    assert grad_kernel.plan(K, A, D, T, lay.smem, occ, itemsize,
                            stash="global").warps == grad_kernel.WIDE_GLOBAL


def test_k2_wide_grid_under_the_stash_budget():
    lay = grad_kernel.wide_layout(4096, 4, 2, 20, 1, False, 8)
    part = grad_kernel.partial_bytes(4096, 4, 8)
    for pl in (grad_kernel.Plan(grad_kernel.WIDE, False),
               grad_kernel.Plan(grad_kernel.WIDE_GLOBAL, False)):
        per = grad_kernel.wide_layout(4096, 4, 2, 20, 1,
                                      pl.warps == grad_kernel.WIDE_GLOBAL,
                                      8).scratch
        # as many clusters as the card keeps resident (132 of one block),
        # no more than tracks
        assert grad_kernel.grid(1 << 20, 20, 2, 4096, pl, 132, 132, 8,
                                A=4) == (132, 132 * per // 4)
        assert grad_kernel.grid(7, 20, 2, 4096, pl, 132, 132, 8,
                                A=4) == (7, 7 * per // 4)
    assert lay.scratch == 17 * 5 * 1024 * 8
    assert part == (6 * 4096 + 4 * 4096 * 4) * 8
    # long tracks: the history and the partial rows cap the clusters at
    # the budget (by default cuda_lib.SCRATCH_BUDGET)
    T = 4000
    per = grad_kernel.wide_layout(4096, 4, 3, T, 1, False, 8).scratch
    nblk, floats = grad_kernel.grid(1 << 20, T, 3, 4096,
                                    grad_kernel.Plan(grad_kernel.WIDE, False),
                                    132, 132, 8, A=4)
    assert nblk == cuda_lib.SCRATCH_BUDGET // (per + part) < 132
    assert floats * 4 == nblk * per
    assert nblk * (per + part) <= cuda_lib.SCRATCH_BUDGET
    # K3 at 4 states, W = 7, D = 3, T = 20 in clusters of two with their
    # exchange in global scratch: history 487,424 scalars, the two slices
    # 2 x 57,344 and the partial row 360,448, about 7.6 MB a cluster in
    # dual numbers; the card's free memory shrinks the grid (in clusters
    # of two blocks), and one cluster past the budget raises
    glob = grad_kernel.Plan(grad_kernel.WIDE_GLOBAL, False, 2)
    lay = grad_kernel.wide_layout(4 ** 7, 4, 3, 20, 2, True, 8)
    part = grad_kernel.partial_bytes(4 ** 7, 4, 8)
    assert lay.scratch == (487424 + 2 * 57344) * 8
    assert part == 360448 * 8
    assert grad_kernel.grid(1 << 14, 20, 3, 4 ** 7, glob, 132, 66, 8, A=4,
                            budget=50 * (lay.scratch + part)) == (
        100, 50 * lay.scratch // 4)
    with pytest.raises(RuntimeError, match=r"one block's global memory \("
                       rf"{lay.scratch + part} bytes"):
        grad_kernel.grid(1 << 14, 20, 3, 4 ** 7, glob, 132, 66, 8, A=4,
                         budget=lay.scratch + part - 1)


@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_k2_k3_envelope_reaches_4096_slots(kernel):
    forward_kernel.check_envelope(20, 3, 4, 6, 1, kernel=kernel)   # 4096
    forward_kernel.check_envelope(20, 2, 3, 7, 1, variable_dt=True,
                                  kernel=kernel)                   # 2187
    # past 4096 up to 65536: 6^5, 3^8, 5^6 (the GUI's frame_len 6 at 5
    # states), 4^7 and 2^14, and past 16384 6^6 (the GUI's at 6 states),
    # 4^8, 3^9, 7^5, 8^5 and 2^15 (16384 fusion groups)
    for S, W in ((6, 5), (3, 8), (5, 6), (4, 7), (2, 14), (6, 6), (4, 8),
                 (3, 9), (7, 5), (8, 5), (2, 15)):
        forward_kernel.check_envelope(20, 3, S, W, 1, kernel=kernel)
        forward_kernel.check_envelope(20, 2, S, W, 1, variable_dt=True,
                                      kernel=kernel)
    for S, W, fits in ((5, 7, 6), (7, 6, 5)):
        with pytest.raises(NotImplementedError,
                           match=(rf"bucket 1 .*K=S\*\*window={S ** W} > "
                                  rf"65536 register slots \({kernel} maps "
                                  rf"at most 65536.*window that fits is "
                                  rf"{fits}")):
            forward_kernel.check_envelope(20, 2, S, W, 1, what="bucket 1",
                                          kernel=kernel)
    for S, W, fits in ((3, 10, 9), (2, 16, 15)):
        with pytest.raises(NotImplementedError,
                           match=(rf"bucket 1 .*K/A={S ** (W - 1)} > 16384 "
                                  rf"fusion groups \({kernel} maps at most "
                                  rf"16384, up to 16 a thread of 1024; the "
                                  rf"largest window that fits is {fits}")):
            forward_kernel.check_envelope(20, 2, S, W, 1, what="bucket 1",
                                          kernel=kernel)
