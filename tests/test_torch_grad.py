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
    # global scratch: one history per warp, capped by STASH_BUDGET
    nblk, floats = grad_kernel.grid(1 << 20, 10, 2, 64,
                                    grad_kernel.Plan(4, False), 132, 4)
    assert (nblk, floats) == (528, 528 * 4 * 9 * 5 * 64)
    hist = grad_kernel.history_floats(2000, 2, 64) * 4
    nblk, _ = grad_kernel.grid(1 << 20, 2000, 2, 64,
                               grad_kernel.Plan(4, False), 132, 4)
    assert nblk == grad_kernel.STASH_BUDGET // (4 * hist)
    # block mapping: one history per block
    assert grad_kernel.grid(1 << 20, 10, 2, 243, grad_kernel.Plan(0, False),
                            132, 8) == (1056, 1056 * 9 * 5 * 243)
