"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc (the kernels have no CPU mode) and
skip without one.  They import no JAX, so on a machine without it they run
as ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
Tolerances (float32): per-track logL rtol 2e-5 / atol 2e-4; value rtol
2e-5; table gradients rtol/atol 2e-3.
"""
import numpy as np
import pytest
import torch

from extrack_tpu_torch.core import tables
from extrack_tpu_torch.ops import forward_kernel, grad_kernel


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
