"""Parity of the port's plain engine (the plain version of K1) and of the
forward kernel's host side with the JAX package.

Tolerances: 1e-10 per track in float64 against extrack_tpu.core.engine
(the two engines do the same arithmetic in another order); rtol 2e-5 in
float32 against the Pallas forward kernel run in interpret mode (the bound
the kernel tests hold); 1e-12 on the per-slot kernel tables.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from extrack_tpu.core import engine as jengine, tables as jtables
from extrack_tpu.ops import pallas_engine
from extrack_tpu_torch.core import engine as tengine, tables as ttables
from extrack_tpu_torch.ops import forward_kernel
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)


def _case(seed, S=2, B=12, T=8, D=2, n=1, dt_mode="const", per_peak=False,
          dtype=np.float64):
    rng = np.random.default_rng(seed)
    xs = rng.normal(0, 0.06, (B, T, D)).cumsum(1).astype(dtype)
    lengths = rng.integers(2, T + 1, B)
    lengths[:3] = (T, 2, 3)
    lengths[-1] = 0                                     # padded row
    isbl = (rng.random(B) < 0.5).astype(dtype)
    rates = rng.uniform(0.03, 0.25, (S, S))
    rates[1, 0] = 0.0                                   # forbidden
    dt = {"const": 0.02, "step": rng.uniform(0.01, 0.03, T - 1),
          "track": rng.uniform(0.01, 0.03, (B, T - 1))}[dt_mode]
    loc = (rng.uniform(0.01, 0.03, (B, T, D)) if per_peak
           else np.float64(0.02))
    inp = dict(Ds=np.linspace(0.0, 0.15, S), loc_err=loc,
               Fs=rng.dirichlet(np.ones(S)), rates=rates, pBL=0.08,
               dt=np.asarray(dt))
    jt = jtables.build_tables(*(jnp.asarray(np.asarray(inp[k], dtype))
                                for k in ("Ds", "loc_err", "Fs", "rates",
                                          "pBL", "dt")),
                              cell_dims=(0.6,), nb_substeps=n)
    tt = ttables.tables_from_numpy(
        {f: np.asarray(getattr(jt, f)) for f in jt._fields}, "cpu",
        torch.float64 if dtype == np.float64 else torch.float32)
    return xs, lengths, isbl, jt, tt


@pytest.mark.parametrize("S,W,n,dt_mode,per_peak,bl", [
    (2, 4, 1, "const", False, True),
    (2, 4, 2, "const", False, True),      # substeps=2
    (2, 5, 1, "const", True, True),       # per-peak LocErr
    (3, 3, 1, "const", False, False),     # isBL off
    (2, 4, 1, "step", False, True),       # per-step dt
    (3, 4, 2, "track", True, True),       # per-track dt, 3 states, n=2
])
def test_forward_matches_jax_engine_f64(S, W, n, dt_mode, per_peak, bl):
    xs, lengths, isbl, jt, tt = _case(S * 7 + W + n, S=S, n=n,
                                      dt_mode=dt_mode, per_peak=per_peak)
    if not bl:
        isbl = np.zeros_like(isbl)
    want = jengine.forward(jnp.asarray(xs), jnp.asarray(lengths),
                           jnp.asarray(isbl), jt, window=W, nb_substeps=n,
                           min_len=3)
    got = tengine.forward(torch.tensor(xs), torch.tensor(lengths),
                          torch.tensor(isbl), tt, window=W, nb_substeps=n,
                          min_len=3)
    assert got.dtype == torch.float64
    assert float(got[-1]) == 0.0                        # padded row
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("S,W,n", [(2, 6, 1), (3, 4, 1), (2, 4, 2)])
def test_forward_f32_matches_pallas_interpret(S, W, n):
    xs, lengths, isbl, jt, tt = _case(50 + S + W, S=S, n=n, B=20,
                                      dtype=np.float32)
    want = pallas_engine.forward_pallas(
        jnp.asarray(xs), jnp.asarray(lengths), jnp.asarray(isbl), jt,
        window=W, nb_substeps=n, min_len=3, interpret=True)
    calls = forward_kernel.PLAIN_CALLS, forward_kernel.LAUNCHES
    got = forward_kernel.forward(torch.tensor(xs), torch.tensor(lengths),
                                 torch.tensor(isbl), tt, window=W,
                                 nb_substeps=n, min_len=3)
    # CPU tensors take the plain version, never the kernel
    assert (forward_kernel.PLAIN_CALLS, forward_kernel.LAUNCHES) == (
        calls[0] + 1, calls[1])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("S,W,n", [(2, 6, 1), (3, 5, 1), (2, 4, 2),
                                   (3, 3, 2)])
def test_slot_tables_match_pallas_host_side(S, W, n):
    _, _, _, jt, tt = _case(S + W + n, S=S, n=n)
    for a, b in zip(forward_kernel.build_slot_tables(tt, W, n),
                    pallas_engine.build_slot_tables(jt, W, n)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12)
    for a, b in zip(forward_kernel.build_next_tables(tt, W, n),
                    pallas_engine.build_next_tables(jt, W, n)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12)
    # hand-built tables with true -inf entries are floored, not NaN
    inf_t = tt._replace(log_trans=torch.full_like(tt.log_trans,
                                                  -float("inf")))
    assert all(torch.isfinite(v).all()
               for v in forward_kernel.build_slot_tables(inf_t, W, n))


def test_classify_sig2_and_envelope():
    B, T, P = 5, 2, 4
    assert not forward_kernel.classify_sig2(torch.zeros(1, P), T)
    # per-track dt at T=2 has one step row but differs across tracks
    assert forward_kernel.classify_sig2(torch.zeros(B, 1, P), T)
    assert forward_kernel.classify_sig2(torch.zeros(6, P), 7)
    with pytest.raises(NotImplementedError):
        forward_kernel.classify_sig2(torch.zeros(3, P), 7)
    forward_kernel.check_envelope(20, 2, 3, 5, 1)
    with pytest.raises(NotImplementedError, match="D=4"):
        forward_kernel.check_envelope(20, 4, 2, 6, 1)
    # K1, K2 and K3 map up to 65536 slots and 16384 fusion groups; each
    # raise names the kernel, its limit and the largest window that fits
    forward_kernel.check_envelope(20, 2, 2, 11, 1)          # K = 2048
    forward_kernel.check_envelope(20, 2, 2, 14, 1)          # K = 16384
    forward_kernel.check_envelope(20, 2, 2, 15, 1)          # K = 32768
    forward_kernel.check_envelope(20, 2, 2, 16, 2)          # 16384 groups
    with pytest.raises(NotImplementedError,
                       match="K/A=32768 > 16384 fusion groups.*K1.*window "
                             "that fits is 15"):
        forward_kernel.check_envelope(20, 2, 2, 16, 1)      # K = 65536
    for kernel in ("K2", "K3"):
        forward_kernel.check_envelope(20, 2, 2, 13, 1, kernel=kernel)
        forward_kernel.check_envelope(20, 2, 5, 6, 1, kernel=kernel)
        forward_kernel.check_envelope(20, 2, 6, 6, 1, kernel=kernel)
        forward_kernel.check_envelope(20, 2, 4, 8, 1, kernel=kernel)
        with pytest.raises(NotImplementedError,
                           match=f"K=S.*65536.*{kernel}.*window that fits "
                                 "is 6"):
            forward_kernel.check_envelope(20, 2, 5, 7, 1, kernel=kernel)
    # K4 maps up to 65536 slots (its carries in global scratch past a
    # block's shared memory)
    forward_kernel.check_envelope(20, 2, 2, 13, 1, kernel="K4")  # 8192
    forward_kernel.check_envelope(20, 2, 2, 16, 1, kernel="K4")  # 65536
    with pytest.raises(NotImplementedError,
                       match="K=S.*65536.*K4.*window that fits is 16"):
        forward_kernel.check_envelope(20, 2, 2, 17, 1, kernel="K4")
    with pytest.raises(NotImplementedError, match="float64"):
        forward_kernel.check_envelope(20, 2, 2, 6, 1, dtype=torch.float64)
    tb = ttables.build_tables(
        torch.tensor([0.0, 0.1]), torch.tensor(0.02), torch.tensor([.4, .6]),
        torch.tensor([[0.0, 0.1], [0.2, 0.0]]), torch.tensor(0.1), 0.02)
    pos = torch.zeros(3, 4, 2)
    assert forward_kernel.kernel_dtype(pos, tb) == torch.float32
    assert forward_kernel.kernel_dtype(pos.double(), tb) == torch.float64
    assert forward_kernel.kernel_dtype(
        pos, tb._replace(loc_err2=tb.loc_err2.double())) == torch.float64
    # variable dt is in K1's and K5's envelope (the streamed table); a
    # kernel that reads no stream (K6) raises, naming the bucket and itself
    forward_kernel.check_envelope(10, 2, 2, 6, 1, variable_dt=True,
                                  what="bucket 3")
    forward_kernel.check_envelope(10, 2, 2, 6, 1, variable_dt=True,
                                  what="bucket 3", kernel="K5")
    with pytest.raises(NotImplementedError, match="bucket 3.*K6"):
        forward_kernel.check_envelope(10, 2, 2, 6, 1, variable_dt=True,
                                      what="bucket 3", kernel="K6")
