"""The port's exact Hessian assembly (``hessian_hvp_exact`` over
``hvp_kernel.table_hvp``) against jax.hessian of the JAX package's XLA
objective.

Same simulated tracks (numpy, fixed seed) and the same Parameters go to
both packages, in float64 on the CPU.  Tolerance: rtol 1e-8 (both sides
are exact second-order derivatives of the same engine, summed in another
order).  Fisher errors are in tests/test_torch_fisher.py.

The CUDA kernel K3 itself is checked against its plain version in
tests/test_torch_cuda.py (needs a GPU); on CPU tensors ``table_hvp`` runs
the plain version through the same Hessian assembly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from extrack_tpu import data as jdata, fit as jfit, params as jparams
from extrack_tpu import simulate as jsim
from extrack_tpu_torch import data as tdata, fit as tfit, params as tparams
from extrack_tpu_torch.core import tables as ttables
from extrack_tpu_torch.ops import hvp_kernel


def _dataset(S, nb_tracks, max_len, seed):
    Ds = np.linspace(0.0, 0.08, S)
    tr = np.full((S, S), 0.1 / (S - 1)) + np.diag(np.full(S, 0.9 - 0.1
                                                          / (S - 1)))
    tracks, _, _ = jsim.sim_fov(
        nb_tracks=nb_tracks, max_track_len=max_len, min_track_len=2,
        LocErr=0.02, Ds=Ds, TrMat=tr, dt=0.02, pBL=0.1,
        cell_dims=(0.5, None, None), seed=seed)
    jspec = jparams.generate_params(nb_states=S, D_max=1.0,
                                    estimated_Ds=list(Ds + 0.002))
    tspec = tparams.Parameters.from_records(
        [(p.name, p.value, p.min, p.max, p.vary, p.expr)
         for p in jspec._params.values()])
    z = jspec.to_unconstrained() + np.random.default_rng(seed).normal(
        0, 0.2, len(jspec.free_names()))
    return tracks, jspec, tspec, z


@pytest.mark.parametrize("S,n,W", [(2, 1, 4), (2, 2, 4), (3, 1, 5)])
def test_hessian_hvp_exact_matches_jax_hessian(S, n, W):
    tracks, jspec, tspec, z = _dataset(S, 40 if S == 2 else 12, 6, 10 + S)
    jb = jdata.from_dict_bucketed(tracks, max_buckets=2)
    tb = tdata.from_dict_bucketed(tracks, max_buckets=2, dtype=torch.float64)
    jo = jfit.make_objective(jb, jspec, 0.02, S, cell_dims=(0.5,),
                             window=W, nb_substeps=n, compute_engine="xla")
    H_ref = np.asarray(jax.hessian(jo)(jnp.asarray(z)))
    to = tfit.make_objective(tb, tspec, 0.02, S, cell_dims=(0.5,),
                             window=W, nb_substeps=n)
    plain = hvp_kernel.PLAIN_CALLS, hvp_kernel.LAUNCHES
    H = tfit.hessian_hvp_exact(tb, tspec, z, 0.02, S, cell_dims=(0.5,),
                               nb_substeps=n, window=W, min_len=to.min_len)
    # one table-level HVP per free parameter and bucket, all plain on CPU
    assert (hvp_kernel.PLAIN_CALLS, hvp_kernel.LAUNCHES) == (
        plain[0] + len(z) * len(tb), plain[1])
    np.testing.assert_allclose(H, H_ref, rtol=1e-8,
                               atol=1e-12 * np.abs(H_ref).max())


def test_table_hvp_plain_is_symmetric_and_linear():
    """H.(a u + b w) = a H.u + b H.w, and u.H.w = w.H.u, on the tables."""
    rng = np.random.default_rng(2)
    B, T = 9, 6
    xs = torch.tensor(rng.normal(0, 0.06, (B, T, 2)).cumsum(1))
    lengths = torch.tensor(rng.integers(2, T + 1, B), dtype=torch.int32)
    isbl = torch.tensor((rng.random(B) < 0.5).astype(float))
    f64 = dict(dtype=torch.float64)
    tb = ttables.build_tables(
        torch.tensor([0.0, 0.1], **f64), torch.tensor(0.02, **f64),
        torch.tensor([.4, .6], **f64),
        torch.tensor([[0.0, 0.1], [0.2, 0.0]], **f64),
        torch.tensor(0.1, **f64), 0.02, cell_dims=(0.8,))
    u, w = (ttables.ModelTables(*(torch.tensor(rng.normal(0, 1, f.shape))
                                  for f in tb)) for _ in range(2))
    kw = dict(window=4, min_len=3)
    hu = hvp_kernel.table_hvp(xs, lengths, isbl, tb, u, **kw)[2]
    hw = hvp_kernel.table_hvp(xs, lengths, isbl, tb, w, **kw)[2]
    mix = ttables.ModelTables(*(2 * a - 3 * b for a, b in zip(u, w)))
    hm = hvp_kernel.table_hvp(xs, lengths, isbl, tb, mix, **kw)[2]
    for k in hm:
        scale = float(2 * hu[k].abs().max() + 3 * hw[k].abs().max())
        torch.testing.assert_close(hm[k], 2 * hu[k] - 3 * hw[k], rtol=1e-9,
                                   atol=1e-9 * scale)
    uhw = sum(float((getattr(u, k) * hw[k]).sum()) for k in hw)
    whu = sum(float((getattr(w, k) * hu[k]).sum()) for k in hu)
    assert uhw == pytest.approx(whu, rel=1e-9)
