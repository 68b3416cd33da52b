"""K3: exact Hessian-vector products at the model-table level, through the
dual-number kernel (csrc/hvp.cu).

Replaces extrack_tpu/ops/pallas_hvp.py:_hvp_kernel and its custom-JVP
wiring.  ``table_hvp(positions, lengths, is_bleached, tables, tables_dot)``
returns ``(-sum logL, {field: gradient}, {field: H . tables_dot})`` for the
ModelTables fields, H the Hessian of -sum logL w.r.t. the tables:

* CUDA tensors (float32): ``kernel_inputs`` (forward_kernel) is piecewise
  linear in the tables (gathers, sums, clamp_min, a constant, an expand),
  so H = K^T M K with M the kernel-level Hessian and K the Jacobian of
  ``kernel_inputs``.  ``tables_dot`` goes through ``kernel_inputs``' JVP,
  one K3 launch gives the kernel-level cotangents and their tangents, and
  both are pulled back through ``kernel_inputs``' VJP.
  Outside the kernels' envelope it raises.
* CPU tensors: ``table_hvp_plain``, forward-over-reverse (double backward)
  of ``core.engine.forward``.

Positions get no tangent (the fit differentiates parameters, never data).
``LAUNCHES`` counts K3 launches, ``PLAIN_CALLS`` calls of the plain version.
"""
from __future__ import annotations

import torch

from extrack_tpu_torch.core import engine
from extrack_tpu_torch.core.tables import ModelTables
from extrack_tpu_torch.ops import cuda_lib, forward_kernel, grad_kernel

LAUNCHES = 0
PLAIN_CALLS = 0


def launch(data, tabs, l2_dot, tabs_dot, min_len: int,
           mapping: str | None = None, stash: str | None = None):
    """Launch K3 on the current stream.  ``data`` and ``tabs`` as for K2,
    ``l2_dot`` and ``tabs_dot`` their tangents (same shapes).  Returns
    (logL, its tangent), (d(sum logL)/d l2, its tangent) and the ten table
    cotangents with their tangents, each as (value, tangent) pairs.  The
    mapping is K2's (``grad_kernel.plan`` on dual scalars); ``mapping``
    and ``stash`` force it."""
    global LAUNCHES
    xs, l2 = data[0], data[1]
    B, T, D = xs.shape
    K, A = tabs[6].shape
    forward_kernel.validate(data, tabs, K, A)
    forward_kernel.validate((xs, l2_dot, data[2], data[3]), tabs_dot, K, A)
    lib = cuda_lib.library()
    dev = xs.device

    def dual(v, t):
        return torch.stack([v, t], dim=-1).contiguous()

    pl, nblk, nscratch = grad_kernel.setup(lib, lib.extrack_hvp_occupancy,
                                           B, T, D, K, A, dev, 8, mapping,
                                           stash)
    ncols = 6 * K + 4 * K * A
    f32 = dict(dtype=torch.float32, device=dev)
    logl = torch.empty((B, 2), **f32)
    ct_l2 = torch.zeros((B, T, D, 2), **f32)
    ct_tab = torch.empty((ncols, 2), **f32)
    scratch = torch.empty(max(1, nscratch), **f32)
    partial = torch.empty(nblk * ncols * 2, **f32)
    args = (xs, dual(l2, l2_dot), data[2], data[3],
            *(dual(t, d) for t, d in zip(tabs, tabs_dot)), logl, ct_l2,
            ct_tab, scratch, partial)
    rc = lib.extrack_hvp(
        *(t.data_ptr() for t in args), B, T, D, K, A, int(min_len), nblk,
        pl.warps, int(pl.stash_smem),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(rc, "Hessian-vector product")
    LAUNCHES += 1

    def split(ct):
        return (list(ct[:6 * K].view(6, K).unbind(0))
                + list(ct[6 * K:].view(4, K, A).unbind(0)))

    return ((logl[:, 0], logl[:, 1]), (ct_l2[..., 0], ct_l2[..., 1]),
            (split(ct_tab[:, 0]), split(ct_tab[:, 1])))


def _as_dict(grads, like):
    return {name: torch.zeros_like(f) if g is None else g.detach()
            for name, f, g in zip(ModelTables._fields, like, grads)}


def table_hvp_plain(positions, lengths, is_bleached, tables: ModelTables,
                    tables_dot: ModelTables, *, window: int = 6,
                    nb_substeps: int = 1, min_len: int = 3):
    """The plain version of K3: double backward of -sum
    ``core.engine.forward`` w.r.t. the tables."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    leaves = [f.detach().requires_grad_(True) for f in tables]
    value = -engine.forward(positions, lengths, is_bleached,
                            ModelTables(*leaves), window=window,
                            nb_substeps=nb_substeps, min_len=min_len).sum()
    grads = torch.autograd.grad(value, leaves, create_graph=True,
                                allow_unused=True)
    dot = sum((g * v).sum() for g, v in zip(grads, tables_dot)
              if g is not None)
    hv = torch.autograd.grad(dot, leaves, allow_unused=True)
    return value.detach(), _as_dict(grads, leaves), _as_dict(hv, leaves)


def table_hvp(positions, lengths, is_bleached, tables: ModelTables,
              tables_dot: ModelTables, *, window: int = 6,
              nb_substeps: int = 1, min_len: int = 3):
    """(-sum logL, gradient, Hessian . tables_dot) w.r.t. the tables; see
    the module docstring for the paths."""
    if positions.device.type == "cpu":
        return table_hvp_plain(positions, lengths, is_bleached, tables,
                               tables_dot, window=window,
                               nb_substeps=nb_substeps, min_len=min_len)
    _, T, D = positions.shape
    forward_kernel.check_envelope(
        T, D, tables.nb_states, window, nb_substeps,
        forward_kernel.classify_sig2(tables.sig2, T),
        forward_kernel.kernel_dtype(positions, tables))
    return _table_hvp_kernel(positions, lengths, is_bleached, tables,
                             tables_dot, window, nb_substeps, min_len)


def _table_hvp_kernel(positions, lengths, is_bleached, tables, tables_dot,
                      window, nb_substeps, min_len):
    """K3 wired between ``kernel_inputs``' JVP and VJP.  Both are reverse
    mode (the JVP by the double-backward trick): forward-mode autograd
    would script its decompositions on first use, seconds per process."""
    fields = tuple(f.detach() for f in tables)
    data, _ = forward_kernel.kernel_inputs(
        positions, lengths, is_bleached, ModelTables(*fields), window,
        nb_substeps)

    def args_of(*fs):           # tables -> (l2, ten kernel tables)
        d, tabs = forward_kernel.kernel_inputs(
            positions, lengths, is_bleached, ModelTables(*fs), window,
            nb_substeps)
        return (d[1], *tabs)

    leaves = tuple(f.requires_grad_(True) for f in map(torch.clone, fields))
    outs = args_of(*leaves)
    _, dots = torch.autograd.functional.jvp(
        args_of, fields, tuple(t.detach().to(f.dtype)
                               for t, f in zip(tables_dot, fields)))
    dots = [d.contiguous() for d in dots]
    (logl, _), (ct_l2, ct_l2_dot), (cts, cts_dot) = launch(
        data, [o.detach() for o in outs[1:]], dots[0], dots[1:], min_len)

    def pull(ct_l2, cts):
        # kernel cotangents are d(sum logL)/d(arg): negate for -sum logL
        return torch.autograd.grad(outs, leaves, (-ct_l2, *(-c for c in cts)),
                                   retain_graph=True, allow_unused=True)

    return (-logl.sum(), _as_dict(pull(ct_l2, cts), fields),
            _as_dict(pull(ct_l2_dot, cts_dot), fields))
