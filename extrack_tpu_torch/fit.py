"""Maximum-likelihood fitting.

The reference minimizes the negative log likelihood with lmfit BFGS over
finite-difference gradients (extrack/tracking.py:1299-1387).  Here the
objective (parameter constraint graph -> model tables -> likelihood) is
differentiable end to end, so each evaluation is one value-and-gradient
pass and scipy's L-BFGS-B runs on exact gradients.  Bounds are honored
through the sigmoid bijection in ``params``.

On CUDA every length bucket runs the gradient kernel (K2) for value and
gradient and the forward kernel (K1) for value-only calls; a bucket outside
the kernels' envelope raises when the objective is built.  Fisher error bars
come from exact Hessians: on CUDA one Hessian-vector-product kernel (K3)
launch per free parameter and bucket (``hessian_hvp_exact``), on the CPU
second-order autograd of the plain engine over chunks of tracks
(``hessian_chunked``).  On the CPU the plain engine runs throughout.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, Optional

import numpy as np
import scipy.optimize
import torch

from extrack_tpu_torch import data as tdata
from extrack_tpu_torch import device as tdevice
from extrack_tpu_torch import params as tparams
from extrack_tpu_torch.core import engine, tables
from extrack_tpu_torch.ops import forward_kernel, grad_kernel, hvp_kernel
from extrack_tpu_torch.parallel import mesh as pmesh
from extrack_tpu_torch.utils.observe import CheckpointManager


@dataclasses.dataclass
class FitResult:
    params: tparams.Parameters
    logl: float
    success: bool
    n_evals: int
    message: str
    history: list
    std_errors: Optional[Dict[str, float]] = None
    residual: float = 0.0          # -logL, lmfit-style

    def __repr__(self):
        lines = [f"FitResult(logL={self.logl:.4f}, success={self.success}, "
                 f"evals={self.n_evals})"]
        for name, p in self.params.items():
            err = ""
            if self.std_errors and name in self.std_errors:
                err = f" +/- {self.std_errors[name]:.4g}"
            lines.append(f"  {name} = {p.value:.6g}{err}")
        return "\n".join(lines)


def default_window(nb_states: int, nb_substeps: int = 1) -> int:
    """Per-state-count fitting window: 6 / 5 / 4 / 3 for 2 / 3 / 4 / >=5
    states, the reference tutorials' own step-down pattern.  K = S**window
    stays in the low hundreds (2: 64, 3: 243, 4: 256, 5: 125)."""
    w = 6 if nb_states <= 2 else 5 if nb_states == 3 else \
        4 if nb_states == 4 else 3
    return max(w, nb_substeps + 1)


def make_objective(batch,
                   spec: tparams.Parameters,
                   dt,
                   nb_states: int,
                   cell_dims=(1.0,),
                   nb_substeps: int = 1,
                   window: Optional[int] = None,
                   min_len: Optional[int] = None,
                   matrix_type: int = 1,
                   input_loc_err: bool = False,
                   pallas_block: Optional[int] = None,
                   sharded=False,
                   compute_engine: str = "auto") -> Callable:
    """Build -logL(z) over the unconstrained free-parameter tensor z.

    ``batch`` is a TrackBatch or a list of them (length buckets from
    data.from_dict_bucketed), all on one device in one dtype; the objective
    computes on that device in that dtype, and z must match.  Parameter
    extraction happens inside the objective so its gradient flows
    (cum_Proba_Cs, extrack/tracking.py:991-1088); ``min_len`` defaults to
    the shortest track length present (tracking.py:1009).
    ``compute_engine``: 'auto' or 'pallas' run the CUDA kernels on a CUDA
    batch, 'xla' raises there (``tdevice.check_compute_engine``); CPU
    batches run the plain engine whatever the value.  ``pallas_block`` (the
    TPU kernels' track block) is accepted and ignored: the CUDA kernels
    choose their own mapping.

    ``sharded`` (True, or a ``parallel.mesh.Mesh``) splits every bucket
    over the mesh's shards (``mesh.shard_batch``; True: ``mesh.mesh_for``
    the batch's device); each shard builds its tables and runs the kernels
    on its device.  With a process group each process sums its own shards
    and the objective makes ONE all-reduce of [value, z-gradient] per
    evaluation (of the value alone without a gradient), so every process
    returns the same numbers and L-BFGS-B takes the same steps everywhere;
    ``min_len`` then defaults to the shortest length over the group.
    """
    del pallas_block
    if window is None:
        window = default_window(nb_states, nb_substeps)
    batches = list(batch) if isinstance(batch, (list, tuple)) else [batch]
    device = batches[0].positions.device
    dtype = batches[0].positions.dtype
    tdevice.check_compute_engine(compute_engine, device, "make_objective")
    mesh = pmesh.mesh_for(sharded, device) if sharded else None
    if min_len is None:
        min_len = _default_min_len(batches, mesh)
    if device.type == "cuda":
        # the objective takes its gradient through K2 (its value alone
        # through K1, whose envelope is K2's: 65536 slots, 16384 fusion
        # groups)
        for i, b in enumerate(batches):
            forward_kernel.check_envelope(
                b.max_len, b.nb_dims, nb_states, window, nb_substeps,
                variable_dt=b.dt is not None, dtype=dtype,
                what=f"length bucket {i} ({b.batch_size} tracks, "
                     f"T={b.max_len})", kernel="K2")
    units = batches if mesh is None else _local_shards(batches, mesh)

    def local_neg_logl(z: torch.Tensor) -> torch.Tensor:
        # -logL of this process's buckets (or shards)
        values = spec.resolve(spec.from_unconstrained(z))
        total = 0.0
        Fs = None
        for b in units:
            dev = b.positions.device
            Ds, Fs, rates, loc_err, pBL = tparams.extract_arrays(
                values, nb_states,
                input_loc_err=b.loc_err if input_loc_err else None,
                device=dev, dtype=dtype)
            tb = tables.build_tables(
                Ds, loc_err, Fs, rates, pBL,
                b.dt if b.dt is not None else dt, cell_dims=cell_dims,
                nb_substeps=nb_substeps, matrix_type=matrix_type,
                dt_repr=b.dt_repr)
            with pmesh.launch_guard(dev):
                nl = grad_kernel.neg_log_likelihood(
                    b.positions, b.lengths, b.is_bleached, tb, window=window,
                    nb_substeps=nb_substeps, min_len=min_len)
            total = total + nl.to(z.device)
        # reference validity guard (tracking.py:1017): the derived last
        # fraction can go negative at >= 3 states; the finite log floor
        # would otherwise keep such a prior silently unnormalized
        ok = (Fs >= 0).all().to(z.device)
        return torch.where(ok, total, torch.full_like(total, math.inf))

    if mesh is None or mesh.group is None:
        neg_logl = local_neg_logl
    else:
        def neg_logl(z: torch.Tensor) -> torch.Tensor:
            if not (torch.is_grad_enabled() and z.requires_grad):
                with torch.no_grad():
                    v = local_neg_logl(z)
                return mesh.all_reduce(v.double()).to(v.dtype)
            return _AllReducedObjective.apply(z, local_neg_logl, mesh)

    neg_logl.device = device
    neg_logl.dtype = dtype
    neg_logl.batches = batches
    neg_logl.mesh = mesh
    neg_logl.window = window
    neg_logl.min_len = min_len
    return neg_logl


_NO_LEN = 1 << 30


def _default_min_len(batches, mesh) -> int:
    """``tdata.default_min_len`` of the buckets' lengths, over the group
    when the mesh has one (one all-reduce MIN)."""
    lens = np.concatenate([tdata.host_lengths(b) for b in batches])
    real = lens[lens >= 2]
    lo = int(real.min()) if real.size else _NO_LEN
    if mesh is not None and mesh.group is not None:
        lo = int(mesh.all_reduce(torch.tensor([lo]), "min")[0])
    return lo if lo < _NO_LEN else 2


def _local_shards(batches, mesh) -> list:
    """This process's shards of every bucket, bucket by bucket."""
    return [s for b in batches for s in pmesh.shard_batch(b, mesh).shards]


class _AllReducedObjective(torch.autograd.Function):
    """A sharded objective over a process group: this process's value and
    z-gradient, summed over the group in ONE all-reduce (float64), so the
    value and the gradient are the same on every process."""

    @staticmethod
    def forward(ctx, z, local_fn, mesh):
        with torch.enable_grad():
            zl = z.detach().requires_grad_(True)
            v = local_fn(zl)
            (g,) = torch.autograd.grad(v, zl)
        vg = mesh.all_reduce(torch.cat([v.detach().reshape(1),
                                        g.to(v.dtype)]).double())
        ctx.save_for_backward(vg[1:].to(z.dtype))
        return vg[0].to(v.dtype)

    @staticmethod
    def backward(ctx, gout):
        (g,) = ctx.saved_tensors
        return gout * g, None, None


def fit(batch,
        spec: tparams.Parameters,
        dt,
        nb_states: int,
        cell_dims=(1.0,),
        nb_substeps: int = 1,
        window: Optional[int] = None,
        min_len: Optional[int] = None,
        matrix_type: int = 1,
        input_loc_err: bool = False,
        method: str = "L-BFGS-B",
        verbose: int = 0,
        max_iter: int = 500,
        compute_errors: bool = False,
        sharded=False,
        callback=None,
        checkpoint_path: Optional[str] = None,
        resume: bool = True,
        n_starts: int = 1,
        start_scale: float = 1.0,
        seed: int = 0,
        compute_engine: str = "auto") -> FitResult:
    """Fit the free parameters of ``spec`` to a TrackBatch (or buckets).

    callback: called as ``callback(n_eval, objective, values)`` per
        evaluation.
    checkpoint_path: JSON checkpoint written on every improvement; with
        ``resume=True`` an existing checkpoint warm-starts the fit.
    n_starts: run the optimizer from the initial values plus ``n_starts-1``
        perturbed restarts (scale ``start_scale`` in unconstrained space)
        and keep the best optimum.
    Gradient-free methods (Powell, Nelder-Mead, COBYLA) evaluate the value
    only.
    compute_engine: 'auto' or 'pallas' run the CUDA kernels on a CUDA
        batch; 'xla' raises there (``tdevice.check_compute_engine``).
        CPU batches run the plain engine whatever the value.
    sharded: True or a ``parallel.mesh.Mesh`` shards the objective
        (``make_objective``) and the Hessian of the error bars
        (``hessian_hvp_exact`` on the card, ``hessian_chunked`` on the CPU,
        each process over its own shards, then one all-reduce).
    """
    first = batch[0] if isinstance(batch, (list, tuple)) else batch
    tdevice.check_compute_engine(compute_engine, first.positions.device,
                                  "fit")
    ckpt = CheckpointManager(checkpoint_path) if checkpoint_path else None
    state = ckpt.load() if ckpt and resume else None
    if state is not None:
        spec = spec.copy()
        spec.set_values(state["values"])
    neg_logl = make_objective(batch, spec, dt, nb_states, cell_dims,
                              nb_substeps, window, min_len, matrix_type,
                              input_loc_err, sharded=sharded,
                              compute_engine=compute_engine)
    device, dtype = neg_logl.device, neg_logl.dtype

    def as_z(z, grad=False):
        return torch.tensor(np.asarray(z), dtype=dtype, device=device,
                            requires_grad=grad)

    z0 = spec.to_unconstrained()
    history = []
    n_evals = [0]
    best = [np.inf]

    def record(z, v):
        n_evals[0] += 1
        history.append(v)
        if callback or ckpt or verbose:
            with torch.no_grad():
                vals = {k: float(x) for k, x in
                        spec.resolve(spec.from_unconstrained(as_z(z))).items()
                        if np.ndim(x) == 0}
            if callback:
                callback(n_evals[0], v, vals)
            if ckpt and v < best[0]:
                best[0] = v
                ckpt.save(vals, v, n_evals[0])
            if verbose:
                print(-v, {k: round(x, 6) for k, x in vals.items()})

    def fun(z):
        zt = as_z(z, grad=True)
        value = neg_logl(zt)
        (g,) = torch.autograd.grad(value, zt)
        v = float(value.detach())
        g = g.detach().cpu().numpy().astype(np.float64)
        if not np.isfinite(v):
            # out-of-domain guard, mirrors the reference's inf objective
            # (extrack/tracking.py:1078-1086)
            return 1e300, np.zeros_like(g)
        record(z, v)
        return v, g

    def value_only(z):
        with torch.no_grad():
            v = float(neg_logl(as_z(z)))
        if not np.isfinite(v):
            return 1e300
        record(z, v)
        return v

    if method.lower() in ("powell", "nelder-mead", "cobyla"):
        def run_opt(z_init):
            return scipy.optimize.minimize(value_only, z_init, method=method,
                                           options={"maxiter": max_iter})
    else:
        def run_opt(z_init):
            return scipy.optimize.minimize(fun, z_init, jac=True,
                                           method=method,
                                           options={"maxiter": max_iter})

    t0 = time.time()
    res = run_opt(z0)
    if n_starts > 1:
        rng = np.random.default_rng(seed)
        for _ in range(n_starts - 1):
            alt = run_opt(z0 + rng.normal(0, start_scale, z0.shape))
            if np.isfinite(alt.fun) and alt.fun < res.fun:
                res = alt
    if verbose:
        print(f"fit: {n_evals[0]} evaluations in {time.time() - t0:.2f}s")

    fitted = spec.copy()
    with torch.no_grad():
        values = fitted.resolve(fitted.from_unconstrained(
            torch.as_tensor(res.x, dtype=torch.float64)))
    fitted.set_values({k: float(v) for k, v in values.items()
                       if np.ndim(v) == 0})

    std_errors = None
    if compute_errors:
        kw = dict(cell_dims=cell_dims, nb_substeps=nb_substeps,
                  window=neg_logl.window, min_len=neg_logl.min_len,
                  matrix_type=matrix_type, input_loc_err=input_loc_err)
        mesh = neg_logl.mesh
        if device.type == "cuda":
            H = hessian_hvp_exact(neg_logl.batches, spec, res.x, dt,
                                  nb_states, sharded=mesh or False, **kw)
        elif mesh is None:
            H = hessian_chunked(neg_logl.batches, spec, res.x, dt,
                                nb_states, **kw)
        else:
            H = _all_reduce_np(hessian_chunked(
                _local_shards(neg_logl.batches, mesh), spec, res.x, dt,
                nb_states, **kw), mesh)
        std_errors = fisher_errors_from_hessian(H, fitted, res.x)
    return FitResult(params=fitted, logl=-float(res.fun),
                     success=bool(res.success), n_evals=n_evals[0],
                     message=str(res.message), history=history,
                     std_errors=std_errors, residual=float(res.fun))


def _tables_fn(b, spec, dt, nb_states, cell_dims, nb_substeps, matrix_type,
               input_loc_err):
    """z -> ModelTables of bucket ``b``, on its device in its dtype."""
    device, dtype = b.positions.device, b.positions.dtype

    def tables_fn(z):
        values = spec.resolve(spec.from_unconstrained(z))
        Ds, Fs, rates, loc_err, pBL = tparams.extract_arrays(
            values, nb_states,
            input_loc_err=b.loc_err if input_loc_err else None,
            device=device, dtype=dtype)
        return tables.build_tables(
            Ds, loc_err, Fs, rates, pBL, b.dt if b.dt is not None else dt,
            cell_dims=tuple(cell_dims), nb_substeps=nb_substeps,
            matrix_type=matrix_type, dt_repr=b.dt_repr)
    return tables_fn


def hessian_hvp_columns(batches, spec: tparams.Parameters, z_opt, dt,
                        nb_states: int, *, cell_dims=(1.0,), nb_substeps=1,
                        window=6, min_len=3, matrix_type=1,
                        input_loc_err=False) -> np.ndarray:
    """Observed-information Hessian of -logL at z_opt, one exact column
    per free parameter and bucket, not symmetrised.

    Over z, H = J_t^T H_t J_t + d(J_t^T g)/dz, with J_t the Jacobian of
    z -> tables and g, H_t the gradient and Hessian of -logL w.r.t. the
    tables.  Column j of the first term is one ``hvp_kernel.table_hvp``
    along J_t e_j (one K3 launch for a CUDA bucket, the plain double
    backward for a CPU one); J_t and the second term (g is the same for
    every column) are plain autograd of z -> tables.  A CUDA bucket outside
    the kernels' envelope raises, naming the bucket."""
    device = batches[0].positions.device
    dtype = batches[0].positions.dtype
    z0 = torch.as_tensor(np.asarray(z_opt), dtype=dtype, device=device)
    n = int(z0.shape[0])
    H = torch.zeros((n, n), dtype=torch.float64, device=device)
    for i, b in enumerate(batches):
        dev = b.positions.device
        if dev.type == "cuda":
            forward_kernel.check_envelope(
                b.max_len, b.nb_dims, nb_states, window, nb_substeps,
                variable_dt=b.dt is not None, dtype=dtype,
                what=f"length bucket {i} ({b.batch_size} tracks, "
                     f"T={b.max_len})", kernel="K3")
        tables_fn = _tables_fn(b, spec, dt, nb_states, cell_dims,
                               nb_substeps, matrix_type, input_loc_err)
        z = z0.to(dev)
        with torch.no_grad():
            tb = tables.ModelTables(*(f.detach() for f in tables_fn(z)))
        # J_t column by column, one JVP per free parameter: with variable
        # dt sig2 is per track and step, and reverse mode would take one
        # pass per entry
        eye = torch.eye(n, dtype=dtype, device=dev)
        cols = [torch.autograd.functional.jvp(
            lambda z_: tuple(tables_fn(z_)), z, eye[j])[1] for j in range(n)]
        jac = [torch.stack(c, dim=-1) for c in zip(*cols)]  # (*shape, n)
        for j in range(n):
            with pmesh.launch_guard(dev):
                _, g, hv = hvp_kernel.table_hvp(
                    b.positions, b.lengths, b.is_bleached, tb,
                    tables.ModelTables(*(J[..., j] for J in jac)),
                    window=window, nb_substeps=nb_substeps, min_len=min_len)
            H[:, j] += sum(torch.einsum("...i,...->i", J, hv[k]).double()
                           for k, J in zip(tb._fields, jac)).to(device)
        H += torch.autograd.functional.hessian(
            lambda z_: sum((f * g[k]).sum() for k, f in
                           zip(tb._fields, tables_fn(z_))), z
        ).double().to(device)
    return H.cpu().numpy()


def hessian_hvp_exact(batches, spec: tparams.Parameters, z_opt, dt,
                      nb_states: int, *, cell_dims=(1.0,), nb_substeps=1,
                      window=6, min_len=3, matrix_type=1,
                      input_loc_err=False, pallas_flags=None,
                      has_len2s=None, sharded=False,
                      block: int = 512) -> np.ndarray:
    """``hessian_hvp_columns`` symmetrised, 0.5 (H + H^T): the Hessian
    fit(compute_errors=True) uses on CUDA.  ``pallas_flags``, ``has_len2s``
    and ``block`` (the TPU kernels' per-bucket choices and track block) are
    accepted and ignored: every CUDA bucket runs K3, and a CPU bucket the
    plain double backward.

    ``sharded`` (True or a ``parallel.mesh.Mesh``): the Hessian is
    additive over tracks, so each process runs K3 on its own shards of
    every bucket (``mesh.shard_batch``) and the assembled matrices sum in
    one all-reduce.  The JAX package refuses a sharded exact Hessian and
    falls back to central differences; K3 covers K2's whole envelope, so
    the port has no such fallback."""
    del pallas_flags, has_len2s, block
    mesh = (pmesh.mesh_for(sharded, batches[0].positions.device)
            if sharded else None)
    H = hessian_hvp_columns(
        batches if mesh is None else _local_shards(batches, mesh), spec,
        z_opt, dt, nb_states, cell_dims=cell_dims, nb_substeps=nb_substeps,
        window=window, min_len=min_len, matrix_type=matrix_type,
        input_loc_err=input_loc_err)
    if mesh is not None:
        H = _all_reduce_np(H, mesh)
    return 0.5 * (H + H.T)


def _all_reduce_np(H: np.ndarray, mesh) -> np.ndarray:
    """A float64 host array summed over the mesh's process group."""
    return mesh.all_reduce(torch.as_tensor(H)).numpy()


def hessian_chunked(batches, spec: tparams.Parameters, z_opt, dt,
                    nb_states: int, *, cell_dims=(1.0,), nb_substeps=1,
                    window=6, min_len=3, matrix_type=1,
                    input_loc_err=False, chunk: int = 65536) -> np.ndarray:
    """Observed-information Hessian of -logL at z_opt by second-order
    autograd of the plain engine, accumulated over chunks of ``chunk``
    tracks: logL is additive over tracks, so memory stays O(chunk) at any
    dataset size."""
    device = batches[0].positions.device
    dtype = batches[0].positions.dtype
    z = torch.as_tensor(np.asarray(z_opt), dtype=dtype, device=device)
    if min_len is None:
        min_len = tdata.default_min_len(
            np.concatenate([tdata.host_lengths(b) for b in batches]))
    H = np.zeros((len(z), len(z)))
    for b in batches:
        for start in range(0, b.batch_size, chunk):
            sl = slice(start, start + chunk)
            part = tdata.TrackBatch(
                b.positions[sl], b.lengths[sl],
                None if b.loc_err is None else b.loc_err[sl],
                b.is_bleached[sl], dt=None if b.dt is None else b.dt[sl],
                dt_repr=b.dt_repr)
            tables_fn = _tables_fn(part, spec, dt, nb_states, cell_dims,
                                   nb_substeps, matrix_type, input_loc_err)

            def nl(z_, _b=part, _fn=tables_fn):
                return -engine.forward(
                    _b.positions, _b.lengths, _b.is_bleached, _fn(z_),
                    window=window, nb_substeps=nb_substeps,
                    min_len=min_len).sum()
            H += torch.autograd.functional.hessian(nl, z).detach().cpu(
            ).numpy().astype(np.float64)
    return H


def fisher_errors_from_hessian(H: np.ndarray, spec: tparams.Parameters,
                               z_opt) -> Dict[str, float]:
    """Standard errors of the free natural parameters from a Hessian in
    unconstrained space: cov = J H^-1 J^T with J the bijection Jacobian
    (pinv when H is singular)."""
    z = torch.as_tensor(np.asarray(z_opt), dtype=torch.float64)

    def natural(z_):
        vals = spec.from_unconstrained(z_)
        return torch.stack([vals[n] * torch.ones((), dtype=torch.float64)
                            for n in spec.free_names()])

    J = torch.autograd.functional.jacobian(natural, z).numpy()
    try:
        cov_z = np.linalg.inv(H)
    except np.linalg.LinAlgError:
        cov_z = np.linalg.pinv(H)
    cov = J @ cov_z @ J.T
    var = np.clip(np.diag(cov), 0.0, np.inf)
    return {n: float(np.sqrt(v)) for n, v in zip(spec.free_names(), var)}


def fisher_errors(neg_logl, spec: tparams.Parameters,
                  z_opt) -> Dict[str, float]:
    """Parameter standard errors from the inverse observed Fisher
    information, by second-order autograd of ``neg_logl`` (an objective of
    ``make_objective``) at z_opt.  Its CUDA kernels are once
    differentiable, so on the card use ``hessian_hvp_exact`` +
    ``fisher_errors_from_hessian`` (what fit() does)."""
    z = torch.as_tensor(np.asarray(z_opt), dtype=neg_logl.dtype,
                        device=neg_logl.device)
    H = torch.autograd.functional.hessian(neg_logl, z)
    return fisher_errors_from_hessian(
        H.detach().cpu().numpy().astype(np.float64), spec, z_opt)


def param_fitting(all_tracks,
                  dt,
                  params: Optional[tparams.Parameters] = None,
                  nb_states: int = 2,
                  nb_substeps: int = 1,
                  frame_len: Optional[int] = None,
                  verbose: int = 1,
                  workers: int = 1,
                  Matrix_type: int = 1,
                  method: str = "L-BFGS-B",
                  steady_state: bool = False,
                  cell_dims=(1.0,),
                  input_LocErr=None,
                  threshold: float = 0.2,
                  max_nb_states: int = 120,
                  compute_errors: bool = False,
                  sharded: bool = False,
                  length_buckets: int = 4,
                  *,
                  device="cuda",
                  dtype=None,
                  **fit_kwargs) -> FitResult:
    """Drop-in style equivalent of the reference param_fitting
    (extrack/tracking.py:1299-1387), on ``device`` in ``dtype``.  The
    device defaults to the card and raises without one; ``device="cpu"``
    runs the plain engine.  ``dtype`` defaults to float32 on CUDA, where
    the kernels compute in float32 and raise for any other dtype, and to
    float64 elsewhere.

    ``all_tracks`` is the length-keyed dict format.  ``workers``,
    ``threshold`` and ``max_nb_states`` are accepted for API compatibility:
    the engine's fixed window (``frame_len``, default per state count,
    ``default_window``) replaces the reference's threshold pruning.
    """
    del workers, threshold, max_nb_states
    device, dtype = tdevice.resolve_device(device, dtype)
    if params is None:
        params = tparams.generate_params(
            nb_states=nb_states, LocErr_type=1, LocErr_bounds=(0.005, 0.1),
            D_max=3.0, estimated_transition_rates=0.1,
            steady_state=steady_state)
    batch = tdata.from_dict_bucketed(
        all_tracks, max_buckets=max(1, length_buckets),
        input_loc_err=input_LocErr,
        dt=dt if isinstance(dt, dict) else None, device=device, dtype=dtype)
    return fit(batch, params, dt if not isinstance(dt, dict) else 0.0,
               nb_states, cell_dims=cell_dims, nb_substeps=nb_substeps,
               window=frame_len, matrix_type=Matrix_type, method=method,
               verbose=verbose, input_loc_err=input_LocErr is not None,
               compute_errors=compute_errors, sharded=sharded, **fit_kwargs)
