"""Bayesian posterior sampling for the diffusion-state model (HMC).

Beyond the reference's surface (point MLE + Fisher errors,
extrack/tracking.py:1299-1387 and the tutorial's notebook-level error
analysis): full posterior samples over {LocErr, D_i, F_i, p_ij, pBL},
using the SAME likelihood the fit optimizes.  On the card every
leapfrog step is one value-and-gradient of the objective: one launch of
the gradient kernel K2 per length bucket, so a thousand posterior draws
cost about a thousand optimizer evaluations.

Each chain (dual-averaging step-size warmup, diagonal mass-matrix
estimation, then the sampling phase) runs as a host loop over
iterations; the accept/reject decision, the dual-averaging statistics and
the variance window stay on the device as tensors, so an iteration reads
nothing back to the host.  Chains run one after another, each from its
own ``torch.Generator`` (seed ``seed + 1000003 * c``); their launches per
gradient are C x buckets.  Samples are copied to the host every
``dispatch_chunk`` iterations; the draws do not depend on the chunking.
With the gradient re-evaluated at each trajectory's start point (as
``_leapfrog`` does) a run launches K2

    C x buckets x (1 + (steps_a + steps_b + num_samples) x (n_leapfrog + 1))

times (``steps_a + steps_b`` is ``num_warmup`` for num_warmup >= 2; the 1
is each chain's start energy), and no other kernel.

When the warm-start fit's Fisher errors are passed (``fisher_sd``) they
precondition the warmup metric and the start spread: without this, large
datasets make the posterior sharp enough that identity-metric warmup
never brings the over-dispersed chains together.

The target density is the likelihood times a flat prior on the BOUNDED
parameters: sampling runs in the fit's unconstrained space z, so the
bijections' log-Jacobian (params.Parameters.unconstrained_log_jacobian)
is added to keep the flat prior flat after the change of variables.
Improper posteriors this can produce for truly unbounded parameters are
the user's usual responsibility (the default parameter bounds are all
finite except via generate_params' explicit choices).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from extrack_tpu_torch import data as tdata
from extrack_tpu_torch import device as tdevice
from extrack_tpu_torch import fit as tfit
from extrack_tpu_torch import params as tparams


@dataclass
class SampleResult:
    """Posterior samples in CONSTRAINED (physical) parameter space.

    samples: name -> (num_chains, num_samples) array; free parameters
    only (expr-derived quantities can be recomputed via spec.resolve).
    """
    samples: Dict[str, np.ndarray]
    accept_rate: float
    step_size: float
    mass: np.ndarray
    rhat: Dict[str, float] = field(default_factory=dict)
    ess: Dict[str, float] = field(default_factory=dict)

    def summary(self) -> str:
        rows = [f"{'param':>14}  {'mean':>10}  {'std':>10}  {'5%':>10}  "
                f"{'95%':>10}  {'R-hat':>6}  {'ESS':>7}"]
        for n, s in self.samples.items():
            flat = s.reshape(-1)
            q5, q95 = np.quantile(flat, [0.05, 0.95])
            rows.append(
                f"{n:>14}  {flat.mean():10.5g}  {flat.std():10.4g}  "
                f"{q5:10.5g}  {q95:10.5g}  "
                f"{self.rhat.get(n, float('nan')):6.3f}  "
                f"{self.ess.get(n, float('nan')):7.1f}")
        rows.append(f"acceptance {self.accept_rate:.2f}, "
                    f"step size {self.step_size:.3g}")
        return "\n".join(rows)


def _leapfrog(vg, z, p, inv_mass, eps, n_steps, data):
    """n_steps of leapfrog on H = U(z) + 0.5 p^T M^-1 p; ``vg(z, data)``
    returns (U(z), dU/dz)."""
    g = vg(z, data)[1]
    u = None
    for _ in range(n_steps):
        p_half = p - 0.5 * eps * g
        z = z + eps * inv_mass * p_half
        u, g = vg(z, data)
        p = p_half - 0.5 * eps * g
    return z, p, u, g


def _hmc_kernels(vg, *, n_leapfrog, target_accept, jitter, dim, dtype):
    """The HMC pieces of one chain.

    Warmup runs in two phases: (A) dual-averaging step-size adaptation
    (Hoffman & Gelman 2014, sec. 3.2) at the start metric, estimating the
    posterior variance over its second half; (B) re-adaptation under the
    new diagonal mass (a step size tuned for one metric does not transfer
    to another).  Then the sampling phase with both frozen.

    Each piece runs ``steps`` iterations from an explicit carry, drawing
    from the chain's generator, so sampling split into chunks gives the
    same draws as one run.

    ``jitter`` randomizes the per-iteration step size by a uniform factor
    in [1-jitter, 1+jitter], which jitters the TRAJECTORY LENGTH
    eps*n_leapfrog: the standard fixed-compute-cost guard against
    periodic-orbit resonance.
    """
    def kinetic(p, inv_mass):
        return 0.5 * torch.sum(p * p * inv_mass)

    def hmc_step(z, u, gen, eps, inv_mass, data):
        dev = z.device
        eps = eps * (1.0 - jitter + 2.0 * jitter * torch.rand(
            (), generator=gen, dtype=dtype, device=dev))
        p = torch.randn(dim, generator=gen, dtype=dtype,
                        device=dev) / torch.sqrt(inv_mass)
        z_new, p_new, u_new, _ = _leapfrog(vg, z, p, inv_mass, eps,
                                           n_leapfrog, data)
        h0 = u + kinetic(p, inv_mass)
        h1 = u_new + kinetic(p_new, inv_mass)
        # a non-finite energy (the objective's validity guard, an
        # overflow) rejects the proposal
        log_acc = torch.where(torch.isfinite(h1),
                              torch.clamp(h0 - h1, max=0.0),
                              torch.full_like(h1, -math.inf))
        accept = torch.log(torch.rand((), generator=gen, dtype=dtype,
                                      device=dev)) < log_acc
        return (torch.where(accept, z_new, z), torch.where(accept, u_new, u),
                torch.exp(log_acc))

    def warm_phase(carry, data, inv_mass, mu, collect_from, steps, gen):
        """A warmup phase of ``steps`` iterations, collecting the variance
        window from iteration ``collect_from`` on; carry = (z, u, log_eps,
        log_eps_bar, h_bar, s1, s2, n)."""
        z, u, log_eps, log_eps_bar, h_bar, s1, s2, n = carry
        for i in range(steps):
            z, u, alpha = hmc_step(z, u, gen, torch.exp(log_eps), inv_mass,
                                   data)
            t = i + 1.0
            h_bar = (1.0 - 1.0 / (t + 10.0)) * h_bar \
                + (target_accept - alpha) / (t + 10.0)
            log_eps = mu - math.sqrt(t) / 0.05 * h_bar
            w = t ** -0.75
            log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
            if i >= collect_from:
                s1, s2, n = s1 + z, s2 + z * z, n + 1.0
        return z, u, log_eps, log_eps_bar, h_bar, s1, s2, n

    def samp_chunk(carry, data, eps, inv_mass, steps, gen):
        """``steps`` sampling iterations; carry = (z, u).  Returns the carry
        and the (steps, dim) positions and (steps,) acceptance
        probabilities, on the device."""
        z, u = carry
        zs, alphas = [], []
        for _ in range(steps):
            z, u, alpha = hmc_step(z, u, gen, eps, inv_mass, data)
            zs.append(z)
            alphas.append(alpha)
        return (z, u), (torch.stack(zs), torch.stack(alphas))

    return warm_phase, samp_chunk


def _hmc_chain(vg, z0, data, generator, *, num_warmup, num_samples,
               n_leapfrog, target_accept, init_step, jitter=0.2,
               inv_mass0=None, dispatch_chunk=None):
    """One chain from z0: (samples (num_samples, dim) on the host, mean
    acceptance probability, step size, inverse mass), the last three
    tensors on z0's device.  ``inv_mass0`` is phase A's metric (identity
    when None); ``dispatch_chunk`` the sampling iterations between copies
    of the samples to the host (all at once when None)."""
    dim, dtype = z0.shape[0], z0.dtype
    warm_phase, samp_chunk = _hmc_kernels(
        vg, n_leapfrog=n_leapfrog, target_accept=target_accept,
        jitter=jitter, dim=dim, dtype=dtype)
    chunk = dispatch_chunk or max(num_samples, 1)

    def phase(z, u, inv_mass, steps, eps0, collect_from):
        log_eps0 = torch.log(eps0)
        zero = torch.zeros((), dtype=dtype, device=z.device)
        carry = (z, u, log_eps0, log_eps0, zero, torch.zeros_like(z),
                 torch.zeros_like(z), zero)
        carry = warm_phase(carry, data, inv_mass, math.log(10.0) + log_eps0,
                           collect_from, steps, generator)
        n = torch.clamp(carry[7], min=2.0)
        var = torch.clamp(carry[6] / n - (carry[5] / n) ** 2, min=0.0)
        return carry[0], carry[1], torch.exp(carry[3]), var

    u0 = vg(z0, data)[0]
    steps_a = max(2 * num_warmup // 3, 1)
    steps_b = max(num_warmup - steps_a, 1)
    if inv_mass0 is None:
        inv_mass0 = torch.ones_like(z0)
    z, u, eps_a, var = phase(
        z0, u0, inv_mass0, steps_a,
        torch.as_tensor(init_step, dtype=dtype, device=z0.device),
        steps_a // 2)
    inv_mass = torch.clamp(var, 1e-6, 1e6)
    z, u, eps, _ = phase(z, u, inv_mass, steps_b, eps_a, steps_b + 1)
    zs, alphas = [], []
    carry = (z, u)
    for start in range(0, num_samples, chunk):
        carry, (zs_c, al_c) = samp_chunk(
            carry, data, eps, inv_mass, min(chunk, num_samples - start),
            generator)
        zs.append(zs_c.cpu())
        alphas.append(al_c)
    return (torch.cat(zs), torch.cat(alphas).mean(), eps, inv_mass)


def _split_rhat(x: np.ndarray) -> float:
    """Split-chain R-hat of (chains, samples)."""
    c, n = x.shape
    if n < 4:
        return float("nan")
    halves = x[:, : (n // 2) * 2].reshape(c * 2, n // 2)
    m, s = halves.mean(1), halves.var(1, ddof=1)
    w = s.mean()
    b = halves.shape[1] * m.var(ddof=1)
    if w <= 0:
        return float("nan")
    return float(np.sqrt((halves.shape[1] - 1) / halves.shape[1]
                         + b / (w * halves.shape[1])))


def _ess(x: np.ndarray) -> float:
    """Bulk effective sample size of (chains, samples) via pairwise
    autocorrelation sums (Geyer initial positive sequence)."""
    c, n = x.shape
    if n < 4:
        return float("nan")
    xc = x - x.mean(axis=1, keepdims=True)
    acov = np.stack([np.correlate(r, r, mode="full")[n - 1:] / n
                     for r in xc]).mean(0)
    if acov[0] <= 0:
        return float("nan")
    rho = acov / acov[0]
    tau = 1.0
    for k in range(1, n - 2, 2):
        pair = rho[k] + rho[k + 1]
        if pair < 0:
            break
        tau += 2.0 * pair
    return float(c * n / tau)


def _fisher_sd_z(spec: tparams.Parameters, z0: np.ndarray,
                 fisher_sd: Optional[Dict[str, float]]) -> np.ndarray:
    """Physical standard errors -> z-space sds through the per-coordinate
    bijection Jacobian at z0 (sd_z = sd_theta / |dtheta/dz|), in closed
    form (the cases of params._logdet_from_z); 1 where an entry is
    missing, zero (pinned at a bound) or not finite."""
    sd_z = np.ones(len(z0))
    if not fisher_sd:
        return sd_z
    for i, n in enumerate(spec.free_names()):
        se = fisher_sd.get(n)
        if se is None or not np.isfinite(se) or se <= 0:
            continue
        p = spec._params[n]
        lo, hi, zi = p.min, p.max, z0[i]
        if np.isinf(lo) and np.isinf(hi):
            g = 1.0
        elif np.isinf(hi):
            g = np.exp(zi)
        elif np.isinf(lo):
            g = np.exp(-zi)
        else:
            sig = np.clip(1.0 / (1.0 + np.exp(-zi)), 1e-14, 1.0 - 1e-14)
            g = (hi - lo) * sig * (1.0 - sig)
        if np.isfinite(g) and g > 0:
            sd_z[i] = float(np.clip(se / g, 1e-12, 1e6))
    return sd_z


def sample_posterior(all_tracks: Dict[str, np.ndarray],
                     dt,
                     params: Optional[tparams.Parameters] = None,
                     nb_states: int = 2,
                     *,
                     num_samples: int = 1000,
                     num_warmup: int = 500,
                     num_chains: int = 2,
                     n_leapfrog: int = 24,
                     target_accept: float = 0.8,
                     init_step: float = 0.05,
                     jitter: float = 0.2,
                     seed: int = 0,
                     cell_dims=(0.5, None, None),
                     nb_substeps: int = 1,
                     window: Optional[int] = None,
                     min_len: Optional[int] = None,
                     matrix_type: int = 1,
                     input_LocErr=None,
                     max_buckets: int = 4,
                     sharded=False,
                     dispatch_chunk: int = 256,
                     fisher_sd: Optional[Dict[str, float]] = None,
                     init_spread: float = 0.1,
                     verbose: int = 0,
                     device="cuda",
                     dtype=None) -> SampleResult:
    """HMC posterior samples for the model parameters on a track dataset,
    on ``device`` in ``dtype``.

    Same dataset/model arguments as ``fit.param_fitting``; ``params``
    (its values = the chains' start point: run a fit first for a warm
    start) defaults to ``generate_params(nb_states)``.  Flat priors on
    the bounded parameters; fixed (vary=False) and expr-derived
    parameters stay fixed/derived exactly as in the fit.  The device
    defaults to the card and raises without one; ``device="cpu"`` runs the
    plain engine.  ``dtype`` defaults to float32 on the card (the kernels'
    dtype; the energy difference of a proposal over 10^4 tracks keeps
    fewer digits there) and float64 elsewhere.

    Returns a SampleResult with per-parameter samples in physical space,
    split-chain R-hat and effective sample sizes.

    ``dispatch_chunk`` bounds the iterations whose samples stay on the
    device before one copy to the host.  Results are identical for any
    chunking.

    ``fisher_sd`` (name -> standard error in PHYSICAL space, e.g.
    ``fit(..., compute_errors=True).std_errors``) preconditions the
    sampler: converted to unconstrained space through the bijection
    Jacobian at the start point, it seeds the warmup's mass metric and
    scales the over-dispersed start spread (``init_spread`` posterior
    sds instead of ``init_spread`` absolute units).  Large datasets make
    the posterior arbitrarily sharp in z, and identity-mass warmup from
    fixed-width starts then leaves chains stranded far apart.  Entries
    that are missing, zero (pinned at a bound), or non-finite keep the
    identity metric for that coordinate.  ``sharded`` (True, or a
    ``parallel.mesh.Mesh``) runs the sharded objective
    (``fit.make_objective``): with a process group every process draws
    from the same seeds and gets the same all-reduced potential and
    gradient, so every chain's accept/reject agrees across processes.
    """
    if dispatch_chunk < 1:
        raise ValueError(
            f"dispatch_chunk must be >= 1, got {dispatch_chunk}")
    if num_chains < 1:
        raise ValueError(f"num_chains must be >= 1, got {num_chains}")
    if not 0.0 <= jitter < 1.0:
        raise ValueError(f"jitter must be in [0, 1), got {jitter}")
    device, dtype = tdevice.resolve_device(device, dtype)
    if params is None:
        params = tparams.generate_params(nb_states=nb_states,
                                         nb_dims=2, LocErr_type=1)
    spec = params
    batches = tdata.from_dict_bucketed(
        all_tracks, max_buckets=max_buckets, input_loc_err=input_LocErr,
        dt=dt if isinstance(dt, dict) else None, device=device, dtype=dtype)
    neg_logl = tfit.make_objective(
        batches, spec, dt if not isinstance(dt, dict) else 0.0, nb_states,
        cell_dims=cell_dims, nb_substeps=nb_substeps, window=window,
        min_len=min_len, matrix_type=matrix_type,
        input_loc_err=input_LocErr is not None, sharded=sharded)

    def vg(z, data):
        # U = -log posterior = neg_logl - log|dtheta/dz| (flat prior); on
        # a CUDA batch its gradient is one K2 launch per bucket
        del data
        z = z.detach().requires_grad_(True)
        u = neg_logl(z) - spec.unconstrained_log_jacobian(z)
        (g,) = torch.autograd.grad(u, z)
        return u.detach(), g

    z0_np = spec.to_unconstrained()
    z0 = torch.as_tensor(z0_np, dtype=dtype, device=device)
    names = spec.free_names()
    sd_z = torch.as_tensor(_fisher_sd_z(spec, z0_np, fisher_sd),
                           dtype=dtype, device=device)
    zs, accs, epss, inv_masses = [], [], [], []
    for c in range(num_chains):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed + 1000003 * c)
        # over-dispersed start (in posterior sds when preconditioned);
        # phase A starts from the Fisher metric (identity when none
        # given): inv_mass tracks the posterior VARIANCE, so seed it with
        # sd_z^2
        z_start = z0 + init_spread * sd_z * torch.randn(
            z0.shape, generator=gen, dtype=dtype, device=device)
        zs_c, acc, eps, inv_mass = _hmc_chain(
            vg, z_start, None, gen, num_warmup=num_warmup,
            num_samples=num_samples, n_leapfrog=n_leapfrog,
            target_accept=target_accept, init_step=init_step, jitter=jitter,
            inv_mass0=sd_z * sd_z, dispatch_chunk=dispatch_chunk)
        zs.append(zs_c)
        accs.append(float(acc))
        epss.append(float(eps))
        inv_masses.append(inv_mass.cpu().double().numpy())
        if verbose:
            print(f"chain {c}: acceptance {accs[-1]:.2f}, "
                  f"step size {epss[-1]:.3g}")

    z_arr = torch.stack(zs)                      # (chains, samples, dim)
    samples: Dict[str, np.ndarray] = {}
    for i, n in enumerate(names):
        p = spec._params[n]
        samples[n] = tparams._from_z(z_arr[..., i], p.min, p.max).numpy()
    rhat = {n: _split_rhat(samples[n]) for n in names}
    ess = {n: _ess(samples[n]) for n in names}
    inv_mass = np.mean(inv_masses, axis=0)
    return SampleResult(samples=samples,
                        accept_rate=float(np.mean(accs)),
                        step_size=float(np.mean(epss)),
                        mass=1.0 / np.maximum(inv_mass, 1e-300),
                        rhat=rhat, ess=ess)
