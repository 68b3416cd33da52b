"""Automated fitting workflows: hyper-parameter heuristics, iterated refits
and model selection over the number of states.

The reference ships auto_fitting.py (heuristics choosing ``nb_substeps`` and
``frame_len`` from the fitted diffusion-length-to-LocErr ratio, DLR, and the
transition frequency, auto_fitting.py:14-37) but it calls an API that no
longer exists and is commented out of the package (extrack/__init__.py:4).
This module is the JAX package's working equivalent
(``extrack_tpu/auto_fitting.py``), plus its model-selection scan: fit an
increasing number of states and compare penalized likelihoods.  Every fit
is ``fit.param_fitting`` on ``device`` (the card by default: K2 for each
gradient); the heuristic's cap (S^W <= 1024) is the JAX package's own
register budget, well inside K2's envelope of 65536 slots.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from extrack_tpu_torch import fit as tfit
from extrack_tpu_torch import params as tparams


def choose_hyperparams(values: Dict[str, float], dt: float,
                       nb_states: int) -> Dict[str, int]:
    """Pick (nb_substeps, frame_len) from fitted parameters.

    Heuristics in the spirit of the reference DLR logic (auto_fitting.py:
    14-37): the diffusion-length-to-LocErr ratio decides how much history a
    window must carry (low DLR = positions are informative about old states
    for longer), and high transition rates per frame warrant sub-steps.
    """
    loc_err = float(values.get("LocErr", values.get("LocErr0", 0.02)))
    d_max = max(float(values[f"D{s}"]) for s in range(nb_states))
    dlr = np.sqrt(2.0 * d_max * dt) / max(loc_err, 1e-9)
    rates = [float(values[k]) for k in values
             if k.startswith("p") and k not in ("pBL",) and len(k) == 3]
    max_rate = max(rates) if rates else 0.1

    if dlr > 2.0:
        frame_len = 4
    elif dlr > 1.2:
        frame_len = 5
    elif dlr > 0.7:
        frame_len = 6
    else:
        frame_len = 7
    # budget: cap the register at ~nb_states**frame_len <= 1024
    while nb_states ** frame_len > 1024 and frame_len > 2:
        frame_len -= 1
    nb_substeps = 2 if max_rate > 0.25 else 1
    return {"frame_len": frame_len, "nb_substeps": nb_substeps}


@dataclasses.dataclass
class AutoFitResult:
    result: tfit.FitResult
    hyper: Dict[str, int]
    stages: List[tfit.FitResult]


def auto_fit(all_tracks, dt, nb_states: int = 2, cell_dims=(1.0,),
             input_LocErr=None, verbose: int = 0,
             n_iterations: int = 2, params=None, *, device=None,
             dtype=None, **kw) -> AutoFitResult:
    """Coarse fit -> hyper-parameter choice -> refined fit(s), each on
    ``device`` in ``dtype`` (``fit.param_fitting``).

    ``params`` seeds the first iteration (warm start); later iterations
    chain each fit's result."""
    stages = []
    hyper = {"frame_len": 3, "nb_substeps": 1}
    for it in range(n_iterations):
        res = tfit.param_fitting(
            all_tracks, dt, params=params, nb_states=nb_states,
            nb_substeps=hyper["nb_substeps"], frame_len=hyper["frame_len"],
            cell_dims=cell_dims, input_LocErr=input_LocErr, verbose=verbose,
            device=device, dtype=dtype, **kw)
        stages.append(res)
        params = res.params
        hyper = choose_hyperparams(res.params.valuesdict(), dt, nb_states)
        if verbose:
            print(f"auto_fit iter {it}: logL={res.logl:.2f}, next {hyper}")
    return AutoFitResult(result=stages[-1], hyper=hyper, stages=stages)


@dataclasses.dataclass
class ModelSelectionResult:
    fits: Dict[int, tfit.FitResult]
    logls: Dict[int, float]
    bic: Dict[int, float]
    aic: Dict[int, float]
    best_nb_states: int

    def summary(self) -> str:
        rows = ["states  logL          BIC           AIC"]
        for s in sorted(self.fits):
            star = " *" if s == self.best_nb_states else ""
            rows.append(f"{s:>6}  {self.logls[s]:<12.2f}  "
                        f"{self.bic[s]:<12.2f}  {self.aic[s]:<12.2f}{star}")
        return "\n".join(rows)


def split_state_params(values: Dict[str, float], nb_states: int,
                       D_max: float = 3.0) -> tparams.Parameters:
    """Initial parameters for an (s+1)-state fit from an s-state optimum:
    split the fastest state into two (0.6x and 1.6x its D), halve its
    fraction.  Incremental warm starts avoid the local optima that default
    initializations hit for 3+ states (the reference hand-tunes estimates
    per state count in its tutorial instead)."""
    Ds = [float(values[f"D{i}"]) for i in range(nb_states)]
    Fs = [float(values[f"F{i}"]) for i in range(nb_states)]
    d_last = max(Ds[-1], 1e-3)
    new_Ds = Ds[:-1] + [0.6 * d_last, min(1.6 * d_last, D_max * 0.9)]
    new_Fs = Fs[:-1] + [Fs[-1] / 2, Fs[-1] / 2]
    new_Fs = [max(f, 0.01) for f in new_Fs]
    norm = sum(new_Fs)
    new_Fs = [f / norm for f in new_Fs]
    rates = [float(values[k]) for k in values
             if k.startswith("p") and k != "pBL" and len(k) == 3]
    r0 = float(np.clip(np.mean(rates) if rates else 0.1, 0.01, 0.5))
    return tparams.generate_params(
        nb_states=nb_states + 1, LocErr_type=1,
        estimated_LocErr=[float(values.get("LocErr", 0.02))],
        estimated_Ds=new_Ds, estimated_Fs=new_Fs,
        estimated_transition_rates=r0, D_max=D_max)


def model_selection(all_tracks, dt, state_range: Sequence[int] = (2, 3, 4),
                    cell_dims=(1.0,), criterion: str = "bic",
                    frame_lens: Optional[Dict[int, int]] = None,
                    warm_start: bool = True,
                    verbose: int = 0, *, device=None, dtype=None,
                    **kw) -> ModelSelectionResult:
    """Fit 2..n-state models and rank them by BIC/AIC.

    The reference performs this manually in its tutorial (a 2->5-state scan
    that takes "around a day", Tutorial md cell 49); here each fit is
    ``fit.param_fitting`` on ``device``.  Default window per state count follows
    the reference's own defaults (6 -> 5 -> 4 as states grow, SURVEY.md
    section 7.6e).  With ``warm_start`` each state count initializes by
    splitting the fastest state of the previous optimum.
    """
    frame_lens = frame_lens or {}
    n_points = sum(np.prod(np.asarray(all_tracks[k]).shape[:2])
                   for k in all_tracks)
    fits, logls, bic, aic = {}, {}, {}, {}
    prev = None
    for s in state_range:
        params = None
        if warm_start and prev is not None and prev[0] == s - 1:
            params = split_state_params(prev[1].params.valuesdict(), s - 1)
        res = tfit.param_fitting(
            all_tracks, dt, params=params, nb_states=s,
            frame_len=frame_lens.get(s, tfit.default_window(s)),
            cell_dims=cell_dims, verbose=verbose, device=device,
            dtype=dtype, **kw)
        prev = (s, res)
        k_free = len(res.params.free_names())
        fits[s] = res
        logls[s] = res.logl
        bic[s] = k_free * np.log(n_points) - 2 * res.logl
        aic[s] = 2 * k_free - 2 * res.logl
        if verbose:
            print(f"{s} states: logL={res.logl:.2f} "
                  f"BIC={bic[s]:.2f} AIC={aic[s]:.2f}")
    crit = bic if criterion == "bic" else aic
    best = min(crit, key=crit.get)
    return ModelSelectionResult(fits=fits, logls=logls, bic=bic, aic=aic,
                                best_nb_states=best)


def _fit_nstates(all_tracks, dt, nb_states, steady_state, cell_dims,
                 estimated_vals, vary_params, frame_len_pred, device, dtype):
    """Shared body of fit_2states / fit_3states."""
    from extrack_tpu_torch import predict as tpredict

    kw = {}
    if estimated_vals or vary_params:
        ev = estimated_vals or {}
        p = tparams.generate_params(
            nb_states=nb_states,
            estimated_LocErr=ev.get("LocErr", 0.025),
            estimated_Ds=[ev.get(f"D{s}", 0.05 * s)
                          for s in range(nb_states)],
            estimated_Fs=[ev.get(f"F{s}", 1.0 / nb_states)
                          for s in range(nb_states)],
            steady_state=steady_state)
        for name, vary in (vary_params or {}).items():
            if name in p:
                p[name].vary = bool(vary)
        kw["params"] = p
    res = auto_fit(all_tracks, dt, nb_states=nb_states,
                   cell_dims=tuple(cell_dims) if cell_dims else (1.0,),
                   steady_state=steady_state, device=device, dtype=dtype,
                   **kw)
    preds = tpredict.predict_Bs(all_tracks, dt, res.result.params,
                                nb_states=nb_states,
                                frame_len=frame_len_pred, device=device,
                                dtype=dtype)
    return res.result, preds


def fit_2states(all_tracks, dt, steady_state=True, cell_dims=(),
                estimated_vals=None, vary_params=None, *, device=None,
                dtype=None):
    """Hands-off 2-state fit + state annotation — reference signature
    (extrack/auto_fitting.py:4-54; broken upstream: it imports a removed
    API, extrack/__init__.py:4).  Runs the DLR-heuristic auto fit
    (choose_hyperparams) instead of the reference's 40-round refit loop —
    exact gradients converge in one L-BFGS run per hyper-parameter choice.
    Returns (FitResult, preds) like the reference's (model_fit, preds);
    the fits and the posteriors (K4) run on ``device``."""
    return _fit_nstates(all_tracks, dt, 2, steady_state, cell_dims,
                        estimated_vals or {}, vary_params,
                        frame_len_pred=9, device=device, dtype=dtype)


def fit_3states(all_tracks, dt, steady_state=True, cell_dims=(),
                estimated_vals=None, vary_params=None, *, device=None,
                dtype=None):
    """Hands-off 3-state fit + annotation (extrack/auto_fitting.py:56-112);
    see fit_2states."""
    return _fit_nstates(all_tracks, dt, 3, steady_state, cell_dims,
                        estimated_vals or {}, vary_params,
                        frame_len_pred=6, device=device, dtype=dtype)
