"""Parameter system: bounded, optionally-constrained named parameters.

The reference uses lmfit ``Parameters`` as its config currency: values,
bounds, ``vary`` flags and algebraic ``expr`` constraints such as
``'1 - F0'`` or the steady-state ``'p01/(1/F0-1)'``
(extrack/tracking.py:1090-1290).  This module gives the same semantics on
torch tensors:

* each parameter has value / min / max / vary / expr;
* free parameters map to an unconstrained optimizer space through a sigmoid
  bijection (value <-> logit of the position inside the bounds);
* ``expr`` strings are parsed once into a restricted AST (arithmetic only)
  and evaluated on tensors, so constraint graphs are differentiable with
  autograd.

Fixed parameters stay Python floats until ``extract_arrays`` places them on
a device in a dtype.
"""
from __future__ import annotations

import ast
import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

_ALLOWED_NODES = (ast.Expression, ast.BinOp, ast.UnaryOp,
                  ast.Constant, ast.Name, ast.Load, ast.Add, ast.Sub,
                  ast.Mult, ast.Div, ast.Pow, ast.USub, ast.UAdd, ast.Call)


def _unary(t_fn, m_fn):
    def f(x):
        return t_fn(x) if isinstance(x, torch.Tensor) else m_fn(x)
    return f


def _binary(t_fn, p_fn):
    def f(x, y):
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            ref = x if isinstance(x, torch.Tensor) else y
            return t_fn(torch.as_tensor(x, dtype=ref.dtype, device=ref.device),
                        torch.as_tensor(y, dtype=ref.dtype, device=ref.device))
        return p_fn(x, y)
    return f


_ALLOWED_FUNCS = {"exp": _unary(torch.exp, math.exp),
                  "log": _unary(torch.log, math.log),
                  "sqrt": _unary(torch.sqrt, math.sqrt),
                  "abs": _unary(torch.abs, abs),
                  "min": _binary(torch.minimum, min),
                  "max": _binary(torch.maximum, max)}


def _compile_expr(expr: str):
    tree = ast.parse(expr, mode="eval")
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise ValueError(f"disallowed element {type(node).__name__!r} "
                             f"in expr {expr!r}")
        if isinstance(node, ast.Call):
            if (not isinstance(node.func, ast.Name)
                    or node.func.id not in _ALLOWED_FUNCS):
                raise ValueError(f"disallowed call in expr {expr!r}")
    code = compile(tree, "<param-expr>", "eval")

    def run(env):
        return eval(code, {"__builtins__": {}, **_ALLOWED_FUNCS}, dict(env))
    return run


@dataclasses.dataclass
class Param:
    name: str
    value: float = 0.0
    min: float = -math.inf
    max: float = math.inf
    vary: bool = True
    expr: Optional[str] = None

    def __post_init__(self):
        if self.expr is not None:
            self.vary = False
            self._fn = _compile_expr(self.expr)
        else:
            self._fn = None


class Parameters:
    """Ordered collection of Params with an lmfit-compatible surface."""

    def __init__(self):
        self._params: Dict[str, Param] = {}
        # >= 4 states: fractions tied to the stationary distribution of the
        # rate generator by a differentiable linear solve (resolve())
        self.steady_state_n: Optional[int] = None

    def add(self, name, value=None, min=-math.inf, max=math.inf, vary=True,
            expr=None, brute_step=None):  # brute_step accepted, ignored
        self._params[name] = Param(name, 0.0 if value is None else value,
                                   min, max, vary, expr)

    def __getitem__(self, name) -> Param:
        return self._params[name]

    def __contains__(self, name):
        return name in self._params

    def __iter__(self):
        return iter(self._params)

    def keys(self):
        return self._params.keys()

    def items(self):
        return self._params.items()

    def copy(self) -> "Parameters":
        new = Parameters()
        for p in self._params.values():
            new.add(p.name, p.value, p.min, p.max, p.vary, p.expr)
        new.steady_state_n = self.steady_state_n
        return new

    def to_records(self) -> list:
        """[(name, value, min, max, vary, expr), ...] in order; the
        steady-state marker rides as expr ``"__steady_state__"``."""
        return [(p.name, float(p.value), float(p.min), float(p.max),
                 bool(p.vary), p.expr) for p in self._params.values()]

    @classmethod
    def from_records(cls, records) -> "Parameters":
        """Inverse of ``to_records``."""
        new = cls()
        n_steady = 0
        for name, value, lo, hi, vary, expr in records:
            new.add(name, value, lo, hi, vary, expr)
            n_steady += expr == "__steady_state__"
        new.steady_state_n = n_steady or None
        return new

    def valuesdict(self) -> Dict[str, float]:
        return {k: float(v) for k, v in self.resolve().items()}

    def free_names(self):
        return [n for n, p in self._params.items() if p.vary]

    def resolve(self, free_values: Optional[Dict[str, object]] = None):
        """Evaluate all parameters (expr graph included) into a name->value
        dict; ``free_values`` overrides the stored values of free params."""
        env: Dict[str, object] = {}
        pending = dict(self._params)
        for name, p in list(pending.items()):
            if p.expr is None:
                v = (free_values[name]
                     if free_values is not None and name in free_values
                     else p.value)
                env[name] = v
                del pending[name]
        if self.steady_state_n:
            for s in range(self.steady_state_n):
                pending.pop(f"F{s}", None)

        def drain():
            guard = len(pending) + 1
            while pending and guard:
                guard -= 1
                for name, p in list(pending.items()):
                    try:
                        env[name] = p._fn(env)
                        del pending[name]
                    except NameError:
                        continue

        # rates may themselves be expr-tied: resolve the graph best-effort
        # BEFORE the stationary solve reads them
        drain()
        if self.steady_state_n:
            # stationary distribution of the rate generator: pi^T Q = 0,
            # sum(pi) = 1, as a differentiable solve
            n = self.steady_state_n
            ref = next((v for v in env.values()
                        if isinstance(v, torch.Tensor)), None)
            kw = (dict(dtype=ref.dtype, device=ref.device) if ref is not None
                  else dict(dtype=torch.float64))
            Q = torch.stack([torch.stack([
                torch.as_tensor(env[f"p{i}{j}"] if i != j else 0.0, **kw)
                for j in range(n)]) for i in range(n)])
            Q = Q - torch.diag(Q.sum(dim=1))
            A = torch.cat([Q.T[:n - 1], torch.ones(1, n, **kw)])
            b = torch.zeros(n, **kw)
            b[n - 1] = 1.0
            pi = torch.linalg.solve(A, b)
            for s in range(n):
                env[f"F{s}"] = pi[s] if ref is not None else float(pi[s])
            drain()
        if pending:
            raise ValueError(f"unresolvable exprs: {list(pending)}")
        return env

    # -- bijection to unconstrained optimizer space ------------------------
    def to_unconstrained(self) -> np.ndarray:
        return np.array([_to_z(self._params[n].value, self._params[n].min,
                               self._params[n].max)
                         for n in self.free_names()], dtype=np.float64)

    def from_unconstrained(self, z: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {n: _from_z(z[i], self._params[n].min, self._params[n].max)
                for i, n in enumerate(self.free_names())}

    def unconstrained_log_jacobian(self, z: torch.Tensor) -> torch.Tensor:
        """Sum of log |d theta_i / d z_i| over the free parameters: the
        change-of-variables term that makes a flat prior on the bounded
        parameters flat in unconstrained space (see sample.py);
        differentiable in z."""
        total = torch.zeros((), dtype=z.dtype, device=z.device)
        for i, n in enumerate(self.free_names()):
            p = self._params[n]
            total = total + _logdet_from_z(z[i], p.min, p.max)
        return total

    def set_values(self, values: Dict[str, float]):
        for n, v in values.items():
            if n in self._params:
                self._params[n].value = float(v)

    def __repr__(self):
        rows = []
        for n, p in self._params.items():
            if p.expr is not None:
                rows.append(f"  {n} = {p.expr!r}")
            else:
                rows.append(f"  {n} = {p.value:.6g}  "
                            f"[{p.min:g}, {p.max:g}] vary={p.vary}")
        return "Parameters(\n" + "\n".join(rows) + "\n)"


_CLIP = 1e-12


def _to_z(v, lo, hi) -> float:
    if np.isinf(lo) and np.isinf(hi):
        return float(v)
    if np.isinf(hi):
        return float(np.log(max(v - lo, _CLIP)))
    if np.isinf(lo):
        return float(-np.log(max(hi - v, _CLIP)))
    frac = np.clip((v - lo) / (hi - lo), _CLIP, 1 - _CLIP)
    return float(np.log(frac) - np.log1p(-frac))


def _from_z(z: torch.Tensor, lo, hi) -> torch.Tensor:
    if np.isinf(lo) and np.isinf(hi):
        return z
    if np.isinf(hi):
        return lo + torch.exp(z)
    if np.isinf(lo):
        return hi - torch.exp(-z)
    return lo + (hi - lo) * torch.clamp(torch.sigmoid(z), 1e-14, 1.0 - 1e-14)


def _logdet_from_z(z: torch.Tensor, lo, hi) -> torch.Tensor:
    """log |d _from_z(z)/dz|: the bijection's log-Jacobian, used by the
    posterior sampler so flat priors on the BOUNDED parameters stay flat
    after the change of variables to unconstrained space."""
    if np.isinf(lo) and np.isinf(hi):
        return torch.zeros_like(z)
    if np.isinf(hi):
        return z
    if np.isinf(lo):
        return -z
    s = torch.sigmoid(z)
    return (math.log(hi - lo) + torch.log(torch.clamp(s, min=1e-14))
            + torch.log(torch.clamp(1.0 - s, min=1e-14)))


# ---------------------------------------------------------------------------
# Constructors mirroring the reference API
# ---------------------------------------------------------------------------

def generate_params(nb_states: int = 3,
                    LocErr_type: int = 1,
                    nb_dims: int = 3,
                    LocErr_bounds=(0.005, 0.1),
                    D_max: float = 10.0,
                    Fractions_bounds=(0.001, 0.99),
                    estimated_LocErr=None,
                    estimated_Ds=None,
                    estimated_Fs=None,
                    estimated_transition_rates=0.1,
                    slope_offsets_estimates=None,
                    pBL_estimate: float = 0.1,
                    steady_state: bool = False) -> Parameters:
    """Default parameter construction (extrack/tracking.py:1214-1290).

    LocErr_type: 1 single parameter, 2 one per dimension, 3 shared x/y plus a
    separate z, 4 affine map of per-peak input errors, None = take per-peak
    input errors as-is.
    """
    params = Parameters()
    le0 = float(np.sqrt(LocErr_bounds[0] * LocErr_bounds[1]))
    if LocErr_type == 1:
        v = le0 if estimated_LocErr is None else np.atleast_1d(
            estimated_LocErr)[0]
        params.add("LocErr", v, LocErr_bounds[0], LocErr_bounds[1])
    elif LocErr_type == 2:
        for d in range(nb_dims):
            v = le0 if estimated_LocErr is None else estimated_LocErr[d]
            params.add(f"LocErr{d}", v, LocErr_bounds[0], LocErr_bounds[1])
    elif LocErr_type == 3:
        v0 = le0 if estimated_LocErr is None else estimated_LocErr[0]
        vz = le0 if estimated_LocErr is None else estimated_LocErr[-1]
        params.add("LocErr0", v0, LocErr_bounds[0], LocErr_bounds[1])
        params.add("LocErr1", expr="LocErr0")
        params.add("LocErr2", vz, LocErr_bounds[0], LocErr_bounds[1])
    elif LocErr_type == 4:
        params.add("slope_LocErr", slope_offsets_estimates[0], -1.0, 20.0)
        params.add("offset_LocErr", slope_offsets_estimates[1], -1.0, 1.0)
    elif LocErr_type is not None:
        raise ValueError(f"unknown LocErr_type {LocErr_type}")

    # diffusion coefficients: D0 free, increments enforce D0 <= D1 <= ...
    # (reference Di_minus_Dj expr chains, extrack/tracking.py:1185-1194)
    if estimated_Ds is None:
        estimated_Ds = [0.5 * s ** 2 * D_max / max(nb_states - 1, 1) ** 2
                        for s in range(nb_states)]
    params.add("D0", estimated_Ds[0], 0.0, D_max)
    expr = "D0"
    for s in range(1, nb_states):
        inc = f"D{s}_minus_D{s - 1}"
        params.add(inc, max(estimated_Ds[s] - estimated_Ds[s - 1], 1e-12),
                   0.0, D_max)
        expr = f"{expr} + {inc}"
        params.add(f"D{s}", expr=expr)

    if estimated_Fs is None:
        estimated_Fs = [1.0 / nb_states] * nb_states
    f_expr = "1"
    for s in range(nb_states - 1):
        params.add(f"F{s}", estimated_Fs[s], Fractions_bounds[0],
                   Fractions_bounds[1])
        f_expr += f" - F{s}"
    params.add(f"F{nb_states - 1}", expr=f_expr)

    if not isinstance(estimated_transition_rates, (list, tuple, np.ndarray)):
        estimated_transition_rates = ([estimated_transition_rates]
                                      * (nb_states * (nb_states - 1)))
    idx = 0
    for i in range(nb_states):
        for j in range(nb_states):
            if i != j:
                params.add(f"p{i}{j}", estimated_transition_rates[idx],
                           0.0001, 1.0)
                idx += 1
    params.add("pBL", pBL_estimate, 0.0001, 1.0)

    if steady_state:
        apply_steady_state(params, nb_states)
    return params


def apply_steady_state(params: Parameters, nb_states: int):
    """Tie fractions to the steady state of the rate matrix (reference
    2/3-state expressions, extrack/tracking.py:1109,1139-1141; a
    differentiable stationary solve for >= 4 states)."""
    if nb_states == 2:
        params.add("p10", expr="p01/(1/F0-1)")
    elif nb_states == 3:
        params.add("F0", expr="(p10*(p21+p20)+p20*p12)/((p01)*(p12 + p21) + "
                   "p02*(p10 + p12 + p21) + p01*p20 + p21*p10 + "
                   "p20*(p10+p12))")
        params.add("F1", expr="(F0*p01 + (1-F0)*p21)/(p10 + p12 + p21)")
        params.add("F2", expr="1-F0-F1")
    else:
        for s in range(nb_states):
            params.add(f"F{s}", 1.0 / nb_states, expr="__steady_state__")
        params.steady_state_n = nb_states


def get_params(nb_states: int = 2, steady_state: bool = False,
               vary_params=None, estimated_vals=None, min_values=None,
               max_values=None) -> Parameters:
    """Dict-driven constructor mirroring extrack/tracking.py:1090-1212."""
    vary_params = vary_params or {}
    estimated_vals = estimated_vals or {}
    min_values = min_values or {}
    max_values = max_values or {}
    defaults = {"LocErr": (0.025, 0.007, 0.6), "pBL": (0.1, 0.01, 0.99)}

    params = Parameters()
    if "slope_LocErr" in estimated_vals:
        params.add("slope_LocErr", estimated_vals["slope_LocErr"],
                   min_values.get("slope_LocErr", -1),
                   max_values.get("slope_LocErr", 20),
                   vary_params.get("slope_LocErr", True))
        params.add("offset_LocErr", estimated_vals["offset_LocErr"],
                   min_values.get("offset_LocErr", -1),
                   max_values.get("offset_LocErr", 1),
                   vary_params.get("offset_LocErr", True))
    if "LocErr" in estimated_vals:
        le = estimated_vals["LocErr"]
        if np.ndim(le) == 0:
            params.add("LocErr", le,
                       min_values.get("LocErr", defaults["LocErr"][1]),
                       max_values.get("LocErr", defaults["LocErr"][2]),
                       vary_params.get("LocErr", True))
        else:
            for s in range(len(le)):
                params.add(f"LocErr{s}", le[s], min_values["LocErr"][s],
                           max_values["LocErr"][s],
                           vary_params["LocErr"][s])

    # D0 always exists (default 0.0); every other provided D chains off it
    # as a non-negative increment, in numeric order (D10 after D9)
    d_names = sorted((k for k in estimated_vals if k.startswith("D")
                      and k[1:].isdigit()), key=lambda k: int(k[1:]))
    params.add("D0", estimated_vals.get("D0", 0.0),
               min_values.get("D0", 0.0), max_values.get("D0", 0.3),
               vary_params.get("D0", True))
    expr = "D0"
    prev = "D0"
    running = estimated_vals.get("D0", 0.0)
    for name in (n for n in d_names if n != "D0"):
        inc = f"{name}_minus_{prev}"
        params.add(inc, estimated_vals[name] - running, 0.0,
                   max_values.get(name, 1.0), vary_params.get(name, True))
        expr = f"{expr} + {inc}"
        params.add(name, expr=expr)
        prev = name
        running = estimated_vals[name]

    f_names = sorted((k for k in estimated_vals if k.startswith("F")
                      and k[1:].isdigit()), key=lambda k: int(k[1:]))
    f_expr = "1"
    for name in f_names[:nb_states - 1]:
        params.add(name, estimated_vals[name], min_values.get(name, 0.001),
                   max_values.get(name, 0.99), vary_params.get(name, True))
        f_expr += f" - {name}"
    params.add(f"F{nb_states - 1}", expr=f_expr)

    for name in estimated_vals:
        if (name.startswith("p") and len(name) == 3
                and name[1:].isdigit()):
            params.add(name, estimated_vals[name],
                       min_values.get(name, 0.0001),
                       max_values.get(name, 1.0),
                       vary_params.get(name, True))
    params.add("pBL", estimated_vals.get("pBL", defaults["pBL"][0]),
               min_values.get("pBL", defaults["pBL"][1]),
               max_values.get("pBL", defaults["pBL"][2]),
               vary_params.get("pBL", True))
    if steady_state:
        apply_steady_state(params, nb_states)
    return params


def extract_arrays(values: Dict[str, object], nb_states: int,
                   input_loc_err=None, *, device="cpu",
                   dtype=torch.float64):
    """Resolve a values dict into model tensors (Ds, Fs, rates, loc_err,
    pBL) on ``device`` in ``dtype``.

    Mirrors extract_params (extrack/tracking.py:913-986) but keeps rates as
    a matrix (the Matrix_type discretization lives in
    core.tables.transition_matrix); differentiable through tensor values.
    """
    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    Ds = torch.stack([t(values[f"D{s}"]) for s in range(nb_states)])
    Fs = torch.stack([t(values[f"F{s}"]) for s in range(nb_states)])
    zero = t(0.0)
    rates = torch.stack([torch.stack([t(values[f"p{i}{j}"]) if i != j
                                      else zero for j in range(nb_states)])
                         for i in range(nb_states)])
    pBL = t(values["pBL"])

    if input_loc_err is not None:
        if "slope_LocErr" in values:
            loc_err = torch.clamp(t(input_loc_err) * t(values["slope_LocErr"])
                                  + t(values["offset_LocErr"]), min=1e-6)
        else:
            loc_err = t(input_loc_err)
    elif "LocErr" in values:
        loc_err = t(values["LocErr"])
    else:
        le_names = sorted(k for k in values if k.startswith("LocErr"))
        loc_err = torch.stack([t(values[k]) for k in le_names])
    return Ds, Fs, rates, loc_err, pBL
