"""Is the fitted D1 below the simulated 0.08 a property of the model or of
the port?  Fits ``chip_smoke.py``'s main-path draw (its ``SIM`` at
``--tracks`` tracks: two states, Ds 0 and 0.08, LocErr 0.02, dt 0.02,
cells of 0.5, seed 0) with both packages' ``param_fitting`` on the CPU in
float64, from the same default start, and prints each package's fitted
parameters, evaluations and log likelihood, and D1's Fisher error with
the simulated D1's distance from the fit in those errors (how many
posterior sds a sampler on this draw should sit from the simulated D1).  It imports both packages, as
the tests do; it is not collected by pytest (it takes minutes)::

    python -m tests.fit_bias_check [--tracks 10000]
"""
from __future__ import annotations

import argparse
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from extrack_tpu import fit as jfit, simulate as jsim  # noqa: E402
from extrack_tpu_torch import fit as tfit, simulate as tsim  # noqa: E402

SIM = dict(max_track_len=20, min_track_len=3, Ds=(0.0, 0.08), LocErr=0.02,
           dt=0.02, pBL=0.1, seed=0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tracks", type=int, default=10_000)
    a = ap.parse_args()
    tracks, _, _ = tsim.sim_fov(nb_tracks=a.tracks, cell_dims=(0.5,), **SIM)
    jtracks, _, _ = jsim.sim_fov(nb_tracks=a.tracks,
                                 cell_dims=(0.5, None, None), **SIM)
    same = (sorted(tracks) == sorted(jtracks)
            and all((tracks[k] == jtracks[k]).all() for k in tracks))
    print(f"{sum(len(v) for v in tracks.values())} tracks; the two "
          f"simulators drew the same tracks: {same}")
    kw = dict(nb_states=2, verbose=0, cell_dims=(0.5,), max_iter=200,
              compute_errors=True)
    for name, run in (
            ("JAX", lambda: jfit.param_fitting(tracks, 0.02, **kw)),
            ("port", lambda: tfit.param_fitting(tracks, 0.02, device="cpu",
                                                **kw))):
        t0 = time.time()
        res = run()
        print(f"{name}: {res.n_evals} evaluations in {time.time() - t0:.1f} "
              f"s, logL {res.logl:.6f}, " + ", ".join(
                  f"{k}={p.value:.6g}" for k, p in res.params.items()))
        se = res.std_errors["D1_minus_D0"]
        gap = abs(res.params["D1"].value - SIM["Ds"][1]) / se
        print(f"{name}: D1 Fisher error {se:.6g}; the simulated D1 "
              f"{SIM['Ds'][1]} lies {gap:.3f} errors from the fit")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
