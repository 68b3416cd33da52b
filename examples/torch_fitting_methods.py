"""Fitting-method variants on the PyTorch / CUDA port: every
localization-error model, matrix discretizations, sub-steps and the
steady-state constraint.

The story of examples/fitting_methods.py (the reference's
Tutorials/Fitting_methods.ipynb) through ``extrack_tpu_torch``: the same
dataset is fitted under each LocErr_type (single / per-dim / affine
per-peak / fixed per-peak) plus variations of Matrix_type and nb_substeps.
On the card every fit runs the CUDA kernels; ``--device cpu`` runs the
plain PyTorch engine.

Run: python examples/torch_fitting_methods.py [--small] [--device cpu]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))  # repo-root run without install
import argparse

import numpy as np

ap = argparse.ArgumentParser()
ap.add_argument("--small", action="store_true", help="tiny sizes (CI smoke)")
ap.add_argument("--device", default="cuda",
                help="cuda (the default: the CUDA kernels) or cpu")
args = ap.parse_args()
# the smoke run: fewer tracks, each fit's iterations capped (the variants
# run, not their optima)
N = 300 if args.small else 8000
FIT = dict(frame_len=5, cell_dims=(0.5,), verbose=0, device=args.device,
           **({"max_iter": 5} if args.small else {}))

from extrack_tpu_torch import fit, params as xp, simulate  # noqa: E402

TRMAT = np.array([[0.9, 0.1], [0.05, 0.95]])
tracks, states, sigmas = simulate.sim_fov(
    nb_tracks=N, max_track_len=12, min_track_len=4, LocErr=0.025,
    LocErr_std=0.4, Ds=(0.0, 0.06), TrMat=TRMAT, dt=0.02, pBL=0.08,
    cell_dims=(0.5, None, None), seed=1)


def report(tag, res, names):
    vals = res.params.valuesdict()
    shown = ", ".join(f"{n}={vals[n]:.4g}" for n in names if n in vals)
    print(f"{tag:<28} logL={res.logl:10.1f}  {shown}")


# 1. single LocErr parameter (LocErr_type=1)
spec = xp.generate_params(nb_states=2, LocErr_type=1, D_max=1.0,
                          estimated_Ds=[0.002, 0.04])
res = fit.param_fitting(tracks, 0.02, params=spec, **FIT)
report("LocErr_type=1 (single)", res, ["LocErr", "D1", "p01", "pBL"])

# 2. one LocErr per dimension (LocErr_type=2)
spec = xp.generate_params(nb_states=2, LocErr_type=2, nb_dims=2, D_max=1.0,
                          estimated_Ds=[0.002, 0.04])
res = fit.param_fitting(tracks, 0.02, params=spec, **FIT)
report("LocErr_type=2 (per dim)", res, ["LocErr0", "LocErr1", "D1"])

# 3. affine map of a per-peak error estimate (LocErr_type=4)
spec = xp.generate_params(nb_states=2, LocErr_type=4, D_max=1.0,
                          estimated_Ds=[0.002, 0.04],
                          slope_offsets_estimates=[0.9, 0.002])
res = fit.param_fitting(tracks, 0.02, params=spec, input_LocErr=sigmas,
                        **FIT)
report("LocErr_type=4 (affine)", res, ["slope_LocErr", "offset_LocErr",
                                       "D1"])

# 4. fixed per-peak errors (LocErr_type=None): no error parameter fitted
spec = xp.generate_params(nb_states=2, LocErr_type=None, D_max=1.0,
                          estimated_Ds=[0.002, 0.04])
res = fit.param_fitting(tracks, 0.02, params=spec, input_LocErr=sigmas,
                        **FIT)
report("LocErr_type=None (fixed)", res, ["D1", "p01", "p10"])

# 5. matrix exponential discretization (Matrix_type=2)
spec = xp.generate_params(nb_states=2, LocErr_type=1, D_max=1.0,
                          estimated_Ds=[0.002, 0.04])
res = fit.param_fitting(tracks, 0.02, params=spec, Matrix_type=2, **FIT)
report("Matrix_type=2 (expm)", res, ["p01", "p10"])

# 6. two hidden sub-steps per frame (nb_substeps=2)
spec = xp.generate_params(nb_states=2, LocErr_type=1, D_max=1.0,
                          estimated_Ds=[0.002, 0.04])
res = fit.param_fitting(tracks, 0.02, params=spec, nb_substeps=2, **FIT)
report("nb_substeps=2", res, ["p01", "p10", "D1"])

# 7. steady-state constraint ties p10 to (F0, p01)
spec = xp.generate_params(nb_states=2, LocErr_type=1, D_max=1.0,
                          estimated_Ds=[0.002, 0.04], steady_state=True)
res = fit.param_fitting(tracks, 0.02, params=spec, **FIT)
report("steady_state=True", res, ["F0", "p01", "p10"])

print("\ntruth: LocErr~0.025 (chi2 spread 40%), D1=0.06, p01=0.1, p10=0.05, "
      "pBL=0.08")
