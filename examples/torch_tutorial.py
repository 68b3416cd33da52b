"""extrack-tpu end-to-end tutorial on the PyTorch / CUDA port.

The story of examples/tutorial.py (and of the reference's
Tutorials/Tutorial_ExTrack.ipynb) through ``extrack_tpu_torch``: simulate
tracks with known ground truth, fit the model with error bars, annotate
states, compare duration histograms against the ground truth, refine
positions, export, and scan the number of states by BIC.  On the card every
analysis runs the port's CUDA kernels; ``--device cpu`` runs the plain
PyTorch engine.

Run:  python examples/torch_tutorial.py [--small] [--device cpu]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))  # repo-root run without install
import argparse
import tempfile

import numpy as np

ap = argparse.ArgumentParser()
ap.add_argument("--small", action="store_true", help="tiny sizes (CI smoke)")
ap.add_argument("--device", default="cuda",
                help="cuda (the default: the CUDA kernels) or cpu")
ap.add_argument("--outdir", default=os.path.join(tempfile.gettempdir(),
                                                 "extrack_tpu_torch_tutorial"))
args = ap.parse_args()
os.makedirs(args.outdir, exist_ok=True)
# the smoke run: fewer and shorter tracks, each fit's iterations capped
N, T = (400, 15) if args.small else (20000, 30)
DEV = dict(device=args.device)
FIT = dict(max_iter=10) if args.small else {}

# ---------------------------------------------------------------------------
# 1. Simulate tracks with known kinetics
# ---------------------------------------------------------------------------
from extrack_tpu_torch import simulate  # noqa: E402

TRUE = dict(LocErr=0.02, Ds=(0.0, 0.05), dt=0.02, pBL=0.1)
TRMAT = np.array([[0.9, 0.1], [0.05, 0.95]])

tracks, true_states, sigmas = simulate.sim_fov(
    nb_tracks=N, max_track_len=T, min_track_len=5, LocErr=TRUE["LocErr"],
    Ds=TRUE["Ds"], TrMat=TRMAT, dt=TRUE["dt"], pBL=TRUE["pBL"],
    cell_dims=(0.5, None, None), seed=0, verbose=True)

# ---------------------------------------------------------------------------
# 2. Fit a 2-state model by maximum likelihood (exact gradients)
# ---------------------------------------------------------------------------
from extrack_tpu_torch import fit  # noqa: E402

res = fit.param_fitting(tracks, TRUE["dt"], nb_states=2, frame_len=5,
                        cell_dims=(0.5,), verbose=0, compute_errors=True,
                        **DEV, **FIT)
print("\nfitted parameters (truth: LocErr=0.02 D1=0.05 p01=0.1 p10=0.05 "
      "pBL=0.1):")
print(res)

# ---------------------------------------------------------------------------
# 3. Annotate every localization with state probabilities
# ---------------------------------------------------------------------------
from extrack_tpu_torch import predict  # noqa: E402
from extrack_tpu_torch.io import exporters  # noqa: E402

preds = predict.predict_Bs(tracks, TRUE["dt"], res.params,
                           cell_dims=(0.5,), nb_states=2, frame_len=7,
                           **DEV)
acc = np.mean([np.mean(np.argmax(preds[k], -1) == true_states[k])
               for k in preds])
print(f"\nstate labeling accuracy vs ground truth: {acc:.3f}")

df = exporters.extrack_2_pandas(tracks, preds)
df.to_csv(f"{args.outdir}/annotated.csv", index=False)
exporters.save_extrack_2_xml(tracks, preds, res.params,
                             f"{args.outdir}/annotated.xml", TRUE["dt"])
exporters.save_params(res.params, args.outdir, fmt="json")

# ---------------------------------------------------------------------------
# 4. State duration histograms: posterior vs ground truth
# ---------------------------------------------------------------------------
from extrack_tpu_torch import histograms  # noqa: E402

hist = histograms.len_hist(tracks, res.params, TRUE["dt"],
                           cell_dims=(0.5,), nb_states=2,
                           max_nb_states=256, **DEV)
gt = histograms.ground_truth_hist(true_states, 2)
print("\nduration histogram (state 1), first 6 lengths:")
print("  posterior  :", np.round(hist[:6, 1] / hist[:, 1].sum(), 3))
print("  groundtruth:", np.round(gt[:6, 1] / gt[:, 1].sum(), 3))

# ---------------------------------------------------------------------------
# 5. Position refinement
# ---------------------------------------------------------------------------
from extrack_tpu_torch import refine  # noqa: E402

loc_err, ds, Fs, tr = refine.refinement_args(res.params, 2, TRUE["dt"])
mus, sigs = refine.position_refinement(tracks, loc_err, ds, Fs, tr,
                                       frame_len=5, **DEV)
mean_sig = float(np.mean(np.concatenate([s.ravel() for s in sigs.values()])))
print(f"\nrefined position uncertainty: {mean_sig:.4f} um "
      f"(raw localization error: {TRUE['LocErr']} um)")

# ---------------------------------------------------------------------------
# 6. Model selection: how many states?
# ---------------------------------------------------------------------------
from extrack_tpu_torch import auto_fitting  # noqa: E402

ms = auto_fitting.model_selection(tracks, TRUE["dt"],
                                  state_range=(2,) if args.small
                                  else (2, 3), cell_dims=(0.5,), **DEV,
                                  **FIT)
print("\nmodel selection:")
print(ms.summary())
print(f"\noutputs in {args.outdir}")
