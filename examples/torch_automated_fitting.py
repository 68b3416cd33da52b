"""Automated per-replicate analysis of a TrackMate experiment layout on the
PyTorch / CUDA port.

The story of examples/automated_fitting.py (the reference's
Tutorials/automated_fitting.py) through ``extrack_tpu_torch``: walk an
experiment directory tree (Exp*/replicate XMLs), fit each experiment with
error bars, save per-experiment parameters and state annotations, and
summarize.  ``--small`` first writes a small simulated layout (two
experiments of two replicates, TrackMate 'Tracks' XML) under the output
directory and analyzes that.  On the card every analysis runs the CUDA
kernels; ``--device cpu`` runs the plain PyTorch engine.

Run: python examples/torch_automated_fitting.py [dataset_root]
         [--per-replicate] [--small] [--device cpu]
     (the root defaults to the layout extracted from the reference's
     dataset.zip)
"""
import os
import sys

sys.path.insert(0, os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))  # repo-root run without install
import argparse
import glob
import json
import tempfile

import numpy as np

TMP = tempfile.gettempdir()
ap = argparse.ArgumentParser()
ap.add_argument("root", nargs="?", default=os.path.join(TMP, "extrack_ds",
                                                        "dataset"))
ap.add_argument("--dt", type=float, default=0.02)
ap.add_argument("--states", type=int, default=2)
ap.add_argument("--outdir", default=os.path.join(
    TMP, "extrack_tpu_torch_automated"))
ap.add_argument("--per-replicate", action="store_true",
                help="fit each XML separately instead of pooling")
ap.add_argument("--small", action="store_true",
                help="simulate a small two-experiment layout and analyze it")
ap.add_argument("--device", default="cuda",
                help="cuda (the default: the CUDA kernels) or cpu")
args = ap.parse_args()
os.makedirs(args.outdir, exist_ok=True)
# the smoke run caps each fit's iterations
FIT = dict(max_iter=10) if args.small else {}

from extrack_tpu_torch import fit, params as xp, predict  # noqa: E402
from extrack_tpu_torch.io import exporters, readers  # noqa: E402

if args.small:
    # two experiments (slow and fast diffusive state), two replicates each
    from extrack_tpu_torch import simulate
    args.root = os.path.join(args.outdir, "dataset")
    for e, D1 in enumerate((0.05, 0.1)):
        exp_dir = os.path.join(args.root, f"Exp{e}")
        os.makedirs(exp_dir, exist_ok=True)
        for rep in range(2):
            tr, _, _ = simulate.sim_fov(
                nb_tracks=150, max_track_len=12, min_track_len=5,
                LocErr=0.02, Ds=(0.0, D1),
                TrMat=np.array([[0.9, 0.1], [0.1, 0.9]]), dt=args.dt,
                pBL=0.1, cell_dims=(0.5, None, None), seed=10 * e + rep)
            flat = {k: np.full(v.shape[:2] + (2,), 0.5)
                    for k, v in tr.items()}
            exporters.save_extrack_2_xml(
                tr, flat, xp.generate_params(nb_states=2),
                os.path.join(exp_dir, f"rep{rep}.xml"), args.dt)

experiments = sorted(d for d in glob.glob(os.path.join(args.root, "*"))
                     if os.path.isdir(d))
if not experiments:
    raise SystemExit(f"no experiment directories under {args.root}")

summary = {}
for exp in experiments:
    name = os.path.basename(exp)
    xmls = sorted(glob.glob(os.path.join(exp, "*.xml")))
    if not xmls:
        print(f"[{name}] no XML files — skipping")
        continue
    groups = [[x] for x in xmls] if args.per_replicate else [xmls]
    for gi, group in enumerate(groups):
        tag = name if not args.per_replicate else f"{name}_rep{gi}"
        tracks, frames, _ = readers.read_trackmate_xml(
            group, lengths=np.arange(5, 40), dist_th=0.5)
        n = sum(v.shape[0] for v in tracks.values())
        print(f"[{tag}] {len(group)} file(s), {n} tracks")
        res = fit.param_fitting(tracks, args.dt, nb_states=args.states,
                                frame_len=6, cell_dims=(0.5,), verbose=0,
                                compute_errors=True, device=args.device,
                                **FIT)
        vals = res.params.valuesdict()
        print(f"[{tag}] logL={res.logl:.1f} "
              + " ".join(f"{k}={vals[k]:.4g}" for k in
                         ("LocErr", "D1", "F0", "p01", "p10", "pBL")
                         if k in vals))
        with open(f"{args.outdir}/{tag}_params.json", "w") as fh:
            json.dump({"values": vals, "std_errors": res.std_errors,
                       "logL": res.logl, "n_tracks": n}, fh, indent=1)
        preds = predict.predict_Bs(tracks, args.dt, res.params,
                                   cell_dims=(0.5,),
                                   nb_states=args.states, frame_len=6,
                                   device=args.device)
        exporters.save_extrack_2_CSV(f"{args.outdir}/{tag}_annotated.csv",
                                     tracks, preds, args.dt,
                                     all_frames=frames)
        summary[tag] = {k: vals[k] for k in ("D1", "F0", "p01", "p10")
                        if k in vals}

print("\nper-experiment summary:")
for tag, v in summary.items():
    print(f"  {tag}: " + " ".join(f"{k}={x:.4g}" for k, x in v.items()))
with open(f"{args.outdir}/summary.json", "w") as fh:
    json.dump(summary, fh, indent=1)
print(f"outputs in {args.outdir}")
