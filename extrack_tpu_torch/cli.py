"""Command-line app: the four analyses of the reference GUI, headless.

The reference ships a Tkinter application with Model Fitting / State
Labeling / State Lifetime Histogram / Position Refinement windows
(ExTrack_GUI.py:1288-1293); this CLI is the JAX package's
(``extrack_tpu/cli.py``) on the port's drivers: each analysis is a
subcommand reading TrackMate CSV/XML and writing CSV / XML / JSON / NPZ
results, with the same arguments.  A quality->LocErr transform (1/sqrt(q),
matching ExTrack_GUI.py:273-278) is available through --quality-column.

``--device`` (before or after the subcommand; default ``cuda``) says where
the analyses run: on the card every subcommand runs the CUDA kernels, and
it raises where there is no card; ``--device cpu`` runs the plain engine.
Run it as ``extrack-tpu-torch`` or ``python -m extrack_tpu_torch.cli``.

``--sharded`` splits the tracks over a data mesh (``parallel.mesh``).
Started by ``torchrun`` (its ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT`` in the environment), every process
joins one process group (NCCL on the card, gloo on the CPU), drives its
``LOCAL_RANK``'s GPU and runs its part of each analysis; every process
gets the whole result and only rank 0 writes ``--output``.  Started
alone, it shards over the visible GPUs of the one process.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import warnings

import numpy as np


def _load(args):
    from extrack_tpu_torch.io import readers
    lengths = np.arange(args.min_len, args.max_len + 1)
    if args.path.endswith(".xml"):
        tracks, frames, opt = readers.read_trackmate_xml(
            args.path, lengths=lengths, dist_th=args.dist_th,
            opt_metrics_names=[args.quality_column]
            if args.quality_column else [])
    else:
        tracks, frames, opt = readers.read_table(
            args.path, lengths=lengths, dist_th=args.dist_th,
            colnames=[args.x_col, args.y_col, args.frame_col, args.id_col],
            opt_colnames=[args.quality_column] if args.quality_column else [])
    input_loc_err = None
    if args.quality_column:
        q = opt[args.quality_column]
        input_loc_err = {k: 1.0 / np.sqrt(np.maximum(
            q[k].astype(np.float64), 1e-12)) for k in q}
    n = sum(v.shape[0] for v in tracks.values())
    print(f"loaded {n} tracks "
          f"({', '.join(f'{k}:{v.shape[0]}' for k, v in tracks.items())})")
    return tracks, frames, input_loc_err


def _device_arg(p, default):
    p.add_argument("--device", default=default,
                   help="where the analyses run: cuda (the default; the "
                        "CUDA kernels, raising without a card) or cpu "
                        "(the plain engine)")


def _add_io_args(p):
    p.add_argument("path", help="input CSV or TrackMate XML")
    p.add_argument("--dt", type=float, required=True,
                   help="frame interval (s)")
    p.add_argument("--min-len", type=int, default=5)
    p.add_argument("--max-len", type=int, default=40)
    p.add_argument("--dist-th", type=float, default=np.inf)
    p.add_argument("--x-col", default="POSITION_X")
    p.add_argument("--y-col", default="POSITION_Y")
    p.add_argument("--frame-col", default="FRAME")
    p.add_argument("--id-col", default="TRACK_ID")
    p.add_argument("--quality-column", default=None,
                   help="per-peak quality column mapped to LocErr=1/sqrt(q)")
    p.add_argument("--states", type=int, default=2)
    p.add_argument("--cell-dims", type=float, nargs="+", default=[1.0])
    p.add_argument("--window", type=int, default=None,
                   help="frame_len: exactly-resolved state history "
                        "(default: per-state-count schedule — fit 6/5/4/3 "
                        "for 2/3/4/5+ states, refine 7/5/4/3)")
    p.add_argument("--params", default=None,
                   help="JSON of fitted parameters (from the fit command)")
    p.add_argument("--sharded", action="store_true",
                   help="shard tracks over a data mesh: the processes of a "
                        "torchrun launch, else this process's GPUs")
    p.add_argument("--output", "-o", default=None)
    _device_arg(p, argparse.SUPPRESS)


def _params_from(args, tracks, input_loc_err, warm_free=False):
    """Parameters for a subcommand.  ``--params`` loads a fit payload:
    the predict/hist/refine consumers want those values FIXED
    (load_params' contract), but fit-like consumers (sample) need FREE
    parameters warm-started at the loaded values — an all-fixed spec
    would sample nothing.  A loaded value outside the free parameter's
    bounds starts at the nearest bound, with a warning."""
    from extrack_tpu_torch import params as tparams
    from extrack_tpu_torch.io import exporters

    def default_spec():
        return tparams.generate_params(
            nb_states=args.states,
            LocErr_type=None if input_loc_err is not None else 1,
            D_max=3.0)

    if args.params:
        loaded = exporters.load_params(args.params)
        if not warm_free:
            return loaded
        spec = default_spec()
        vals = {k: float(v) for k, v in loaded.valuesdict().items()
                if k in spec}
        outside = [f"{k}={v:g} [{spec[k].min:g}, {spec[k].max:g}]"
                   for k, v in vals.items()
                   if spec[k].vary and spec[k].expr is None
                   and not spec[k].min <= v <= spec[k].max]
        if outside:
            warnings.warn(
                f"--params {args.params}: {', '.join(outside)} lie outside "
                "their bounds; they start at the nearest bound",
                stacklevel=2)
        spec.set_values(vals)
        return spec
    return default_spec()


def cmd_fit(args):
    from extrack_tpu_torch import fit
    tracks, _, input_loc_err = _load(args)
    res = fit.param_fitting(
        tracks, args.dt, nb_states=args.states, frame_len=args.window,
        cell_dims=tuple(args.cell_dims), input_LocErr=input_loc_err,
        verbose=args.verbose, compute_errors=True, sharded=args.sharded,
        device=args.device)
    print(res)
    if args.output:
        payload = {"logL": res.logl, "success": res.success,
                   "values": res.params.valuesdict(),
                   "std_errors": res.std_errors}
        with open(args.output, "w") as fh:
            json.dump(payload, fh, indent=1)
        print(f"wrote {args.output}")


def cmd_predict(args):
    from extrack_tpu_torch import predict
    from extrack_tpu_torch.io import exporters
    tracks, frames, input_loc_err = _load(args)
    spec = _params_from(args, tracks, input_loc_err)
    preds = predict.predict_Bs(tracks, args.dt, spec,
                               cell_dims=tuple(args.cell_dims),
                               nb_states=args.states,
                               frame_len=(args.window if args.window
                                          is not None else 5),
                               input_LocErr=input_loc_err,
                               sharded=args.sharded, device=args.device)
    out = args.output or "extrack_predictions.csv"
    if out.endswith(".xml"):
        exporters.save_extrack_2_xml(tracks, preds, spec, out, args.dt,
                                     all_frames=frames)
    else:
        exporters.save_extrack_2_CSV(out, tracks, preds, args.dt,
                                     all_frames=frames)
    print(f"wrote {out}")


def cmd_hist(args):
    from extrack_tpu_torch import histograms
    tracks, _, input_loc_err = _load(args)
    spec = _params_from(args, tracks, input_loc_err)
    hist = histograms.len_hist(tracks, spec, args.dt,
                               cell_dims=tuple(args.cell_dims),
                               nb_states=args.states,
                               window=(args.window if args.window
                                       is not None else 7),
                               input_LocErr=input_loc_err,
                               sharded=args.sharded, device=args.device)
    out = args.output or "extrack_durations.csv"
    header = ",".join(f"state_{s}" for s in range(hist.shape[1]))
    np.savetxt(out, hist, delimiter=",", header="duration histogram rows = "
               f"segment length 1..{hist.shape[0]} ({header})")
    print(f"wrote {out}")
    if args.plot:
        from extrack_tpu_torch import visualization as viz
        import matplotlib.pyplot as plt
        # plot the histogram just written: recomputing would double the
        # work and (with the plot defaults) disagree with the CSV
        viz.visualize_states_durations(tracks, spec, args.dt, hists=hist)
        plt.savefig(out.rsplit(".", 1)[0] + ".png", dpi=150)


def cmd_refine(args):
    from extrack_tpu_torch import refine
    from extrack_tpu_torch.io import exporters
    tracks, frames, input_loc_err = _load(args)
    spec = _params_from(args, tracks, input_loc_err)
    loc_err, ds, Fs, tr = refine.refinement_args(spec, args.states, args.dt)
    mus, sigmas = refine.position_refinement(
        tracks, input_loc_err if input_loc_err is not None else loc_err,
        ds, Fs, tr, frame_len=args.window, sharded=args.sharded,
        device=args.device)
    out = args.output or "extrack_refined.csv"
    exporters.refined_2_pandas(tracks, mus, sigmas, frames).to_csv(
        out, index=False)
    print(f"wrote {out}")


def cmd_sample(args):
    """Bayesian posterior sampling (HMC) over the fit likelihood."""
    from extrack_tpu_torch import fit, sample
    tracks, _, input_loc_err = _load(args)
    spec = _params_from(args, tracks, input_loc_err, warm_free=True)
    fisher_sd = None
    if not args.no_precondition:
        # warm start + Fisher metric: a sharp posterior needs the fit's
        # errors to precondition warmup (sample.sample_posterior doc)
        warnings.warn(
            "sample: running a full fit with error bars first, from "
            + (f"--params {args.params}" if args.params else "the default "
               "start") + ", to warm-start the chains and precondition "
            "their metric; pass --no-precondition to skip it",
            stacklevel=2)
        res = fit.param_fitting(
            tracks, args.dt, params=spec, nb_states=args.states,
            frame_len=args.window, cell_dims=tuple(args.cell_dims),
            input_LocErr=input_loc_err, compute_errors=True,
            sharded=args.sharded, verbose=0, device=args.device)
        spec, fisher_sd = res.params, res.std_errors
        if args.verbose:
            print(f"preconditioning fit: logL={res.logl:.1f} "
                  f"({res.n_evals} evals)")
    out = sample.sample_posterior(
        tracks, args.dt, spec, nb_states=args.states,
        num_samples=args.samples, num_warmup=args.warmup,
        num_chains=args.chains, n_leapfrog=args.n_leapfrog,
        target_accept=args.target_accept, init_step=args.init_step,
        jitter=args.jitter, window=args.window,
        cell_dims=tuple(args.cell_dims), input_LocErr=input_loc_err,
        sharded=args.sharded, seed=args.seed,
        dispatch_chunk=args.dispatch_chunk, fisher_sd=fisher_sd,
        verbose=args.verbose, device=args.device)
    print(out.summary())
    bad = [n for n, r in out.rhat.items() if np.isfinite(r) and r > 1.05]
    if bad:
        print(f"WARNING: R-hat > 1.05 for {', '.join(bad)} — chains have "
              "not mixed; increase --samples/--warmup or lower "
              "--target-accept")
    path = args.output or "extrack_posterior.npz"
    names = list(out.samples)
    np.savez(path, **out.samples,
             accept_rate=out.accept_rate, step_size=out.step_size,
             rhat=np.array([out.rhat[n] for n in names]),
             ess=np.array([out.ess[n] for n in names]),
             param_names=np.array(names))
    print(f"wrote {path} (arrays: chains x draws per free parameter)")


def cmd_warmup(args):
    """Run every analysis once on simulated tracks at these settings.

    On the card the first analysis of a checkout builds the CUDA library
    (one nvcc per kernel source, minutes); it is kept in the package's
    ``_build/`` directory, so a later analysis in a fresh process only
    loads it.  Run it once after install.
    """
    import time

    import torch

    from extrack_tpu_torch import (fit, histograms, predict, refine,
                                   simulate)
    t00 = time.time()
    name = (torch.cuda.get_device_name(0)
            if torch.device(args.device).type == "cuda" else "cpu")
    print(f"device: {args.device} ({name}); warming "
          f"states={args.states} window={args.window} "
          f"lengths<={args.max_len}")
    tracks, _, _ = simulate.sim_fov(
        nb_tracks=args.n_tracks, max_track_len=args.max_len,
        min_track_len=args.min_len, LocErr=0.02,
        Ds=[0.0] + [0.05 * (i + 1) for i in range(args.states - 1)],
        dt=args.dt, pBL=0.1, cell_dims=(0.5, None, None), seed=0)
    t0 = time.time()
    # each analysis at its subcommand's default window (fit/refine:
    # per-state-count schedule; predict: 5; histogram: 7)
    w_pred = args.window if args.window is not None else 5
    w_hist = args.window if args.window is not None else 7
    res = fit.param_fitting(
        tracks, args.dt, nb_states=args.states, frame_len=args.window,
        cell_dims=tuple(args.cell_dims), verbose=0, compute_errors=True,
        max_iter=3, device=args.device)
    print(f"  fit (kernel build or load included): {time.time() - t0:.1f}s")
    spec = res.params
    for what, fn in [
        ("predict", lambda: predict.predict_Bs(
            tracks, args.dt, spec, cell_dims=tuple(args.cell_dims),
            nb_states=args.states, frame_len=w_pred, device=args.device)),
        ("histogram", lambda: histograms.len_hist(
            tracks, spec, args.dt, cell_dims=tuple(args.cell_dims),
            nb_states=args.states, window=w_hist, device=args.device)),
    ]:
        t0 = time.time()
        fn()
        print(f"  {what}: {time.time() - t0:.1f}s")
    loc_err, ds, Fs, tr = refine.refinement_args(spec, args.states, args.dt)
    t0 = time.time()
    refine.position_refinement(
        tracks, loc_err, ds, Fs, tr,
        frame_len=(None if args.window is None
                   else min(args.window + 1, 8)), device=args.device)
    print(f"  refine: {time.time() - t0:.1f}s")
    print(f"warmup done in {time.time() - t00:.1f}s")


def cmd_simulate(args):
    from extrack_tpu_torch import simulate
    from extrack_tpu_torch.io import exporters
    tracks, states, sigs = simulate.sim_fov(
        nb_tracks=args.n_tracks, max_track_len=args.max_len,
        min_track_len=args.min_len, LocErr=args.loc_err,
        Ds=args.Ds, TrMat=np.array(args.trmat).reshape(len(args.Ds), -1),
        dt=args.dt, pBL=args.pBL,
        cell_dims=args.cell_dims + [None] * (3 - len(args.cell_dims)),
        seed=args.seed, verbose=True)
    preds = {k: np.eye(len(args.Ds))[states[k]] for k in states}
    out = args.output or "simulated_tracks.csv"
    exporters.save_extrack_2_CSV(out, tracks, preds, args.dt)
    print(f"wrote {out}")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="extrack-tpu-torch",
        description="Single-particle-tracking state inference on an "
                    "NVIDIA GPU (PyTorch / CUDA)")
    ap.add_argument("--verbose", "-v", action="count", default=0)
    _device_arg(ap, "cuda")
    sub = ap.add_subparsers(dest="command", required=True)

    p_fit = sub.add_parser("fit", help="fit model parameters (MLE)")
    _add_io_args(p_fit)
    p_pred = sub.add_parser("predict", help="annotate state probabilities")
    _add_io_args(p_pred)
    p_hist = sub.add_parser("histogram", help="state duration histograms")
    _add_io_args(p_hist)
    p_hist.add_argument("--plot", action="store_true")
    p_ref = sub.add_parser("refine", help="refine positions")
    _add_io_args(p_ref)

    p_samp = sub.add_parser(
        "sample", help="Bayesian posterior sampling (HMC) — start from a "
        "fit's --params JSON for a warm start")
    _add_io_args(p_samp)
    p_samp.add_argument("--samples", type=int, default=1000)
    p_samp.add_argument("--warmup", type=int, default=500)
    p_samp.add_argument("--chains", type=int, default=2)
    p_samp.add_argument("--seed", type=int, default=0)
    p_samp.add_argument("--n-leapfrog", type=int, default=24,
                        help="leapfrog steps per HMC iteration")
    p_samp.add_argument("--target-accept", type=float, default=0.8,
                        help="dual-averaging acceptance target")
    p_samp.add_argument("--init-step", type=float, default=0.05,
                        help="initial leapfrog step size")
    p_samp.add_argument("--jitter", type=float, default=0.2,
                        help="uniform per-iteration step-size jitter "
                        "fraction (trajectory-length randomization)")
    p_samp.add_argument("--dispatch-chunk", type=int, default=256,
                        help="HMC iterations between copies of the samples "
                        "to the host (identical samples for any value)")
    p_samp.add_argument("--no-precondition", action="store_true",
                        help="skip the warm-start fit whose Fisher "
                        "errors precondition the warmup metric and "
                        "start spread")

    p_warm = sub.add_parser(
        "warmup", help="run each analysis once on simulated tracks (on the "
        "card: builds the CUDA library, so later analyses start without "
        "the nvcc step)")
    p_warm.add_argument("--dt", type=float, default=0.02)
    p_warm.add_argument("--states", type=int, default=2)
    p_warm.add_argument("--window", type=int, default=None,
                        help="override ALL analyses' windows; default: "
                        "each analysis' own default (fit/refine per-"
                        "state schedule, predict 5, histogram 7)")
    p_warm.add_argument("--min-len", type=int, default=5)
    p_warm.add_argument("--max-len", type=int, default=40)
    p_warm.add_argument("--n-tracks", type=int, default=3000)
    p_warm.add_argument("--cell-dims", type=float, nargs="+", default=[1.0])
    _device_arg(p_warm, argparse.SUPPRESS)

    p_sim = sub.add_parser("simulate", help="simulate tracks")
    p_sim.add_argument("--n-tracks", type=int, default=10000)
    p_sim.add_argument("--min-len", type=int, default=3)
    p_sim.add_argument("--max-len", type=int, default=40)
    p_sim.add_argument("--loc-err", type=float, default=0.02)
    p_sim.add_argument("--Ds", type=float, nargs="+", default=[0.0, 0.05])
    p_sim.add_argument("--trmat", type=float, nargs="+",
                       default=[0.9, 0.1, 0.1, 0.9])
    p_sim.add_argument("--dt", type=float, default=0.02)
    p_sim.add_argument("--pBL", type=float, default=0.1)
    p_sim.add_argument("--cell-dims", type=float, nargs="+", default=[0.5])
    p_sim.add_argument("--seed", type=int, default=None)
    p_sim.add_argument("--output", "-o", default=None)
    return ap


# the kernel wrappers whose launch counts ``-v`` reports, by kernel
KERNELS = {"K1": "forward_kernel", "K2": "grad_kernel", "K3": "hvp_kernel",
           "K4": "predict_kernel", "K5": "hist_kernel",
           "K6": "refine_kernel", "K7": "topk_kernel"}


def launch_counts() -> dict:
    """{kernel: {"launches": n, "plain_calls": m}} of this process, for
    the wrappers it imported: on the card every launch of a kernel, on the
    CPU every call of its plain version."""
    out = {}
    for k, name in KERNELS.items():
        mod = sys.modules.get(f"extrack_tpu_torch.ops.{name}")
        if mod is not None:
            out[k] = {"launches": mod.LAUNCHES,
                      "plain_calls": mod.PLAIN_CALLS}
    return out


def _join_group(device) -> bool:
    """Join the process group of a torchrun launch (its environment
    variables), NCCL on the card and gloo on the CPU; False when the
    process was not started that way."""
    if not all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR", "MASTER_PORT")):
        return False
    import torch
    import torch.distributed as dist
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method="env://")
    return True


def main(argv=None):
    args = parser().parse_args(argv)
    if args.command != "simulate":       # the host simulator needs no card
        from extrack_tpu_torch import device as tdevice
        tdevice.check_device(args.device)
    grouped = getattr(args, "sharded", False) and _join_group(args.device)
    if grouped and int(os.environ["RANK"]) > 0:
        args.output = None               # rank 0 writes the one output
    try:
        {"fit": cmd_fit, "predict": cmd_predict, "histogram": cmd_hist,
         "refine": cmd_refine, "simulate": cmd_simulate,
         "sample": cmd_sample, "warmup": cmd_warmup}[args.command](args)
    finally:
        if grouped:
            import torch.distributed as dist
            dist.destroy_process_group()
    if args.verbose:
        print("kernel launches: " + json.dumps(launch_counts()))


if __name__ == "__main__":
    sys.exit(main())
