"""Device-resident analysis pipeline: read -> fit -> annotate -> histogram
-> refine -> export, with length-keyed dicts only at the file edges.

The reference's workflow (Tutorials/Tutorial_ExTrack.ipynb) round-trips its
length-keyed dict format between every stage.  Here the dataset goes to
the device ONCE, as length-bucketed TrackBatches (``data.from_dict_bucketed``),
and every stage consumes the batches directly (``fit.fit`` on K2, with K1
for value-only evaluations; ``predict.predict_batch`` on K4;
``histograms.hist_batch`` on K5; ``refine.refine_batch`` on K6); each
stage's results come back to the host once per bucket.  The JAX package's
``canonical_shapes`` padding has no counterpart: eager PyTorch compiles no
program per shape.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np

from extrack_tpu_torch import data as tdata
from extrack_tpu_torch import params as tparams


@dataclasses.dataclass
class PipelineResult:
    """All artifacts of one end-to-end analysis.

    Per-track arrays are length-keyed dicts (the reference's exchange
    format), produced once at the pipeline edge.
    """
    fit: "object"                              # fit.FitResult
    preds: Optional[Dict[str, np.ndarray]]     # per-peak state posteriors
    hist: Optional[np.ndarray]                 # (T, S) expected durations
    mus: Optional[Dict[str, np.ndarray]]       # refined positions
    sigmas: Optional[Dict[str, np.ndarray]]    # refinement stds
    tracks: Dict[str, np.ndarray]              # input tracks (dict form)
    frames: Optional[Dict[str, np.ndarray]]
    # wall seconds of each stage that ran (read, batch, fit, predict,
    # hist, refine, export), each ending with its results on the host
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)


def analyze(tracks_or_path,
            dt: float,
            nb_states: int = 2,
            cell_dims=(1.0, None, None),
            window: Optional[int] = None,
            nb_substeps: int = 1,
            hist_window: int = 7,
            refine_frame_len: Optional[int] = None,
            lengths=tuple(range(3, 100)),
            max_buckets: int = 4,
            do_predict: bool = True,
            do_hist: bool = True,
            do_refine: bool = True,
            export_csv: Optional[str] = None,
            export_xml: Optional[str] = None,
            fit_kwargs: Optional[dict] = None,
            params: Optional[tparams.Parameters] = None,
            sharded=False,
            verbose: int = 0,
            *,
            device=None,
            dtype=None) -> PipelineResult:
    """Run the full reference workflow on a CSV path or a track dict, on
    ``device`` (the card unless the caller names another; it raises where
    there is none) in ``dtype`` (float32 on the card, float64 elsewhere).

    Equivalent chain in the reference: readers.read_table ->
    tracking.param_fitting -> tracking.predict_Bs -> histograms.len_hist ->
    refined_localization.position_refinement -> exporters.save_extrack_2_CSV
    (Tutorial_ExTrack.ipynb), each stage re-entering the length-dict format.
    Here each stage runs on the same length buckets.  ``window`` (the fit's
    and the posteriors') defaults to ``fit.default_window``, the
    refinement's to ``refine.default_window`` at the longest bucket.
    ``sharded`` (True, or a ``parallel.mesh.Mesh``) shards every stage's
    tracks over the mesh (``fit.fit``, ``predict_batch``, ``hist_batch``
    and ``refine_batch`` with ``sharded``); with a process group every
    process reads the same input, runs its part of each stage and gets
    the whole result.
    """
    from extrack_tpu_torch import device as tdevice
    from extrack_tpu_torch import fit as tfit
    from extrack_tpu_torch import histograms, predict, refine

    if (export_csv or export_xml) and not do_predict:
        raise ValueError("export_csv/export_xml need the state posteriors; "
                         "call with do_predict=True")
    device, dtype = tdevice.resolve_device(device, dtype)
    timings = {}
    t0 = time.perf_counter()

    def lap(stage):
        nonlocal t0
        t1 = time.perf_counter()
        timings[stage] = t1 - t0
        t0 = t1

    frames = None
    if isinstance(tracks_or_path, str):
        from extrack_tpu_torch.io import readers
        tracks, frames, _ = readers.read_table(tracks_or_path,
                                               lengths=list(lengths))
        lap("read")
    else:
        tracks = tracks_or_path

    batches = tdata.from_dict_bucketed(tracks, max_buckets=max_buckets,
                                       device=device, dtype=dtype)
    # min_len is a DATASET property (shortest track present, reference
    # tracking.py:1009): every stage keeps one closing-gate convention
    min_len = tdata.default_min_len(
        np.concatenate([tdata.host_lengths(b) for b in batches]))
    if window is None:
        window = tfit.default_window(nb_states, nb_substeps)
    if refine_frame_len is None:
        refine_frame_len = refine.default_window(
            nb_states, max(b.max_len for b in batches))

    lap("batch")
    spec = params if params is not None else tparams.generate_params(
        nb_states=nb_states, estimated_LocErr=0.025, D_max=10.0,
        estimated_transition_rates=0.1)
    res = tfit.fit(batches, spec, dt, nb_states, cell_dims=cell_dims,
                   nb_substeps=nb_substeps, window=window, verbose=verbose,
                   sharded=sharded, **(fit_kwargs or {}))
    values = res.params.resolve()
    lap("fit")

    preds_dict = None
    if do_predict:
        preds_dict = {}
        for b in batches:
            _, preds = predict.predict_batch(b, values, dt, nb_states,
                                             cell_dims=cell_dims,
                                             window=window, min_len=min_len,
                                             sharded=sharded)
            preds_dict.update(tdata.to_dict(b, preds))
        lap("predict")

    hist = None
    if do_hist:
        for b in batches:
            h = histograms.hist_batch(
                b, values, dt, cell_dims=cell_dims, nb_states=nb_states,
                nb_substeps=nb_substeps, window=hist_window, min_len=min_len,
                sharded=sharded)
            if hist is None:
                hist = np.array(h, dtype=np.float64)
            else:                      # buckets have different max lengths
                if h.shape[0] > hist.shape[0]:
                    hist, h = np.array(h, dtype=np.float64), hist
                hist[:h.shape[0]] += h
        lap("hist")

    mus = sigmas = None
    if do_refine:
        loc_err, ds, _, trmat = refine.refinement_args(values, nb_states, dt)
        mus, sigmas = {}, {}
        for b in batches:
            mu, sig, _ = refine.refine_batch(b, loc_err, ds, trmat,
                                             frame_len=refine_frame_len,
                                             sharded=sharded)
            mus.update(tdata.to_dict(b, mu))
            sigmas.update(tdata.to_dict(b, sig[..., 0]))
        lap("refine")

    if export_csv or export_xml:
        from extrack_tpu_torch.io import exporters
        if export_csv:
            exporters.save_extrack_2_CSV(export_csv, tracks, preds_dict, dt,
                                         all_frames=frames)
        if export_xml:
            exporters.save_extrack_2_xml(tracks, preds_dict, res.params,
                                         export_xml, dt, all_frames=frames)
        lap("export")

    return PipelineResult(fit=res, preds=preds_dict, hist=hist,
                          mus=mus, sigmas=sigmas, tracks=tracks,
                          frames=frames, timings=timings)
