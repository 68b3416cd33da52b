"""Track file readers: tables (CSV/pickle) and TrackMate XML.

Functional equivalents of the reference readers (extrack/readers.py:5-221)
and of the JAX package's (``extrack_tpu/io/readers.py``): the same filters
(track length whitelist with truncation, maximum jump distance, frame
boundaries, zero-displacement removal), the same length-keyed dict output
and the same optional-metric capture.  TrackMate XML parses with the
stdlib ElementTree; tables go through vectorized numpy passes after either
the multithreaded native parser (``io.native``, the port's own build of
``native/track_reader.cpp``) or pandas.  Host code: the tracks reach the
card through ``data.from_dict`` / ``from_dict_bucketed``.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence

import numpy as np
import pandas as pd


def _bucket_tracks(xy, frames_col, track_ids, lengths, opt_cols,
                   opt_names):
    """Group contiguous per-row arrays by track and bucket by length —
    fully vectorized (one fancy-index gather per bucket)."""
    lengths = np.asarray(sorted(int(l) for l in lengths))
    lmin, lmax = lengths[0], lengths[-1]
    # boundaries of contiguous track groups (rows pre-sorted by ID, frame)
    if len(track_ids) == 0:
        return {}, {}, {m: {} for m in opt_names}
    change = np.nonzero(track_ids[1:] != track_ids[:-1])[0] + 1
    starts = np.concatenate([[0], change])
    counts = np.diff(np.concatenate([starts, [len(track_ids)]]))
    # bucket length per track: largest allowed length <= count, capped at
    # lmax (truncation), dropped below lmin (readers.py:185-203)
    take = np.where(counts > lmax, lmax, 0)
    mid = (counts >= lmin) & (counts <= lmax)
    take[mid] = lengths[np.searchsorted(lengths, counts[mid], "right") - 1]

    out_t: Dict[str, np.ndarray] = {}
    out_f: Dict[str, np.ndarray] = {}
    out_o: Dict[str, Dict[str, np.ndarray]] = {m: {} for m in opt_names}
    for L in np.unique(take):
        if L == 0:
            continue
        sel = take == L
        rows = starts[sel][:, None] + np.arange(L)[None, :]
        key = str(int(L))
        out_t[key] = xy[rows]
        out_f[key] = frames_col[rows]
        for m in opt_names:
            out_o[m][key] = opt_cols[m][rows]
    return out_t, out_f, out_o


def read_table(paths,
               lengths: Sequence[int] = tuple(range(5, 40)),
               dist_th: float = np.inf,
               frames_boundaries=(-np.inf, np.inf),
               fmt: str = "csv",
               colnames: Sequence[str] = ("POSITION_X", "POSITION_Y",
                                          "FRAME", "TRACK_ID"),
               opt_colnames: Sequence[str] = (),
               remove_no_disp: bool = True,
               engine: str = "auto"):
    """Read tracks from CSV / pickle / custom-separator tables.

    Reference: read_table, extrack/readers.py:101-221.  ``colnames`` holds
    the spatial columns, the frame column, and the track-ID column (which
    may itself be a list of columns combined into a composite ID,
    readers.py:142-152).  Returns (tracks, frames, opt_metrics) dicts keyed
    by track length.

    ``engine``: 'auto' tries the multithreaded native C++ parser
    (``io.native``) for plain numeric CSVs and takes pandas for the rest
    (quoted fields, string or blank track IDs, composite IDs, pickles) or
    where the parser cannot be built; 'pandas' forces pandas; 'native'
    raises where the parser cannot be built or cannot take the file.
    """
    if isinstance(paths, (str, np.str_)):
        paths = [paths]
    colnames = list(colnames)
    nb_dims = len(colnames) - 2
    frame_col, id_col = colnames[-2], colnames[-1]

    if engine in ("auto", "native") and fmt != "pkl" \
            and isinstance(id_col, (str, np.str_)):
        out = _read_table_native(paths, lengths, dist_th, frames_boundaries,
                                 "," if fmt == "csv" else fmt, colnames,
                                 opt_colnames, remove_no_disp)
        if out is not None:
            return out
        if engine == "native":
            from extrack_tpu_torch.io import native
            why = native.build_error() or (
                "the file has quoted fields, non-numeric or blank cells "
                "in the position, frame or ID columns, or lacks a column")
            raise RuntimeError(f"engine='native' cannot read {paths}: {why}")

    all_xy: List[np.ndarray] = []
    all_fr: List[np.ndarray] = []
    all_id: List[np.ndarray] = []
    all_opt = {m: [] for m in opt_colnames}
    id_offset = 0
    for path in paths:
        if fmt == "csv":
            df = pd.read_csv(path)
        elif fmt == "pkl":
            df = pd.read_pickle(path)
        else:
            df = pd.read_csv(path, sep=fmt)
        for c in colnames[:nb_dims] + [frame_col]:
            if not pd.api.types.is_numeric_dtype(df.dtypes[c]):
                raise ValueError(
                    f"column {c!r} is not numerical — check for extra "
                    "header rows in the file")
        cur_id = id_col          # never reassign id_col: the next file's
        if isinstance(id_col, (list, tuple)):     # iteration re-reads it
            na = pd.isna(df[list(id_col)]).any(axis=1)
            for c in id_col:
                na |= df[c].astype(str) == "None"
            df = df[~na]
            composite = df[id_col[0]].astype(str)
            for c in id_col[1:]:
                composite = composite + "_" + df[c].astype(str)
            df = df.assign(__track_id__=composite)
            cur_id = "__track_id__"
        else:
            na = pd.isna(df[id_col]) | (df[id_col].astype(str) == "None")
            if na.any():
                try:
                    # isolated peaks get fresh unique integer IDs
                    # (readers.py:153-157)
                    max_id = int(pd.to_numeric(df.loc[~na, id_col]).max())
                    df = df.copy()
                    df.loc[na, id_col] = np.arange(
                        max_id + 1, max_id + 1 + int(na.sum()))
                except (ValueError, TypeError):
                    df = df[~na]
        df = df.sort_values([cur_id, frame_col], kind="stable")
        codes, _ = pd.factorize(df[cur_id], sort=False)
        all_xy.append(df[colnames[:nb_dims]].to_numpy(np.float64))
        all_fr.append(df[frame_col].to_numpy(np.float64))
        all_id.append(codes + id_offset)
        id_offset += codes.max() + 1 if len(codes) else 0
        for m in opt_colnames:
            all_opt[m].append(df[m].to_numpy())

    xy = np.concatenate(all_xy)
    fr = np.concatenate(all_fr)
    ids = np.concatenate(all_id)
    opt_cols = {m: np.concatenate(all_opt[m]) for m in opt_colnames}

    # --- vectorized per-track filters --------------------------------------
    same = np.concatenate([[False], ids[1:] == ids[:-1]])
    d2 = np.concatenate([np.zeros((1, xy.shape[1])), np.diff(xy, axis=0)**2])
    step_d2 = np.where(same[:, None], d2, np.nan).sum(1)
    uniq, inv = np.unique(ids, return_inverse=True)
    n_tracks = len(uniq)

    def per_track(values, func, init):
        out = np.full(n_tracks, init, dtype=np.float64)
        func.at(out, inv, values)
        return out

    n_steps = np.bincount(inv, weights=same.astype(float))
    zero_steps = np.bincount(inv, weights=(same & (step_d2 == 0)))
    with np.errstate(invalid="ignore"):
        frac_zero = np.where(n_steps > 0, zero_steps / np.maximum(n_steps, 1),
                             0.0)
    max_d = per_track(np.where(same, np.sqrt(step_d2), 0.0), np.maximum, 0.0)
    first_frame = np.full(n_tracks, np.inf)
    np.minimum.at(first_frame, inv, fr)

    ok = (max_d <= dist_th) & (first_frame >= frames_boundaries[0]) \
        & (first_frame <= frames_boundaries[1])
    if remove_no_disp:
        ok &= frac_zero <= 0.05
    keep_rows = ok[inv]
    return _bucket_tracks(xy[keep_rows], fr[keep_rows], ids[keep_rows],
                          lengths,
                          {m: opt_cols[m][keep_rows] for m in opt_colnames},
                          list(opt_colnames))


def _read_table_native(paths, lengths, dist_th, frames_boundaries, sep,
                       colnames, opt_colnames, remove_no_disp):
    """Native-parser fast path: numeric columns only, single ID column.
    Returns None when the library or a required column is unavailable, or
    when IDs are non-numeric (pandas path handles those)."""
    from extrack_tpu_torch.io import native
    if not native.available():
        return None
    nb_dims = len(colnames) - 2
    cols = list(colnames) + list(opt_colnames)
    parts = []
    for path in paths:
        arr = native.parse_csv_columns(str(path), cols, sep=sep)
        if arr is None:
            return None
        parts.append(arr)
    raw = np.concatenate(parts) if len(parts) > 1 else parts[0]
    if np.isnan(raw[:, :nb_dims + 1]).any():
        return None                      # non-numeric x/y/frame cells
    id_vals = raw[:, nb_dims + 1]
    if np.isnan(id_vals).any():
        # a numeric parser can't tell blank/'None' IDs (isolated peaks,
        # readers.py:153-157) from a non-numeric ID column ('Track_0001');
        # treating string IDs as isolated peaks would shatter every track
        # into dropped singletons — silent total data loss.  The pandas
        # path resolves both correctly.
        return None
    order = np.lexsort((raw[:, nb_dims], id_vals))
    raw = raw[order]
    id_vals = id_vals[order]
    _, ids = np.unique(id_vals, return_inverse=True)
    xy = raw[:, :nb_dims]
    fr = raw[:, nb_dims]
    opt_cols = {m: raw[:, nb_dims + 2 + j]
                for j, m in enumerate(opt_colnames)}

    same = np.concatenate([[False], ids[1:] == ids[:-1]])
    d2 = np.concatenate([np.zeros((1, nb_dims)), np.diff(xy, axis=0) ** 2])
    step_d2 = np.where(same[:, None], d2, 0.0).sum(1)
    n_tracks = int(ids.max()) + 1 if len(ids) else 0
    n_steps = np.bincount(ids, weights=same.astype(float),
                          minlength=n_tracks)
    zero_steps = np.bincount(ids, weights=(same & (step_d2 == 0)),
                             minlength=n_tracks)
    frac_zero = np.where(n_steps > 0, zero_steps / np.maximum(n_steps, 1),
                         0.0)
    max_d = np.zeros(n_tracks)
    np.maximum.at(max_d, ids, np.where(same, np.sqrt(step_d2), 0.0))
    first_frame = np.full(n_tracks, np.inf)
    np.minimum.at(first_frame, ids, fr)
    ok = (max_d <= dist_th) & (first_frame >= frames_boundaries[0]) \
        & (first_frame <= frames_boundaries[1])
    if remove_no_disp:
        ok &= frac_zero <= 0.05
    keep = ok[ids]
    return _bucket_tracks(xy[keep], fr[keep], ids[keep], lengths,
                          {m: opt_cols[m][keep] for m in opt_colnames},
                          list(opt_colnames))


def read_trackmate_xml(paths,
                       lengths: Sequence[int] = tuple(range(5, 40)),
                       dist_th: float = 0.5,
                       frames_boundaries=(-np.inf, np.inf),
                       remove_no_disp: bool = True,
                       opt_metrics_names: Sequence[str] = (),
                       opt_metrics_types: Optional[Sequence] = None):
    """Read TrackMate 'Tracks' XML exports.

    Reference: read_trackmate_xml, extrack/readers.py:5-98 (which uses
    xmltodict; this parses with the stdlib).  Expects
    <Tracks frameInterval=..><particle><detection t= x= y= .../>.
    """
    if isinstance(paths, (str, np.str_)):
        paths = [paths]
    if opt_metrics_types is None:
        opt_metrics_types = ["float64"] * len(opt_metrics_names)

    rows_xy, rows_fr, rows_id = [], [], []
    rows_opt = {m: [] for m in opt_metrics_names}
    tid = 0
    for path in paths:
        root = ET.parse(path).getroot()
        if root.tag != "Tracks":
            raise ValueError(f"{path}: expected a TrackMate 'Tracks' export")
        for particle in root.iter("particle"):
            dets = particle.findall("detection")
            xy = np.array([[float(d.get("x")), float(d.get("y"))]
                           for d in dets])
            fr = np.array([int(float(d.get("t"))) for d in dets])
            order = np.argsort(fr, kind="stable")
            xy, fr = xy[order], fr[order]
            rows_xy.append(xy)
            rows_fr.append(fr.astype(np.float64))
            rows_id.append(np.full(len(dets), tid))
            for m in opt_metrics_names:
                rows_opt[m].append(
                    np.array([d.get(m) for d in dets], dtype=object)[order])
            tid += 1
    if not rows_xy:
        return {}, {}, {m: {} for m in opt_metrics_names}
    xy = np.concatenate(rows_xy)
    fr = np.concatenate(rows_fr)
    ids = np.concatenate(rows_id)
    opt_cols = {m: np.concatenate(rows_opt[m]) for m in opt_metrics_names}

    same = np.concatenate([[False], ids[1:] == ids[:-1]])
    dists = np.where(
        same, np.sqrt(np.concatenate(
            [np.zeros((1, 2)), np.diff(xy, axis=0) ** 2]).sum(1)), 0.0)
    n_tracks = tid
    uniq, inv = np.unique(ids, return_inverse=True)
    max_d = np.zeros(n_tracks)
    np.maximum.at(max_d, inv, dists)
    min_d2 = np.full(n_tracks, np.inf)
    np.minimum.at(min_d2, inv[same], dists[same] ** 2)
    first_frame = np.full(n_tracks, np.inf)
    np.minimum.at(first_frame, inv, fr)

    ok = (max_d < dist_th) & (first_frame >= frames_boundaries[0]) \
        & (first_frame <= frames_boundaries[1])
    if remove_no_disp:
        ok &= min_d2 > 0          # any zero displacement drops the track
    keep = ok[inv]
    traces, frames, opt = _bucket_tracks(
        xy[keep], fr[keep], ids[keep], lengths,
        {m: opt_cols[m][keep] for m in opt_metrics_names},
        list(opt_metrics_names))
    for m, typ in zip(opt_metrics_names, opt_metrics_types):
        for k in opt[m]:
            try:
                opt[m][k] = opt[m][k].astype(typ)
            except (ValueError, TypeError):
                print(f"Error of type with the optional metric: {m}")
    return traces, frames, opt
