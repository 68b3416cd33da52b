"""Exporters: fitted parameters and annotated tracks to JSON/CSV/XML/pandas.

Functional equivalents of extrack/exporters.py and of the JAX package's
``extrack_tpu/io/exporters.py``: save_params (:7-26), extrack_2_matrix
(:28-53), extrack_2_pandas (:58-102), save_extrack_2_CSV (:152-177),
save_extrack_2_xml (:179-228) and the TrackMate-compatible
save_extrack_2_input_xml (:231-319, built with ElementTree and
programmatic feature declarations).  The files are the JAX package's, byte
for byte on the same inputs: a params JSON written by either package loads
in the other.  Host code over numpy arrays.
"""
from __future__ import annotations

import json
import pickle
import xml.etree.ElementTree as ET
from typing import Dict
from xml.sax.saxutils import escape as xml_escape

import numpy as np
import pandas as pd

from extrack_tpu_torch import params as tparams


def _values_of(params) -> Dict[str, float]:
    if isinstance(params, tparams.Parameters):
        return params.valuesdict()
    return {k: float(v) for k, v in dict(params).items()}


def save_params(params, path: str = ".", fmt: str = "json",
                file_name: str = "params"):
    """Persist fitted parameter values (json / pkl / npy / csv).
    Reference: exporters.py:7-26."""
    vals = _values_of(params)
    base = f"{path}/{file_name}"
    if fmt == "npy":
        np.save(base, vals)
    elif fmt == "pkl":
        with open(base + ".pkl", "wb") as fh:
            pickle.dump(vals, fh)
    elif fmt == "json":
        with open(base + ".json", "w") as fh:
            json.dump(vals, fh)
    elif fmt == "csv":
        with open(base + ".csv", "w") as fh:
            for k, v in vals.items():
                fh.write(f"{k},{v}\n")
    else:
        raise ValueError("format not supported, use 'json', 'pkl', 'npy' "
                         "or 'csv'")


def load_params(path: str) -> tparams.Parameters:
    """Load values saved by save_params into a (fixed) Parameters object."""
    if path.endswith(".json"):
        with open(path) as fh:
            vals = json.load(fh)
    elif path.endswith(".pkl"):
        with open(path, "rb") as fh:
            vals = pickle.load(fh)
    elif path.endswith(".npy"):
        vals = np.load(path, allow_pickle=True).item()
    else:
        raise ValueError("expected a .json/.pkl/.npy file")
    if "values" in vals and isinstance(vals["values"], dict):
        vals = vals["values"]          # CLI fit-result payload
    spec = tparams.Parameters()
    for k, v in vals.items():
        spec.add(k, float(v), vary=False)
    return spec


def _default_frames(all_tracks):
    return {l: np.repeat(np.arange(int(l))[None], len(all_tracks[l]), 0)
            for l in all_tracks}


def extrack_2_pandas(all_tracks, pred_Bs, frames=None, opt_metrics=None
                     ) -> pd.DataFrame:
    """Flatten (tracks, posteriors) dicts into one DataFrame with pred_i
    columns.  Reference: exporters.py:58-102."""
    opt_metrics = opt_metrics or {}
    if frames is None:
        frames = _default_frames(all_tracks)
    nb_dims = next(iter(all_tracks.values())).shape[2]
    nb_states = next(iter(pred_Bs.values())).shape[2]

    parts = []
    track_id = 0
    for l in all_tracks:
        arr = all_tracks[l]
        b, t, _ = arr.shape
        cols = {}
        for d, name in enumerate(["POSITION_X", "POSITION_Y",
                                  "POSITION_Z"][:nb_dims]):
            cols[name] = arr[:, :, d].reshape(-1)
        cols["FRAME"] = np.asarray(frames[l]).reshape(-1).astype(int)
        cols["TRACK_ID"] = np.repeat(np.arange(track_id, track_id + b), t)
        for s in range(nb_states):
            cols[f"pred_{s}"] = pred_Bs[l][:, :, s].reshape(-1)
        for m in opt_metrics:
            cols[m] = np.asarray(opt_metrics[m][l]).reshape(-1)
        parts.append(pd.DataFrame(cols))
        track_id += b
    return pd.concat(parts, ignore_index=True)


def extrack_2_matrix(all_tracks, pred_Bs, dt, all_frames=None) -> np.ndarray:
    """Flat numeric matrix [x, y(, z), track_id, frame, pred_0..] — the
    reference's column order (exporters.py:28-53 concatenates positions,
    track IDs, frames, predictions), which differs from the DataFrame's
    FRAME-before-TRACK_ID layout."""
    df = extrack_2_pandas(all_tracks, pred_Bs, frames=all_frames)
    pos = [c for c in ("POSITION_X", "POSITION_Y", "POSITION_Z")
           if c in df.columns]
    # numeric suffix order: a lexicographic sort scrambles >= 11 states
    preds = sorted((c for c in df.columns if c.startswith("pred_")),
                   key=lambda c: int(c.split("_")[1]))
    return df[pos + ["TRACK_ID", "FRAME"] + preds].to_numpy(np.float64)


# the reference ships two implementations of the same flattening
# (exporters.py:58 and :105); one suffices here
extrack_2_pandas2 = extrack_2_pandas


def save_extrack_2_CSV(path, all_tracks, pred_Bss, dt, all_frames=None):
    """CSV with TRACK_ID, 3D positions, time, frame and per-state
    predictions.  Reference: exporters.py:152-177.  The JAX package's
    file, byte for byte, formatted a column at a time: numpy's ``str`` of
    an array's elements is its scalars' ``str``, which the JAX package's
    per-row f-string writes, and the time column is the same
    ``dt * frame * 1000`` in the frames' dtype."""
    if all_frames is None:
        all_frames = _default_frames(all_tracks)
    nb_states = next(iter(pred_Bss.values())).shape[2]
    with open(path, "w") as fh:
        pred_hdr = "".join(f"PRED_{k}," for k in range(nb_states))
        fh.write(f"TRACK_ID,POSITION_X,POSITION_Y,POSITION_Z,POSITION_T,"
                 f"FRAME,{pred_hdr}\n")
        track_id = 0
        for l in all_tracks:
            arr = np.asarray(all_tracks[l])
            b, t = arr.shape[:2]
            pos3 = np.zeros((b, t, 3))
            pos3[:, :, :arr.shape[2]] = arr
            frames = np.asarray(all_frames[l])[:, :t].reshape(-1)
            preds = np.asarray(pred_Bss[l])[:, :t].reshape(b * t, -1)
            cols = [np.repeat(np.arange(track_id + 1, track_id + b + 1), t),
                    *pos3.reshape(-1, 3).T, dt * frames * 1000,
                    frames.astype(np.int64), *preds.T]
            rows = zip(*(c.astype(str).tolist() for c in cols))
            fh.write("".join(",".join(r) + "\n" for r in rows))
            track_id += b


def refined_2_pandas(all_tracks, mus, sigmas, all_frames=None
                     ) -> pd.DataFrame:
    """One row per localization of the refined tracks: TRACK_ID (numbered
    from 0 in the dicts' order), FRAME (when ``all_frames`` is given),
    X_OBS, Y_OBS, X_REFINED, Y_REFINED and SIGMA (the refinement's std).
    The table the CLI's ``refine`` and the GUI's Position Refinement
    write (``extrack_tpu/cli.py:154-167``, ``gui.py:331-340``), built a
    column at a time."""
    keys = list(all_tracks)
    obs = np.concatenate([np.asarray(all_tracks[k])[:, :int(k), :2]
                          .reshape(-1, 2) for k in keys])
    ref = np.concatenate([np.asarray(mus[k])[:, :int(k), :2]
                          .reshape(-1, 2) for k in keys])
    counts = [len(all_tracks[k]) for k in keys]
    cols = {"TRACK_ID": np.repeat(np.arange(sum(counts)), np.repeat(
        [int(k) for k in keys], counts))}
    if all_frames is not None:
        cols["FRAME"] = np.concatenate([
            np.asarray(all_frames[k])[:, :int(k)].reshape(-1)
            for k in keys]).astype(int)
    cols.update(X_OBS=obs[:, 0], Y_OBS=obs[:, 1], X_REFINED=ref[:, 0],
                Y_REFINED=ref[:, 1], SIGMA=np.concatenate([
                    np.asarray(sigmas[k])[:, :int(k)].reshape(-1)
                    for k in keys]))
    return pd.DataFrame(cols)


def _params_attr(params) -> str:
    vals = _values_of(params)
    return " ".join(f"{k}='{np.round(v, 8)}'" for k, v in vals.items()
                    if "_" not in k)


def _attr(text: str) -> str:
    """An attribute value escaped as ElementTree's serializer escapes it."""
    return xml_escape(text, {'"': "&quot;", "\r": "&#13;", "\n": "&#10;",
                             "\t": "&#09;"})


def save_extrack_2_xml(all_tracks, pred_Bss, params, path, dt,
                       all_frames=None, opt_metrics=None):
    """TrackMate-'Tracks'-style XML with per-detection predictions.
    Reference: exporters.py:179-228.  The JAX package's file (an
    ElementTree, indented, with its declaration), byte for byte, written
    a column at a time: the values are the ``str`` of each array's
    elements, as there, and the markup is ElementTree's (attributes in
    insertion order, ``" />"`` for an empty element, two spaces a level,
    its attribute escapes)."""
    opt_metrics = opt_metrics or {}
    if all_frames is None:
        all_frames = _default_frames(all_tracks)
    n_tracks = sum(len(all_tracks[l]) for l in all_tracks)
    head = (f'<Tracks nTracks="{n_tracks}" spaceUnits="µm" '
            f'frameInterval="{_attr(str(dt))}" timeUnits="ms" '
            f'ExTrack_results="{_attr(_params_attr(params))}"')
    particles = []
    for l in all_tracks:
        arr = np.asarray(all_tracks[l])
        preds = np.asarray(pred_Bss[l])
        frames = np.asarray(all_frames[l])
        b = min(len(arr), len(preds), len(frames))
        t = min(arr.shape[1], preds.shape[1], frames.shape[1])
        pos3 = np.zeros((b, t, 3))
        pos3[:, :, :arr.shape[2]] = arr[:b, :t]
        cols = [("t", frames[:b, :t].astype(np.int64).reshape(-1)),
                ("x", pos3[..., 0].reshape(-1)),
                ("y", pos3[..., 1].reshape(-1)),
                ("z", pos3[..., 2].reshape(-1))]
        cols += [(f"pred_{s}", preds[:b, :t, s].reshape(-1))
                 for s in range(preds.shape[2])]
        strs = [[f' {name}="'] * (b * t) for name, _ in cols]
        for (name, c), pre in zip(cols, strs):
            pre[:] = [p + v + '"' for p, v in zip(pre, c.astype(str))]
        for m in opt_metrics:
            vals = np.asarray(opt_metrics[m][l])[:b, :t].astype(str)
            strs.append([f' {m}="{_attr(v)}"' for v in vals.reshape(-1)])
        dets = ["    <detection" + "".join(r) + " />" for r in zip(*strs)]
        for i in range(b):
            inner = dets[i * t:(i + 1) * t]
            particles.append(
                f'  <particle nSpots="{_attr(str(l))}">\n'
                + "\n".join(inner) + "\n  </particle>" if inner
                else f'  <particle nSpots="{_attr(str(l))}" />')
    body = (head + ">\n" + "\n".join(particles) + "\n</Tracks>"
            if particles else head + " />")
    with open(path, "w", encoding="utf-8",
              errors="xmlcharrefreplace") as fh:
        fh.write("<?xml version='1.0' encoding='utf-8'?>\n" + body)


_SPOT_FEATURES = [
    ("QUALITY", "Quality", "QUALITY", False),
    ("POSITION_X", "X", "POSITION", False),
    ("POSITION_Y", "Y", "POSITION", False),
    ("POSITION_Z", "Z", "POSITION", False),
    ("POSITION_T", "T", "TIME", False),
    ("FRAME", "Frame", "NONE", True),
    ("RADIUS", "Radius", "LENGTH", False),
    ("VISIBILITY", "Visibility", "NONE", True),
]
_TRACK_FEATURES = [
    ("TRACK_INDEX", "Track index", "NONE", True),
    ("TRACK_ID", "Track ID", "NONE", True),
    ("NUMBER_SPOTS", "Number of spots in track", "NONE", True),
    ("TRACK_DURATION", "Track duration", "TIME", False),
    ("TRACK_START", "Track start", "TIME", False),
    ("TRACK_STOP", "Track stop", "TIME", False),
]
_EDGE_FEATURES = [
    ("SPOT_SOURCE_ID", "Source spot ID", "NONE", True),
    ("SPOT_TARGET_ID", "Target spot ID", "NONE", True),
    ("EDGE_TIME", "Edge time", "TIME", False),
]


def save_extrack_2_input_xml(all_tracks, pred_Bss, params, path, dt,
                             all_frames=None, opt_metrics=None):
    """Full TrackMate-file XML loadable by the TrackMate GUI plugin.

    Reference: exporters.py:231-319.  Rebuilt programmatically: a Model
    section with feature declarations + AllSpots/AllTracks/FilteredTracks,
    per-spot EXTRACK probability features, and minimal Settings.
    """
    opt_metrics = opt_metrics or {}
    if all_frames is None:
        all_frames = _default_frames(all_tracks)
    nb_states = next(iter(pred_Bss.values())).shape[2]

    tm = ET.Element("TrackMate", version="7.7.2")
    model = ET.SubElement(tm, "Model", spatialunits="µm", timeunits="s")
    model.set("ExTrack_results", _params_attr(params))
    decl = ET.SubElement(model, "FeatureDeclarations")

    def _features(parent_name, feats):
        parent = ET.SubElement(decl, parent_name)
        for feature, name, dim, isint in feats:
            ET.SubElement(parent, "Feature", feature=feature, name=name,
                          shortname=name, dimension=dim,
                          isint=str(isint).lower())
        return parent

    spot_feats = _features("SpotFeatures", _SPOT_FEATURES)
    for s in range(nb_states):
        ET.SubElement(spot_feats, "Feature", feature=f"EXTRACK_P_{s}",
                      name=f"Probability state {s}", shortname=f"P {s}",
                      dimension="NONE", isint="false")
    _features("EdgeFeatures", _EDGE_FEATURES)
    _features("TrackFeatures", _TRACK_FEATURES)

    # spots, grouped per frame
    n_spots = sum(all_tracks[l].shape[0] * all_tracks[l].shape[1]
                  for l in all_tracks)
    all_spots = ET.SubElement(model, "AllSpots", nspots=str(n_spots))
    frames_present = sorted({int(f) for l in all_frames
                             for f in np.asarray(all_frames[l]).ravel()})
    spot_ids = {l: np.zeros(np.asarray(all_frames[l]).shape, dtype=int)
                for l in all_tracks}
    spot_id = 0
    for frame in frames_present:
        sif = ET.SubElement(all_spots, "SpotsInFrame", frame=str(frame))
        for l in all_tracks:
            arr = all_tracks[l]
            frs = np.asarray(all_frames[l])
            hits = np.argwhere(frs == frame)
            for (i, j) in hits:
                pos = np.zeros(3)
                pos[:arr.shape[2]] = arr[i, j]
                spot = ET.SubElement(
                    sif, "Spot", ID=str(spot_id), name=f"ID{spot_id}",
                    VISIBILITY="1", RADIUS="0.25", QUALITY="1.0",
                    POSITION_T=str(frame * dt), POSITION_X=str(pos[0]),
                    POSITION_Y=str(pos[1]), POSITION_Z=str(pos[2]),
                    FRAME=str(frame))
                for s in range(nb_states):
                    spot.set(f"EXTRACK_P_{s}", str(pred_Bss[l][i, j, s]))
                spot_ids[l][i, j] = spot_id
                spot_id += 1

    all_tr = ET.SubElement(model, "AllTracks")
    track_id = 0
    for l in all_tracks:
        frs = np.asarray(all_frames[l])
        for i in range(all_tracks[l].shape[0]):
            fr = frs[i]
            tr = ET.SubElement(
                all_tr, "Track", name=f"Track_{track_id}",
                TRACK_ID=str(track_id), TRACK_INDEX=str(track_id),
                NUMBER_SPOTS=str(int(l)),
                TRACK_DURATION=str((fr[-1] - fr[0]) * dt),
                TRACK_START=str(fr[0] * dt), TRACK_STOP=str(fr[-1] * dt))
            for j in range(1, int(l)):
                ET.SubElement(tr, "Edge",
                              SPOT_SOURCE_ID=str(spot_ids[l][i, j - 1]),
                              SPOT_TARGET_ID=str(spot_ids[l][i, j]),
                              EDGE_TIME=str((fr[j - 1] + 0.5) * dt))
            track_id += 1
    filtered = ET.SubElement(model, "FilteredTracks")
    for t in range(track_id):
        ET.SubElement(filtered, "TrackID", TRACK_ID=str(t))
    settings = ET.SubElement(tm, "Settings")
    ET.SubElement(settings, "ImageData", filename="blank", folder="",
                  width="512", height="512", nslices="1",
                  nframes=str(max(frames_present) + 1),
                  pixelwidth="1.0", pixelheight="1.0", voxeldepth="0.0",
                  timeinterval=str(dt))
    ET.indent(tm)
    ET.ElementTree(tm).write(path, encoding="utf-8", xml_declaration=True)
