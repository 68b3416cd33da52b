"""Plots: state-duration histograms and posterior-colored track galleries.

Equivalents of extrack/visualization.py and of the JAX package's
``extrack_tpu/visualization.py``: visualize_states_durations (:6-59),
visualize_tracks (:61-91), plot_tracks (:93-215).  Works on the DataFrames
produced by ``io.exporters.extrack_2_pandas``; matplotlib's Agg backend
(no display).  ``visualize_states_durations`` computes its histogram with
``histograms.len_hist`` on ``device`` (the card by default: K5) unless it
is handed one.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

import matplotlib
matplotlib.use("Agg")
from matplotlib import cm, pyplot as plt  # noqa: E402

from extrack_tpu_torch import histograms as thist


def visualize_states_durations(all_tracks,
                               params,
                               dt,
                               cell_dims=(1.0, None, None),
                               nb_states: int = 2,
                               max_nb_states: int = 500,
                               workers: int = 1,
                               long_tracks: bool = True,
                               nb_steps_lim: int = 20,
                               steps: bool = False,
                               input_LocErr=None,
                               window: int = 7,
                               hists: Optional[np.ndarray] = None,
                               ax=None,
                               *,
                               device=None,
                               dtype=None):
    """Log-scale plot of the posterior state-duration distributions.
    Reference: visualization.py:6-59.  Returns the histogram array.
    ``window`` is forwarded to len_hist (the fusion window of the default
    engine; the GUI's frame_len option maps here).  Pass a precomputed
    ``hists`` (T, S) array to plot it directly without recomputing;
    else ``len_hist`` runs on ``device`` in ``dtype``."""
    if hists is None:
        if long_tracks:
            all_tracks = {k: v for k, v in all_tracks.items()
                          if int(k) >= nb_steps_lim} or all_tracks
        hists = thist.len_hist(all_tracks, params, dt, cell_dims=cell_dims,
                               nb_states=nb_states,
                               max_nb_states=max_nb_states,
                               workers=workers, input_LocErr=input_LocErr,
                               window=window, device=device, dtype=dtype)
    scale = 1.0 if steps else dt
    unit = "step" if steps else "s"
    if ax is None:
        plt.figure(figsize=(3, 3))
        ax = plt.gca()
    for s in range(hists.shape[1]):
        h = hists[:, s]
        ax.plot(np.arange(1, len(h) + 1) * scale, h / max(h.sum(), 1e-300),
                label=f"state {s}")
    ax.legend()
    ax.set_yscale("log")
    ax.grid(True)
    ax.set_xlim([0, nb_steps_lim * scale])
    ax.set_ylim([0.001, 0.5])
    ax.set_xlabel(f"state duration ({unit})")
    ax.set_ylabel("fraction")
    plt.tight_layout()
    return hists


def _pred_columns(df):
    cols = sorted(c for c in df.columns if c.startswith("pred_"))
    return cols


def _state_colors(preds: np.ndarray):
    """Map per-point posteriors to RGBA colors (2 states: brg gradient;
    3 states: RGB mixing; more: dominant-state tab colors).
    Reference: visualization.py:84-87,144-171."""
    nb_states = preds.shape[1]
    if nb_states == 1:
        return cm.viridis(preds[:, 0])
    if nb_states == 2:
        return cm.brg(preds[:, 1] * 0.5)
    if nb_states == 3:
        return np.clip(preds[:, ::-1], 0, 1)
    cmap = cm.tab10 if nb_states <= 10 else (
        cm.tab20 if nb_states <= 20 else cm.hsv)
    return np.array([cmap(int(s)) for s in preds.argmax(1)])


def visualize_tracks(DATA, track_length_range=(10, np.inf), figsize=(5, 5),
                     max_tracks: Optional[int] = None):
    """Scatter all tracks in the FOV colored by state posterior.
    Reference: visualization.py:61-91."""
    cols = _pred_columns(DATA)
    plt.figure(figsize=figsize)
    ids = np.unique(DATA["TRACK_ID"])[::-1]
    if max_tracks:
        ids = ids[:max_tracks]
    for tid in ids:
        track = DATA[DATA["TRACK_ID"] == tid]
        # the reference's own comparison (visualization.py:73) reduces to
        # len >= lower bound — its upper bound never applies; honor the
        # documented range instead (DEVIATIONS.md)
        if track_length_range[0] <= len(track) <= track_length_range[1]:
            colors = _state_colors(track[cols].to_numpy())
            plt.plot(track["POSITION_X"], track["POSITION_Y"], "k:",
                     alpha=0.2)
            plt.scatter(track["POSITION_X"], track["POSITION_Y"], c=colors,
                        s=3)
    plt.gca().set_aspect("equal", adjustable="datalim")
    return plt.gcf()


def plot_tracks(DATA, max_track_length: int = 50,
                nb_subplots: Sequence[int] = (5, 5), figsize=(10, 10),
                lim: float = 0.4):
    """Gallery of the longest tracks (each centered), colored by state.
    Reference: visualization.py:93-215."""
    cols = _pred_columns(DATA)
    nb_states = len(cols)
    fig = plt.figure(figsize=figsize)
    sizes = DATA.groupby("TRACK_ID").size()
    ids = sizes[sizes <= max_track_length].index.to_numpy()[::-1]
    n_plots = min(len(ids), int(np.prod(nb_subplots)))
    for k, tid in enumerate(ids[:n_plots]):
        ax = fig.add_subplot(nb_subplots[0], nb_subplots[1], k + 1)
        track = DATA[DATA["TRACK_ID"] == tid]
        colors = _state_colors(track[cols].to_numpy())
        ax.plot(track["POSITION_X"], track["POSITION_Y"], "k:", alpha=0.2)
        ax.scatter(track["POSITION_X"], track["POSITION_Y"], c=colors, s=3)
        cx, cy = track["POSITION_X"].mean(), track["POSITION_Y"].mean()
        ax.set_xlim([cx - lim, cx + lim])
        ax.set_ylim([cy - lim, cy + lim])
        ax.set_aspect("equal", adjustable="box")
        ax.tick_params(labelsize=6)
    handles = []
    for s in range(nb_states):
        color = _state_colors(np.eye(nb_states)[s][None])[0]
        handles.append(plt.Line2D([0], [0], marker="o", color="w",
                                  markerfacecolor=color, markersize=5,
                                  label=f"State {s}", linestyle="None"))
    fig.legend(handles=handles, loc="center right",
               bbox_to_anchor=(0.98, 0.5), fontsize=8)
    fig.tight_layout(h_pad=1, w_pad=1)
    fig.subplots_adjust(right=0.85)
    return fig
