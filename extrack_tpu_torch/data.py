"""Data model: padded, masked track batches of torch tensors.

The reference keeps datasets as dicts keyed by track length (string) with
arrays of shape ``(nb_tracks, track_len, nb_dims)`` (extrack/tracking.py:1318).
The engine and kernels want rectangular batches, so the container is a
padded batch with an explicit length vector; helpers convert to and from
the reference's dict format.  Length bucketing (``from_dict_bucketed``) keeps
short tracks from paying the longest track's step count.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from extrack_tpu_torch.device import resolve_device


class TrackBatch:
    """A batch of tracks padded to a common length.

    positions : (B, T, D) observed localizations, zero past ``lengths``.
    lengths : (B,) int32 number of valid localizations per track.
    loc_err : (B, T, D) per-peak localization error std, or None when the
        error is a fitted parameter.
    is_bleached : (B,) 1.0 if the track ended within the observation window,
        0.0 if it reached the dataset's maximum length (censored).
    frames : (B, T) optional frame indices.
    dt : optional (B, T-1) per-step frame intervals; None means the scalar
        dt passed to the model applies everywhere.
    np_lengths : host copy of ``lengths`` (numpy), so callers never pull
        them back from the device.
    """

    def __init__(self, positions, lengths, loc_err=None, is_bleached=None,
                 frames=None, dt=None, np_lengths=None):
        self.positions = positions
        self.lengths = lengths
        self.loc_err = loc_err
        self.is_bleached = is_bleached
        self.frames = frames
        self.dt = dt
        self.np_lengths = np_lengths

    @property
    def batch_size(self):
        return self.positions.shape[0]

    @property
    def max_len(self):
        return self.positions.shape[1]

    @property
    def nb_dims(self):
        return self.positions.shape[2]

    def __repr__(self):
        return (f"TrackBatch(B={self.batch_size}, T={self.max_len}, "
                f"D={self.nb_dims}, device={self.positions.device})")


def from_dict(all_tracks: Dict[str, np.ndarray],
              input_loc_err: Optional[Dict[str, np.ndarray]] = None,
              frames: Optional[Dict[str, np.ndarray]] = None,
              dt: Optional[Dict[str, np.ndarray]] = None,
              max_len: Optional[int] = None,
              pad_batch: int = 0,
              data_max: Optional[int] = None,
              *,
              device=None,
              dtype=None) -> TrackBatch:
    """Convert the reference's length-keyed dict format to a padded batch
    on ``device`` in ``dtype``.

    ``device`` defaults to the card (``"cuda"``), as the port's entry
    points do, and raises where there is none: pass ``device="cpu"`` for a
    batch on the CPU.  ``dtype`` defaults to float32 on the card, where
    the kernels compute, and float64 elsewhere.

    ``is_bleached`` follows the reference convention: tracks whose length
    equals the dataset maximum (``data_max``, default this dict's maximum)
    are censored (isBL=0), all others bleached or left the FOV
    (extrack/tracking.py:1037-1040).  ``max_len`` / ``pad_batch`` pad the
    time / track axes on the host before the one transfer.
    """
    device, dtype = resolve_device(device, dtype)
    keys = sorted((k for k in all_tracks if len(all_tracks[k]) > 0),
                  key=lambda s: int(s))
    if not keys:
        raise ValueError("No tracks found. The loaded tracks seem empty.")
    lens = [int(k) for k in keys]
    if data_max is None:
        data_max = max(lens)
    tmax = max_len or max(lens)

    # per-step dt tails pad with the dataset's median dt, so the survival
    # table's representative dt (build_tables) is the same after padding
    if dt is not None:
        dt_fill = dt_median(all_tracks, dt)
        dt_fill = 1.0 if dt_fill is None else dt_fill
    pos_l, len_l, err_l, frm_l, dt_l, bl_l = [], [], [], [], [], []
    for k in keys:
        arr = np.asarray(all_tracks[k], dtype=np.float64)
        b, t, d = arr.shape
        pos = np.zeros((b, tmax, d))
        pos[:, :t] = arr
        pos_l.append(pos)
        len_l.append(np.full((b,), t, dtype=np.int32))
        bl_l.append(np.full((b,), 0.0 if t == data_max else 1.0))
        if input_loc_err is not None:
            e = np.asarray(input_loc_err[k], dtype=np.float64)
            if e.ndim == 2:
                e = e[:, :, None]
            # the pad region stays positive: no log(0) in masked lanes
            err = np.ones((b, tmax, e.shape[2]))
            err[:, :t] = e
            err_l.append(err)
        if frames is not None:
            f = np.zeros((b, tmax))
            f[:, :t] = np.asarray(frames[k], dtype=np.float64)
            frm_l.append(f)
        if dt is not None:
            dd = np.asarray(dt[k], dtype=np.float64)
            step_dt = np.full((b, tmax - 1), dt_fill)
            n_steps = min(t - 1, dd.shape[1])
            step_dt[:, :n_steps] = dd[:, :n_steps]
            dt_l.append(step_dt)

    pos = np.concatenate(pos_l)
    lens_a = np.concatenate(len_l)
    err = np.concatenate(err_l) if err_l else None
    bl = np.concatenate(bl_l)
    frm = np.concatenate(frm_l) if frm_l else None
    dts = np.concatenate(dt_l) if dt_l else None
    if pad_batch > pos.shape[0]:
        extra = pad_batch - pos.shape[0]

        def _padb(x, fill=0.0):
            if x is None:
                return None
            w = [(0, extra)] + [(0, 0)] * (x.ndim - 1)
            return np.pad(x, w, constant_values=fill)

        pos, lens_a, bl, frm = _padb(pos), _padb(lens_a), _padb(bl), _padb(frm)
        err = _padb(err, 1.0)
        dts = _padb(dts, float(np.median(dts)) if dts is not None else 0.0)

    def _dev(x, dt_=dtype):
        return None if x is None else torch.as_tensor(x, dtype=dt_,
                                                      device=device)

    return TrackBatch(positions=_dev(pos), lengths=_dev(lens_a, torch.int32),
                      loc_err=_dev(err), is_bleached=_dev(bl),
                      frames=_dev(frm), dt=_dev(dts), np_lengths=lens_a)


def partition_cuts(lens, counts, max_buckets: int) -> list:
    """Exclusive end indices into the ascending distinct-length list
    ``lens`` (with per-length track ``counts``) minimizing total padded
    work sum(n_i * bucket_max_len_i) over <= max_buckets contiguous groups.

    Exact dynamic program over bucket boundaries, layered by bucket count:
    O(max_buckets * n^2) with n the number of distinct lengths.
    """
    n = len(lens)
    csum = np.concatenate([[0], np.cumsum(list(counts))])
    INF = float("inf")
    prev_cost = [0.0] + [INF] * n
    prev_cuts: list = [[]] + [None] * n
    for _ in range(min(max_buckets, n)):
        cur_cost = list(prev_cost)
        cur_cuts = list(prev_cuts)
        for j in range(1, n + 1):
            for i in range(j):
                if prev_cost[i] == INF:
                    continue
                cost = prev_cost[i] + (csum[j] - csum[i]) * lens[j - 1]
                if cost < cur_cost[j]:
                    cur_cost[j] = cost
                    cur_cuts[j] = prev_cuts[i] + [j]
        prev_cost, prev_cuts = cur_cost, cur_cuts
    return prev_cuts[n]


def from_dict_bucketed(all_tracks: Dict[str, np.ndarray],
                       max_buckets: int = 4,
                       canonical_shapes: bool = False,
                       **kw) -> list:
    """Split a length-keyed dict into a few padded TrackBatches so short
    tracks don't pay the longest track's step count.

    Bucket edges come from ``partition_cuts`` (minimum total padded work).
    The ``is_bleached`` convention stays global: only tracks at the
    dataset's maximum length are censored.  ``canonical_shapes`` is
    accepted for call compatibility and has no effect: eager PyTorch has no
    per-shape program to reuse.  Other keywords go to ``from_dict``
    (``device`` defaults to the card there).
    """
    del canonical_shapes
    lens = sorted(int(k) for k in all_tracks if len(all_tracks[k]) > 0)
    if not lens:
        raise ValueError("No tracks found. The loaded tracks seem empty.")
    counts = [len(all_tracks[str(l)]) for l in lens]
    cuts = partition_cuts(lens, counts, max_buckets)
    batches = []
    start = 0
    for end in cuts:
        group = {str(l): all_tracks[str(l)] for l in lens[start:end]}
        sub_kw = dict(kw)
        for name in ("input_loc_err", "frames", "dt"):
            if kw.get(name) is not None:
                sub_kw[name] = {k: kw[name][k] for k in group}
        batches.append(from_dict(group, data_max=max(lens), **sub_kw))
        start = end
    return batches


def dt_median(all_tracks: Dict[str, np.ndarray],
              dt: Optional[Dict[str, np.ndarray]]) -> Optional[float]:
    """The median of a dataset's per-step dt dict (the intervals of every
    track with a position, as ``from_dict`` pads with it), or None without
    one: the survival tables' representative dt
    (``tables.build_tables``) of the dataset as one batch, which
    ``len_hist`` and ``predict_Bs`` give every length bucket."""
    if dt is None:
        return None
    keys = [k for k in all_tracks if len(all_tracks[k]) > 0]
    steps = np.concatenate([np.asarray(dt[k], dtype=np.float64).ravel()
                            for k in keys])
    return float(np.median(steps)) if steps.size else None


def host_lengths(batch: TrackBatch) -> np.ndarray:
    """Lengths as a host array, from the cache when the batch has one."""
    if batch.np_lengths is not None:
        return batch.np_lengths
    return batch.lengths.cpu().numpy()


def to_dict(batch: TrackBatch, values=None) -> Dict[str, np.ndarray]:
    """Regroup a padded batch (or per-track ``values`` aligned with it) into
    the reference's length-keyed dict format."""
    lengths = host_lengths(batch)
    src = batch.positions if values is None else values
    src = src.detach().cpu().numpy() if isinstance(src, torch.Tensor) \
        else np.asarray(src)
    out: Dict[str, np.ndarray] = {}
    for t in np.unique(lengths):
        if t < 1:
            continue
        sel = lengths == t
        out[str(int(t))] = src[sel][:, :int(t)] if src.ndim > 1 else src[sel]
    return out


def default_min_len(lens: np.ndarray) -> int:
    """Dataset default for the closing gate: the shortest real track,
    clamped to >= 2 (reference min_len inference,
    extrack/tracking.py:1009)."""
    lens = np.asarray(lens)
    return int(lens[lens >= 2].min()) if (lens >= 2).any() else 2
