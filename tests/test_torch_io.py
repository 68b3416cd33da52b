"""The port's readers, exporters and native parser (extrack_tpu_torch/io/)
against the JAX package's (extrack_tpu/io/), on the same files from a seed.

Readers: the cases of tests/test_io.py (filters, truncation and
bucketing, composite and string IDs, quoted fields, TrackMate XML) give
identical dicts through both packages, engine by engine.  The native
parser (``native/track_reader.cpp``, built by each package from the same
source with the same flags) does not round every decimal correctly, so
the native and pandas engines agree on keys, track order and frames
exactly and on positions within 1e-12 relative.  Exporters: the CSV and
XML files of both packages are byte-identical on the same inputs (so they
parse equal), and a params JSON written by either package loads in the
other.  ``refine.full_extrack_2_matrix`` against JAX's at 1e-8.
"""
import xml.etree.ElementTree as ET

import numpy as np
import pandas as pd
import pytest
import torch

from extrack_tpu import params as jparams, refine as jrefine
from extrack_tpu import simulate as jsim
from extrack_tpu.io import exporters as jexp, readers as jread
from extrack_tpu_torch import params as tparams, refine as trefine
from extrack_tpu_torch.io import exporters as texp, native as tnative
from extrack_tpu_torch.io import readers as tread
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)

NATIVE_TOL = dict(rtol=1e-12, atol=1e-15)


def _same(a, b):
    """Two reader outputs (tracks, frames, opt) are identical."""
    for da, db in zip(a, b):
        assert list(da) == list(db)
        for k in da:
            if isinstance(da[k], dict):
                _same((da[k],), (db[k],))
            else:
                assert da[k].dtype == db[k].dtype
                np.testing.assert_array_equal(da[k], db[k])


def _write(path, rows):
    pd.DataFrame(rows).to_csv(path, index=False)
    return str(path)


def _filters_csv(tmp_path):
    rows = []
    # track 0: fine; track 1: giant jump; track 2: no displacement
    for tid, jump in [(0, 0.01), (1, 5.0), (2, 0.0)]:
        x = 0.0
        for f in range(6):
            rows.append({"POSITION_X": x, "POSITION_Y": 0.2, "FRAME": f,
                         "TRACK_ID": tid})
            x += jump
    return _write(tmp_path / "filters.csv", rows)


def _bucket_csv(tmp_path):
    rows = []
    for tid, n in [(0, 4), (1, 7), (2, 15)]:
        for f in range(n):
            rows.append({"POSITION_X": f * 0.01 + tid, "POSITION_Y": 0.0,
                         "FRAME": f, "TRACK_ID": tid})
    return _write(tmp_path / "bucket.csv", rows)


def _frames_csv(tmp_path):
    rng = np.random.default_rng(2)
    return _write(tmp_path / "frames.csv", [
        {"POSITION_X": rng.normal(), "POSITION_Y": rng.normal(),
         "FRAME": 3 * tid + j, "TRACK_ID": tid}
        for tid in range(8) for j in range(5 + tid % 3)])


def _sim_csv(tmp_path, n=300, seed=3):
    tracks, states, _ = jsim.sim_fov(
        nb_tracks=n, max_track_len=9, min_track_len=3, LocErr=0.02,
        Ds=(0.0, 0.08), dt=0.02, pBL=0.05, cell_dims=(0.5, None, None),
        seed=seed)
    p = str(tmp_path / "sim.csv")
    jexp.save_extrack_2_CSV(p, tracks, {k: np.eye(2)[states[k]]
                                        for k in states}, 0.02)
    return p


@pytest.mark.parametrize("engine", ["pandas", "native", "auto"])
@pytest.mark.parametrize("case", ["filters", "no_disp", "bucket", "sim",
                                  "frames", "quality"])
def test_read_table_matches_jax(tmp_path, engine, case):
    kw = {"filters": dict(lengths=[6], dist_th=0.5),
          "no_disp": dict(lengths=[6], dist_th=0.5, remove_no_disp=False),
          "bucket": dict(lengths=[5, 6, 10]),
          "sim": dict(lengths=range(3, 10)),
          "frames": dict(lengths=range(3, 10), frames_boundaries=(4, 15)),
          "quality": dict(lengths=range(3, 10), opt_colnames=["PRED_1"],
                          dist_th=0.1)}[case]
    path = {"filters": _filters_csv, "no_disp": _filters_csv,
            "bucket": _bucket_csv,
            "frames": _frames_csv}.get(case, _sim_csv)(tmp_path)
    got = tread.read_table(path, engine=engine, **kw)
    _same(got, jread.read_table(path, engine=engine, **kw))
    if case == "filters":
        assert got[0]["6"].shape[0] == 1
    elif case == "no_disp":
        assert got[0]["6"].shape[0] == 2
    elif case == "bucket":
        assert {k: len(v) for k, v in got[0].items()} == {"6": 1, "10": 1}
    elif case == "frames":
        assert sum(len(v) for v in got[0].values()) == 4
    else:
        assert sum(len(v) for v in got[0].values()) > 50


def test_native_and_pandas_engines_agree(tmp_path):
    path = _sim_csv(tmp_path, n=2000, seed=5)
    kw = dict(lengths=range(3, 10), opt_colnames=["PRED_0"])
    nat = tread.read_table(path, engine="native", **kw)
    pan = tread.read_table(path, engine="pandas", **kw)
    assert tnative.available() and tnative.build_error() is None
    assert tnative.library_path().parent.name == "_build"
    assert list(nat[0]) == list(pan[0])
    for k in nat[0]:
        np.testing.assert_array_equal(nat[1][k], pan[1][k])
        np.testing.assert_allclose(nat[0][k], pan[0][k], **NATIVE_TOL)
        np.testing.assert_array_equal(nat[2]["PRED_0"][k],
                                      pan[2]["PRED_0"][k])


def test_native_engine_raises_where_it_cannot_read(tmp_path):
    """engine='native' raises on what only pandas can read (quoted fields,
    string IDs); 'auto' takes pandas there, as the JAX reader does."""
    quoted = str(tmp_path / "quoted.csv")
    with open(quoted, "w") as fh:
        fh.write("NOTE,POSITION_X,POSITION_Y,FRAME,TRACK_ID\n")
        for tid in range(3):
            for j in range(6):
                fh.write(f'"a, b",{tid + j * 0.1},{j * 1.0},{j},{tid}\n')
    rng = np.random.default_rng(9)
    strings = _write(tmp_path / "str_ids.csv", [
        {"POSITION_X": rng.normal(), "POSITION_Y": rng.normal(),
         "FRAME": j, "TRACK_ID": f"Track_{tid:04d}"}
        for tid in range(4) for j in range(7)])
    for path, n in ((quoted, 3), (strings, 4)):
        kw = dict(lengths=(6, 7), remove_no_disp=False)
        with pytest.raises(RuntimeError, match="engine='native'"):
            tread.read_table(path, engine="native", **kw)
        got = tread.read_table(path, engine="auto", **kw)
        _same(got, tread.read_table(path, engine="pandas", **kw))
        _same(got, jread.read_table(path, engine="auto", **kw))
        assert sum(len(v) for v in got[0].values()) == n


def test_composite_ids_over_files_match_jax(tmp_path):
    rng = np.random.default_rng(8)
    paths = [_write(tmp_path / f"f{f}.csv", [
        {"POSITION_X": rng.normal(), "POSITION_Y": rng.normal(),
         "FRAME": j, "TRACK_ID": tid, "FOV": f}
        for tid in range(3) for j in range(6)]) for f in range(2)]
    kw = dict(lengths=(6,), remove_no_disp=False,
              colnames=("POSITION_X", "POSITION_Y", "FRAME",
                        ["TRACK_ID", "FOV"]))
    got = tread.read_table(paths, **kw)
    _same(got, jread.read_table(paths, **kw))
    assert got[0]["6"].shape == (6, 6, 2)


def _tracks_preds(seed=0, S=2):
    rng = np.random.default_rng(seed)
    tracks = {"5": rng.normal(0, 0.1, (3, 5, 2)).cumsum(1),
              "7": rng.normal(0, 0.1, (2, 7, 2)).cumsum(1)}
    preds = {k: rng.random((v.shape[0], v.shape[1], S))
             for k, v in tracks.items()}
    for k in preds:
        preds[k] /= preds[k].sum(-1, keepdims=True)
    frames = {k: np.arange(int(k))[None] + 3 * np.arange(len(v))[:, None]
              for k, v in tracks.items()}
    return tracks, preds, frames


def test_exporters_write_the_same_files(tmp_path):
    tracks, preds, frames = _tracks_preds()
    jspec = jparams.generate_params(nb_states=2)
    tspec = tparams.generate_params(nb_states=2)
    out = {}
    for tag, exp, spec in (("jax", jexp, jspec), ("torch", texp, tspec)):
        d = tmp_path / tag
        d.mkdir()
        exp.save_extrack_2_CSV(str(d / "a.csv"), tracks, preds, 0.02,
                               all_frames=frames)
        exp.save_extrack_2_xml(tracks, preds, spec, str(d / "a.xml"), 0.02,
                               all_frames=frames,
                               opt_metrics={"Q": frames})
        exp.save_extrack_2_input_xml(tracks, preds, spec, str(d / "tm.xml"),
                                     0.02, all_frames=frames)
        for fmt in ("json", "csv"):
            exp.save_params(spec, str(d), fmt=fmt)
        out[tag] = d
    for name in ("a.csv", "a.xml", "tm.xml", "params.json", "params.csv"):
        assert (out["torch"] / name).read_bytes() == (
            out["jax"] / name).read_bytes(), name
    root = ET.parse(out["torch"] / "tm.xml").getroot()
    assert int(root.find("Model/AllSpots").get("nspots")) == 3 * 5 + 2 * 7
    back = tread.read_trackmate_xml(
        str(out["torch"] / "a.xml"), lengths=[5, 7], dist_th=np.inf,
        remove_no_disp=False, opt_metrics_names=["pred_1"])
    _same(back, jread.read_trackmate_xml(
        str(out["jax"] / "a.xml"), lengths=[5, 7], dist_th=np.inf,
        remove_no_disp=False, opt_metrics_names=["pred_1"]))
    np.testing.assert_allclose(np.sort(back[2]["pred_1"]["5"].ravel()),
                               np.sort(preds["5"][..., 1].ravel()),
                               atol=1e-12)
    # the DataFrame and matrix flattenings, 12 states for the column order
    many = {k: np.tile(np.arange(12.0)[None, None], v.shape[:2] + (1,))
            for k, v in tracks.items()}
    for p in (preds, many):
        pd.testing.assert_frame_equal(
            texp.extrack_2_pandas(tracks, p, frames=frames),
            jexp.extrack_2_pandas(tracks, p, frames=frames))
        np.testing.assert_array_equal(
            texp.extrack_2_matrix(tracks, p, 0.02, all_frames=frames),
            jexp.extrack_2_matrix(tracks, p, 0.02, all_frames=frames))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_csv_and_refined_tables_match_jax_loops(tmp_path, dtype):
    """save_extrack_2_CSV and save_extrack_2_xml (a column at a time)
    write the JAX package's bytes for float64 and float32 posteriors and
    integer or float frames;
    refined_2_pandas writes what the JAX CLI's refine loop wrote
    (extrack_tpu/cli.py:154-167)."""
    tracks, preds, frames = _tracks_preds(seed=7, S=3)
    preds = {k: v.astype(dtype) for k, v in preds.items()}
    for fr in (None, frames, {k: v.astype(float) for k, v in
                              frames.items()}):
        texp.save_extrack_2_CSV(str(tmp_path / "t.csv"), tracks, preds,
                                0.03, all_frames=fr)
        jexp.save_extrack_2_CSV(str(tmp_path / "j.csv"), tracks, preds,
                                0.03, all_frames=fr)
        assert (tmp_path / "t.csv").read_bytes() == (
            tmp_path / "j.csv").read_bytes()
        # the XML too, with an optional metric that needs escaping
        odd = {"NOTE": {k: np.full(v.shape[:2], 'a&b<"c">\n\t', object)
                        for k, v in tracks.items()}}
        for tag, exp in (("t", texp), ("j", jexp)):
            exp.save_extrack_2_xml(tracks, preds, {"D0": 0.1, "p01": 0.2},
                                   str(tmp_path / f"{tag}.xml"), 0.03,
                                   all_frames=fr, opt_metrics=odd)
        assert (tmp_path / "t.xml").read_bytes() == (
            tmp_path / "j.xml").read_bytes()
    rng = np.random.default_rng(3)
    mus = {k: (v + rng.normal(0, 0.01, v.shape)).astype(dtype)
           for k, v in tracks.items()}
    sigmas = {k: rng.random(v.shape[:2]).astype(dtype)
              for k, v in tracks.items()}
    rows, tid = [], 0
    for k in tracks:
        for i in range(tracks[k].shape[0]):
            for j in range(int(k)):
                rows.append({"TRACK_ID": tid, "FRAME": int(frames[k][i, j]),
                             "X_OBS": tracks[k][i, j, 0],
                             "Y_OBS": tracks[k][i, j, 1],
                             "X_REFINED": mus[k][i, j, 0],
                             "Y_REFINED": mus[k][i, j, 1],
                             "SIGMA": sigmas[k][i, j]})
            tid += 1
    want = pd.DataFrame(rows).to_csv(index=False)
    got = texp.refined_2_pandas(tracks, mus, sigmas, frames)
    assert got.to_csv(index=False) == want
    no_frames = texp.refined_2_pandas(tracks, mus, sigmas)
    assert "FRAME" not in no_frames and len(no_frames) == len(got)


@pytest.mark.parametrize("fmt", ["json", "pkl", "npy"])
def test_params_round_trip_across_packages(tmp_path, fmt):
    jspec = jparams.generate_params(nb_states=3, estimated_Ds=[0, 0.02, 0.1])
    tspec = tparams.generate_params(nb_states=3, estimated_Ds=[0, 0.02, 0.1])
    jexp.save_params(jspec, str(tmp_path), fmt=fmt, file_name="j")
    texp.save_params(tspec, str(tmp_path), fmt=fmt, file_name="t")
    for src in ("j", "t"):
        path = str(tmp_path / f"{src}.{fmt}")
        got = texp.load_params(path)
        want = jexp.load_params(path)
        assert isinstance(got, tparams.Parameters)
        assert got.valuesdict() == pytest.approx(want.valuesdict(),
                                                 rel=1e-15)
        assert got.free_names() == [] == want.free_names()
    assert texp.load_params(str(tmp_path / f"j.{fmt}")).valuesdict() == \
        pytest.approx(tspec.valuesdict(), rel=1e-15)


def test_read_trackmate_xml_matches_jax(tmp_path):
    tracks, preds, frames = _tracks_preds(seed=4)
    path = str(tmp_path / "t.xml")
    jexp.save_extrack_2_xml(tracks, preds, jparams.generate_params(2), path,
                            0.02, all_frames=frames)
    for kw in (dict(lengths=[5, 7], dist_th=0.5),
               dict(lengths=[4, 6], dist_th=np.inf, remove_no_disp=False,
                    frames_boundaries=(0, 8),
                    opt_metrics_names=["pred_0", "t"],
                    opt_metrics_types=["float64", "int64"])):
        _same(tread.read_trackmate_xml(path, **kw),
              jread.read_trackmate_xml(path, **kw))


def test_full_extrack_2_matrix_matches_jax():
    tracks, _, _ = jsim.sim_fov(
        nb_tracks=40, max_track_len=7, min_track_len=3, LocErr=0.02,
        Ds=(0.0, 0.08), dt=0.02, pBL=0.05, cell_dims=(0.5, None, None),
        seed=11)
    jspec = jparams.generate_params(nb_states=2, estimated_Ds=[0.0, 0.08])
    tspec = tparams.generate_params(nb_states=2, estimated_Ds=[0.0, 0.08])
    kw = dict(cell_dims=(0.5, None, None), nb_states=2, frame_len=9)
    got = trefine.full_extrack_2_matrix(tracks, tspec, 0.02, device="cpu",
                                        **kw)
    want = jrefine.full_extrack_2_matrix(tracks, jspec, 0.02, **kw)
    assert list(got.columns) == list(want.columns)
    assert len(got) == sum(int(k) * len(v) for k, v in tracks.items())
    np.testing.assert_allclose(got.to_numpy(np.float64),
                               want.to_numpy(np.float64), rtol=1e-8,
                               atol=1e-10)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            trefine.full_extrack_2_matrix(tracks, tspec, 0.02, **kw)
