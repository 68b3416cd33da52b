"""The port's reference-compatible namespace (extrack_tpu_torch/tracking.py,
the reference module names of the package, ``core.engine.
batch_log_likelihood`` and ``simulate.sim_FOV``) against the JAX
package's, on the same numpy inputs from a seed, float64 on the CPU:
``Proba_Cs``, ``cum_Proba_Cs`` and ``batch_log_likelihood`` to 1e-9, the
Gaussian steps to 1e-12, the array helpers exactly.  The cases follow
tests/test_compat_symbols.py.  On the card ``Proba_Cs`` and
``cum_Proba_Cs`` run K1 (``chip_smoke.py`` phase 12 holds them there)."""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import extrack_tpu_torch
from extrack_tpu import data as jdata, params as jparams, tracking as jtr
from extrack_tpu.core import engine as jengine, tables as jtables
from extrack_tpu_torch import data as tdata, params as tparams, \
    tracking as ttr
from extrack_tpu_torch.core import engine as tengine, tables as ttables
from extrack_tpu_torch.ops import forward_kernel
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)

TOL = dict(rtol=1e-9, atol=1e-9)
CPU = dict(device="cpu")

# the reference's public names per module (tests/test_compat_symbols.py),
# those the port has and those still queued (ROADMAP Queue 1; none since
# full_extrack_2_matrix, the I/O and the apps)
PORTED = {
    "tracking": ["param_fitting", "predict_Bs", "generate_params",
                 "get_params", "Proba_Cs", "cum_Proba_Cs", "extract_params",
                 "get_all_Bs", "get_Ts_from_Bs", "ds_froms_states",
                 "log_integrale_dif", "first_log_integrale_dif"],
    "histograms": ["len_hist", "ground_truth_hist"],
    "refined_localization": [
        "position_refinement", "get_pos_PDF", "get_all_estimates",
        "get_global_sigs_mus", "get_best_estimates", "save_gifs",
        "do_gifs_from_params", "prod_2GaussPDF", "prod_3GaussPDF",
        "gaussian", "get_pos_PDF_fixedBs", "full_extrack_2_matrix"],
    "simulate_tracks": ["sim_FOV", "sim_noBias", "markovian_process",
                        "get_fractions_from_TrMat", "is_in_FOV"],
    "readers": ["read_table", "read_trackmate_xml"],
    "exporters": ["save_params", "extrack_2_matrix", "extrack_2_pandas",
                  "extrack_2_pandas2", "save_extrack_2_CSV",
                  "save_extrack_2_xml", "save_extrack_2_input_xml"],
    "visualization": ["visualize_states_durations", "visualize_tracks",
                      "plot_tracks"],
    "auto_fitting": ["fit_2states", "fit_3states"],
}
QUEUED = {}


def test_symbol_presence():
    """Each reference name the port has resolves from the package, through
    the reference's module names; the names still queued do not yet."""
    missing = [f"{m}.{n}" for m, names in PORTED.items() for n in names
               if not hasattr(getattr(extrack_tpu_torch, m), n)]
    assert not missing, missing
    assert not [f"{m}.{n}" for m, names in QUEUED.items() for n in names
                if hasattr(getattr(extrack_tpu_torch, m), n)]
    assert extrack_tpu_torch.refined_localization is importlib.import_module(
        "extrack_tpu_torch.refine")
    assert extrack_tpu_torch.simulate_tracks.sim_FOV is (
        extrack_tpu_torch.simulate.sim_fov)
    assert extrack_tpu_torch.gaussian is importlib.import_module(
        "extrack_tpu_torch.core.gaussian")
    assert ttr.batch_log_likelihood is tengine.batch_log_likelihood


def _tracks(seed, B=6, T=7, D=2):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 0.15, (B, T, D)).cumsum(1)


PROBA_CASES = [
    # (S, nb_substeps, frame_len, LocErr kind, isBL, cell_dims)
    (2, 1, 6, "scalar", 1, (1.0,)), (2, 1, 4, "per_dim", 0, (0.5, None)),
    (2, 2, 5, "scalar", 1, (1.0,)), (3, 1, 4, "per_peak", 0, (1.0, 1.0)),
    (3, 1, 3, "scalar", 1, ())]


@pytest.mark.parametrize("S,n,W,le,isbl,cell", PROBA_CASES)
def test_proba_cs_matches_jax(S, n, W, le, isbl, cell):
    Cs = _tracks(S * 10 + n + W)
    B, T, D = Cs.shape
    rng = np.random.default_rng(W)
    LocErr = {"scalar": 0.025, "per_dim": np.array([0.02, 0.03]),
              "per_peak": rng.uniform(0.01, 0.03, (B, T, D))}[le]
    tr = np.full((S, S), 0.1 / (S - 1)) + np.eye(S) * (0.9 - 0.1 / (S - 1))
    kw = dict(ds=np.linspace(0.02, 0.3, S), Fs=np.full(S, 1.0 / S),
              TrMat=tr, pBL=0.05, isBL=isbl, cell_dims=cell,
              nb_substeps=n, frame_len=W)
    before = forward_kernel.PLAIN_CALLS
    got = ttr.Proba_Cs(Cs, LocErr, **kw, **CPU)
    assert forward_kernel.PLAIN_CALLS == before + 1
    assert got.shape == (B,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jtr.Proba_Cs(Cs, LocErr, **kw)),
                               **TOL)


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(10)
    return {"5": rng.normal(0, 0.1, (7, 5, 2)).cumsum(1),
            "8": rng.normal(0, 0.1, (3, 8, 2)).cumsum(1),
            "3": rng.normal(0, 0.1, (4, 3, 2)).cumsum(1)}


@pytest.mark.parametrize("S,n,W,Matrix_type", [(2, 1, 5, 1), (2, 2, 5, 2),
                                               (3, 1, 4, 1)])
def test_cum_proba_cs_matches_jax(dataset, S, n, W, Matrix_type):
    jp = jparams.generate_params(nb_states=S, D_max=1.0)
    tp = tparams.generate_params(nb_states=S, D_max=1.0)
    args = (dataset, 0.02, (1.0,), None, S, n, W)
    got = ttr.cum_Proba_Cs(tp, *args, verbose=0, Matrix_type=Matrix_type,
                           **CPU)
    want = jtr.cum_Proba_Cs(jp, *args, verbose=0, Matrix_type=Matrix_type)
    np.testing.assert_allclose(got, want, **TOL)


def test_cum_proba_cs_batch_cache(dataset):
    """Optimizer loops reuse the batch; changed data, device or dtype
    builds another; ``clear_batch_cache`` empties the cache."""
    tracks = dict(dataset)
    p = tparams.generate_params(nb_states=2, D_max=1.0)
    args = (p, tracks, 0.02, (1.0,), None, 2, 1, 5)
    ttr.clear_batch_cache()
    out = ttr.cum_Proba_Cs(*args, verbose=0, **CPU)
    assert out == ttr.cum_Proba_Cs(*args, verbose=0, **CPU)
    assert len(ttr._batch_cache) == 1
    ttr.cum_Proba_Cs(*args, verbose=0, device="cpu", dtype=torch.float32)
    assert len(ttr._batch_cache) == 2
    tracks["5"] = tracks["5"] * 1.3        # changes the displacements
    assert ttr.cum_Proba_Cs(*args, verbose=0, **CPU) != out
    assert len(ttr._batch_cache) == 3
    ttr.clear_batch_cache()
    assert not ttr._batch_cache


def test_cum_proba_cs_invalid_fractions_are_inf(dataset):
    tp = tparams.generate_params(nb_states=3, D_max=1.0).resolve()
    tp = {k: float(v) for k, v in tp.items()}
    tp["F0"] = -0.1
    assert ttr.cum_Proba_Cs(tp, dataset, 0.02, (1.0,), None, 3, 1, 4,
                            verbose=0, **CPU) == float("inf")


@pytest.mark.parametrize("W,n", [(4, 1), (5, 2)])
def test_batch_log_likelihood_matches_jax(dataset, W, n):
    values = {k: float(v) for k, v in
              jparams.generate_params(nb_states=2, D_max=1.0)
              .resolve().items()}
    jb = jdata.from_dict(dataset)
    tb = tdata.from_dict(dataset, **CPU)

    def tables_of(extract_arrays, build_tables):
        Ds, Fs, rates, loc_err, pBL = extract_arrays(values, 2)
        return build_tables(Ds, loc_err, Fs, rates, pBL, 0.02,
                            cell_dims=(1.0,), nb_substeps=n)

    jt = tables_of(jparams.extract_arrays, jtables.build_tables)
    tt = tables_of(tparams.extract_arrays, ttables.build_tables)
    kw = dict(window=W, nb_substeps=n, min_len=3)
    got = tengine.batch_log_likelihood(tb, tt, **kw)
    np.testing.assert_allclose(
        float(got), float(jengine.batch_log_likelihood(jb, jt, **kw)),
        **TOL)
    assert float(ttr.batch_log_likelihood(tb, tt, **kw)) == float(got)


@pytest.mark.parametrize("Matrix_type", [0, 1, 2])
def test_extract_params_matches_jax(Matrix_type):
    for nb_substeps in (1, 2):
        jp = jparams.generate_params(nb_states=3, estimated_LocErr=0.03,
                                     D_max=1.0)
        tp = tparams.generate_params(nb_states=3, estimated_LocErr=0.03,
                                     D_max=1.0)
        got = ttr.extract_params(tp, 0.02, 3, nb_substeps,
                                 Matrix_type=Matrix_type)
        want = jtr.extract_params(jp, 0.02, 3, nb_substeps,
                                  Matrix_type=Matrix_type)
        assert got[0][0].shape == (1, 1, 1)
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_allclose(np.asarray(g, float),
                                       np.asarray(w, float), rtol=1e-12,
                                       atol=1e-14)
        assert got[4] == pytest.approx(want[4], rel=1e-12)


def test_extract_params_per_peak_and_per_step_dt():
    jp = jparams.generate_params(nb_states=2, LocErr_type=4,
                                 slope_offsets_estimates=(1.0, 0.01))
    tp = tparams.generate_params(nb_states=2, LocErr_type=4,
                                 slope_offsets_estimates=(1.0, 0.01))
    per_peak = [np.full((3, 7, 1), 0.02), np.full((2, 5, 1), 0.04)]
    dts = [np.full((3, 6), 0.02), np.full((2, 4), 0.05)]
    got = ttr.extract_params(tp, dts, 2, 1, input_LocErr=per_peak)
    want = jtr.extract_params(jp, dts, 2, 1, input_LocErr=per_peak)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_allclose(g, w, rtol=1e-12)


def test_array_helpers_match_jax():
    for nb_Cs, S in ((3, 2), (4, 3)):
        np.testing.assert_array_equal(ttr.get_all_Bs(nb_Cs, S),
                                      jtr.get_all_Bs(nb_Cs, S))
    bs = ttr.get_all_Bs(3, 2)
    np.testing.assert_array_equal(bs[1], [1, 0, 0])
    tr = np.array([[0.9, 0.1], [0.2, 0.8]])
    np.testing.assert_array_equal(ttr.get_Ts_from_Bs(bs[None], tr),
                                  jtr.get_Ts_from_Bs(bs[None], tr))
    ds = np.array([0.0, 0.1])
    states = np.array([[[0, 1, 1]], [[1, 1, 1]]])
    np.testing.assert_array_equal(ttr.ds_froms_states(ds, states),
                                  jtr.ds_froms_states(ds, states))


def test_gaussian_steps_match_jax():
    rng = np.random.default_rng(1)
    Ci = rng.normal(size=(5, 3, 2))
    m0, s20 = ttr.first_log_integrale_dif(Ci, 4e-4, 0.01)
    jm0, js20 = jtr.first_log_integrale_dif(Ci, 4e-4, 0.01)
    np.testing.assert_allclose(m0.numpy(), np.asarray(jm0), rtol=1e-12)
    np.testing.assert_allclose(s20.numpy(), np.asarray(js20), rtol=1e-12)
    s2 = np.asarray(s20) * np.ones_like(Ci)
    got = ttr.log_integrale_dif(Ci + 0.05, 4e-4, 0.01, m0, s2)
    want = jtr.log_integrale_dif(Ci + 0.05, 4e-4, 0.01, jnp.asarray(jm0),
                                 s2)
    assert got[2].shape == (5, 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12)
