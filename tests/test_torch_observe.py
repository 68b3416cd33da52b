"""The port's observability (extrack_tpu_torch/utils/observe.py) against
the JAX package's: the recorder's JSONL and the checkpoints share one
format, a checkpoint written by either package's fit resumes a fit in
the other, and ``trace`` writes a Chrome trace of the region."""
import json

import numpy as np
import pytest
import torch

from extrack_tpu import data as jdata, fit as jfit, params as jparams
from extrack_tpu import simulate as jsim
from extrack_tpu.utils import observe as jobs
from extrack_tpu_torch import data as tdata, fit as tfit, params as tparams
from extrack_tpu_torch.utils import observe as tobs
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)

KW = dict(cell_dims=(0.5,), window=3)


@pytest.fixture(scope="module")
def data():
    tracks, _, _ = jsim.sim_fov(
        nb_tracks=150, max_track_len=8, min_track_len=3, LocErr=0.02,
        Ds=(0.0, 0.08), TrMat=np.array([[0.9, 0.1], [0.1, 0.9]]), dt=0.02,
        pBL=0.05, cell_dims=(0.5, None, None), seed=9)
    return (jdata.from_dict(tracks),
            tdata.from_dict(tracks, device="cpu", dtype=torch.float64))


def _spec(mod):
    return mod.generate_params(nb_states=2, LocErr_type=1, D_max=1.0,
                               estimated_Ds=[0.005, 0.05],
                               estimated_transition_rates=0.08)


def test_recorder_and_checkpoint_match_jax(data, tmp_path):
    jb, tb = data
    recs = {}
    for tag, fit, mod, obs, b in (("t", tfit, tparams, tobs, tb),
                                  ("j", jfit, jparams, jobs, jb)):
        rec = obs.FitRecorder(jsonl_path=str(tmp_path / f"{tag}.jsonl"))
        res = fit.fit(b, _spec(mod), 0.02, 2, callback=rec,
                      checkpoint_path=str(tmp_path / f"{tag}.ckpt.json"),
                      max_iter=6, **KW)
        assert len(rec.records) == res.n_evals
        recs[tag] = (rec, res)
    (trec, tres), (jrec, jres) = recs["t"], recs["j"]
    assert tres.n_evals == jres.n_evals
    np.testing.assert_allclose([r.objective for r in trec.records],
                               [r.objective for r in jrec.records],
                               rtol=1e-9)
    assert trec.best.n_eval == jrec.best.n_eval
    tl = [json.loads(x) for x in open(tmp_path / "t.jsonl")]
    jl = [json.loads(x) for x in open(tmp_path / "j.jsonl")]
    assert [sorted(x) for x in tl] == [sorted(x) for x in jl]
    assert [sorted(x["values"]) for x in tl] == [sorted(x["values"])
                                                 for x in jl]
    tc = tobs.CheckpointManager(str(tmp_path / "t.ckpt.json")).load()
    jc = jobs.CheckpointManager(str(tmp_path / "j.ckpt.json")).load()
    assert sorted(tc) == sorted(jc) == ["extra", "n_eval", "objective",
                                        "values"]
    assert tc["n_eval"] == jc["n_eval"]
    assert tc["objective"] == pytest.approx(jc["objective"], rel=1e-9)
    assert tc["values"] == pytest.approx(jc["values"], rel=1e-6, abs=1e-9)
    assert tobs.CheckpointManager(str(tmp_path / "none.json")).load() is None


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_checkpoint_resumes_across_packages(data, tmp_path, writer):
    """A checkpoint from one package's fit warm-starts the other's: the
    resumed fit starts at the checkpointed optimum, so it takes no more
    evaluations and reaches at least its likelihood."""
    jb, tb = data
    path = str(tmp_path / "ckpt.json")
    first = (tfit.fit(tb, _spec(tparams), 0.02, 2, checkpoint_path=path,
                      max_iter=60, **KW) if writer == "torch" else
             jfit.fit(jb, _spec(jparams), 0.02, 2, checkpoint_path=path,
                      max_iter=60, **KW))
    saved = json.loads(open(path).read())
    other = (jfit.fit(jb, _spec(jparams), 0.02, 2, checkpoint_path=path,
                      max_iter=60, **KW) if writer == "torch" else
             tfit.fit(tb, _spec(tparams), 0.02, 2, checkpoint_path=path,
                      max_iter=60, **KW))
    assert other.logl >= first.logl - 1e-6
    assert other.n_evals <= first.n_evals
    assert json.loads(open(path).read())["objective"] <= saved["objective"]


def test_trace_writes_a_chrome_trace(data, tmp_path):
    _, tb = data
    spec = _spec(tparams)
    obj = tfit.make_objective(tb, spec, 0.02, 2, **KW)
    with tobs.trace(str(tmp_path / "tr")) as prof:
        obj(torch.tensor(spec.to_unconstrained()))
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)
    assert prof.key_averages()
