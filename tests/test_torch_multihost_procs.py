"""The port's multi-process pipeline with two real processes: two gloo CPU
processes (``torch.distributed``), each loading only its
``process_slice`` of the tracks, assemble them with ``global_batch`` and
compute the sharded log likelihood, the sharded objective's value and
z-gradient (one all-reduce an evaluation) and a sharded fit with error
bars.  Both processes must agree bit for bit, and with the JAX package's
single-process value on its 8-device mesh (tests/test_multihost_procs.py).
The workers import no JAX."""
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent("""
    import json, sys
    pid, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    sys.path.insert(0, %r)
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="tcp://localhost:" + port,
                            world_size=2, rank=pid)
    from extrack_tpu_torch import data as tdata, fit as tfit, \\
        params as tparams
    from extrack_tpu_torch.core import tables
    from extrack_tpu_torch.parallel import mesh as pmesh, multihost

    ARGS = ([0.0, 0.08], 0.02, [0.5, 0.5], [[0.0, 0.1], [0.1, 0.0]], 0.05)
    tb = tables.build_tables(*(torch.as_tensor(np.asarray(a, np.float64))
                               for a in ARGS), 0.02, cell_dims=(0.5,))
    mesh = multihost.global_mesh()
    npz = np.load(path)
    tracks = {k: npz[k] for k in npz.files if k != "uneven"}
    # a deterministic global item list; every process loads ONLY its slice
    items = [(k, i) for k in sorted(tracks, key=int)
             for i in range(len(tracks[k]))]
    mine = items[multihost.process_slice(len(items))]
    local = {}
    for k, i in mine:
        local.setdefault(k, []).append(tracks[k][i])
    local = {k: np.asarray(v) for k, v in local.items()}
    data_max = max(int(k) for k in tracks)
    batch = tdata.from_dict(local, max_len=data_max, data_max=data_max,
                            device="cpu")
    gb = multihost.global_batch(batch)
    logl = float(pmesh.sharded_log_likelihood(gb, tb, window=4, min_len=3,
                                              mesh=mesh))
    spec = tparams.generate_params(nb_states=2, LocErr_type=1, D_max=1.0,
                                   estimated_Ds=[0.005, 0.05])
    kw = dict(cell_dims=(0.5,), window=4)
    neg = tfit.make_objective(gb, spec, 0.02, 2, sharded=True, **kw)
    z = torch.tensor(spec.to_unconstrained(), requires_grad=True)
    v = neg(z)
    (g,) = torch.autograd.grad(v, z)
    res = tfit.fit(gb, spec, 0.02, 2, sharded=True, max_iter=40,
                   compute_errors=True, **kw)

    # 9 tracks over 2 processes: 5 and 4 rows, padded to a common 5
    pos = npz["uneven"]
    ub = multihost.global_batch(tdata.from_dict(
        {"5": pos[multihost.process_slice(len(pos))]}, device="cpu"))
    u_logl = float(pmesh.sharded_log_likelihood(ub, tb, window=4,
                                                min_len=2, mesh=mesh))
    print("RESULT " + json.dumps({
        "pid": pid, "n_local": len(mine), "world": mesh.size,
        "rows": gb.batch_size, "global_rows": len(gb.np_lengths),
        "min_len": neg.min_len, "logl": logl, "value": float(v.detach()),
        "grad": g.tolist(), "fit_logl": res.logl, "n_evals": res.n_evals,
        "values": {k: p.value for k, p in res.params.items()},
        "std_errors": res.std_errors, "u_rows": ub.batch_size,
        "u_valid": int((ub.np_lengths > 0).sum()), "u_logl": u_logl}),
        flush=True)
    dist.destroy_process_group()
""" % REPO)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _tracks():
    from extrack_tpu import simulate as jsim
    tracks, _, _ = jsim.sim_fov(
        nb_tracks=64, max_track_len=9, min_track_len=3, LocErr=0.02,
        Ds=(0.0, 0.08), TrMat=np.array([[0.9, .1], [.1, .9]]), dt=0.02,
        pBL=0.05, cell_dims=(0.5, None, None), seed=17)
    uneven = np.random.default_rng(3).normal(0, 0.1, (9, 5, 2)).cumsum(1)
    return tracks, uneven


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tracks, uneven = _tracks()
    path = str(tmp_path_factory.mktemp("procs") / "tracks.npz")
    np.savez(path, uneven=uneven, **tracks)
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(pid), port, path],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
        for pid in range(2)]
    out = {}
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=240)
            assert p.returncode == 0, f"worker failed:\n{stdout}\n{stderr}"
            line = [ln for ln in stdout.splitlines()
                    if ln.startswith("RESULT ")]
            assert line, f"no RESULT in:\n{stdout}\n{stderr}"
            r = json.loads(line[0][len("RESULT "):])
            out[r["pid"]] = r
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return tracks, uneven, out


def _jax_tables():
    from extrack_tpu.core import tables as jtables
    return jtables.build_tables(
        np.array([0.0, 0.08]), 0.02, np.array([0.5, 0.5]),
        np.array([[0.0, 0.1], [0.1, 0.0]]), 0.05, 0.02, cell_dims=(0.5,))


def test_two_process_global_batch_matches_single(results):
    import torch
    from extrack_tpu import data as jdata
    from extrack_tpu.parallel import mesh as jmesh
    from extrack_tpu_torch import data as tdata, fit as tfit, \
        params as tparams
    tracks, _, r = results
    n_items = sum(len(v) for v in tracks.values())
    assert r[0]["world"] == 2
    assert r[0]["n_local"] + r[1]["n_local"] == n_items
    assert r[0]["rows"] == r[1]["rows"] == -(-n_items // 2)
    assert r[0]["global_rows"] == 2 * r[0]["rows"]
    assert r[0]["min_len"] == r[1]["min_len"] == 3
    # both processes agree bit for bit: the same L-BFGS-B steps
    for key in ("logl", "value", "grad", "fit_logl", "n_evals", "values",
                "std_errors"):
        assert r[0][key] == r[1][key], key

    jm = jmesh.make_mesh()
    jb = jmesh.shard_batch(jdata.from_dict(tracks), jm)
    want = float(jmesh.sharded_log_likelihood(jb, _jax_tables(), window=4,
                                              min_len=3, mesh=jm))
    np.testing.assert_allclose(r[0]["logl"], want, rtol=1e-12)
    # the objective against the one-process one (which
    # test_torch_parallel.py holds to the JAX package's sharded objective)
    gen = dict(nb_states=2, LocErr_type=1, D_max=1.0,
               estimated_Ds=[0.005, 0.05])
    spec = tparams.generate_params(**gen)
    neg = tfit.make_objective(tdata.from_dict(tracks, device="cpu"), spec,
                              0.02, 2, cell_dims=(0.5,), window=4)
    z = torch.tensor(spec.to_unconstrained(), requires_grad=True)
    v = neg(z)
    (g,) = torch.autograd.grad(v, z)
    np.testing.assert_allclose(r[0]["value"], float(v.detach()), rtol=1e-12)
    np.testing.assert_allclose(r[0]["grad"], g.numpy(), rtol=1e-10,
                               atol=1e-9)
    # the two-process fit against the one-process unsharded fit
    one = tfit.fit(tdata.from_dict(tracks, device="cpu"),
                   tparams.generate_params(**gen), 0.02, 2, cell_dims=(0.5,),
                   window=4, max_iter=40, compute_errors=True)
    np.testing.assert_allclose(r[0]["fit_logl"], one.logl, rtol=1e-8)
    for name, p in one.params.items():
        np.testing.assert_allclose(r[0]["values"][name], p.value, rtol=1e-5,
                                   atol=1e-10)
    for name, se in one.std_errors.items():
        np.testing.assert_allclose(r[0]["std_errors"][name], se, rtol=1e-6)


def test_two_process_uneven_split(results):
    """Uneven loads (5 and 4 tracks) pad to one row count (all-reduce
    MAX) and share the global lengths (all-gather)."""
    from extrack_tpu import data as jdata
    from extrack_tpu.parallel import mesh as jmesh
    _, uneven, r = results
    assert r[0]["u_rows"] == r[1]["u_rows"] == 5
    assert r[0]["u_valid"] == r[1]["u_valid"] == 9   # global lengths
    assert r[0]["u_logl"] == r[1]["u_logl"]
    want = float(jmesh.sharded_log_likelihood(
        jdata.from_dict({"5": uneven}), _jax_tables(), window=4, min_len=2))
    np.testing.assert_allclose(r[0]["u_logl"], want, rtol=1e-12)
