"""The port's data parallelism (``extrack_tpu_torch.parallel.mesh``) on
eight CPU shards against the JAX package on its eight virtual CPU devices
(tests/conftest.py): padding, sharding, the sharded log likelihood (1e-12)
and its z-gradient (1e-10), with per-peak localization errors and per-track
dt, and the sharded posteriors, histogram and refinement
(tests/test_sharded_postfit.py's 1e-12)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from extrack_tpu import data as jdata, fit as jfit, params as jparams, \
    refine as jrefine, simulate as jsim, histograms as jhist
from extrack_tpu.core import engine as jengine, tables as jtables
from extrack_tpu.parallel import mesh as jmesh
from extrack_tpu_torch import data as tdata, fit as tfit, params as tparams
from extrack_tpu_torch.core import tables as ttables
from extrack_tpu_torch.parallel import mesh as pmesh
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)

MESH8 = pmesh.make_mesh(n_devices=8, devices=["cpu"] * 8)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def _tables(Ds=(0.0, 0.08), loc_err=0.02, dt=0.02, cell_dims=(0.5,)):
    args = (np.array(Ds), loc_err, np.array([0.5, 0.5]),
            np.array([[0.0, 0.1], [0.1, 0.0]]), 0.05, dt)
    jt = jtables.build_tables(*args, cell_dims=cell_dims)
    tt = ttables.build_tables(*(_t(a) if not isinstance(a, torch.Tensor)
                                else a for a in args), cell_dims=cell_dims)
    return jt, tt


def _sim(seed=11, nb_tracks=120, **kw):
    tracks, _, sigmas = jsim.sim_fov(
        nb_tracks=nb_tracks, max_track_len=9, min_track_len=3, LocErr=0.02,
        Ds=(0.0, 0.08), TrMat=np.array([[0.9, 0.1], [0.1, 0.9]]), dt=0.02,
        pBL=0.05, cell_dims=(0.5, None, None), seed=seed, **kw)
    return tracks, sigmas


def _dts(tracks, kind, seed=3):
    rng = np.random.default_rng(seed)
    if kind == "step":
        return {k: 0.02 * rng.uniform(0.5, 1.5, (len(v), int(k) - 1))
                for k, v in tracks.items()}
    return {k: np.repeat(0.02 * rng.uniform(0.5, 1.5, (len(v), 1)),
                         int(k) - 1, axis=1) for k, v in tracks.items()}


FIELDS = ("positions", "lengths", "loc_err", "is_bleached", "frames", "dt")


def _same_batch(t, j):
    for f in FIELDS:
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-15,
                                       atol=0, err_msg=f)
    np.testing.assert_array_equal(t.np_lengths, j.np_lengths)


@pytest.mark.parametrize("dt_kind", [None, "step", "track"])
def test_pad_batch_and_len_match_jax(dt_kind):
    tracks, sigmas = _sim(nb_tracks=40, LocErr_std=0.3)
    dts = None if dt_kind is None else _dts(tracks, dt_kind)
    frames = {k: np.tile(np.arange(int(k)), (len(v), 1))
              for k, v in tracks.items()}
    kw = dict(input_loc_err=sigmas, frames=frames, dt=dts)
    jb = jdata.from_dict(tracks, **kw)
    tb = tdata.from_dict(tracks, **kw, device="cpu")
    B, T = tb.batch_size, tb.max_len
    _same_batch(tb.pad_batch_to(B), jb.pad_batch_to(B))
    jp, tp = jb.pad_batch_to(B + 13), tb.pad_batch_to(B + 13)
    _same_batch(tp, jp)
    assert (tp.np_lengths[B:] == 0).all()
    assert (tp.loc_err[B:] == 1.0).all()
    if dts is not None:         # padded with the batch's own median dt
        assert torch.equal(ttables.build_tables(
            *(_t(a) for a in ([0.0, 0.08], 0.02, [0.5, 0.5],
                              [[0.0, 0.1], [0.1, 0.0]], 0.05)), tp.dt,
            cell_dims=(0.5,)).log_survive, ttables.build_tables(
            *(_t(a) for a in ([0.0, 0.08], 0.02, [0.5, 0.5],
                              [[0.0, 0.1], [0.1, 0.0]], 0.05)), tb.dt,
            cell_dims=(0.5,)).log_survive)
    jl, tl = jp.pad_len_to(T + 4), tp.pad_len_to(T + 4)
    _same_batch(tl, jl)
    np.testing.assert_array_equal(tl.np_lengths, tp.np_lengths)
    assert tl.max_len == T + 4 and torch.equal(tl.lengths, tp.lengths)


def test_shard_batch_on_eight_cpu_shards():
    tracks, sigmas = _sim(nb_tracks=60, LocErr_std=0.3)
    tb = tdata.from_dict(tracks, input_loc_err=sigmas,
                         dt=_dts(tracks, "step"), device="cpu")
    B = tb.batch_size
    sb = pmesh.shard_batch(tb, MESH8)
    jsb = jmesh.shard_batch(jdata.from_dict(tracks), jmesh.make_mesh())
    assert MESH8.size == 8 and sb.batch_size % 8 == 0
    assert sb.batch_size == jsb.batch_size
    assert sb.n_tracks == B and len(sb.shards) == 8
    m = sb.batch_size // 8
    assert sb.offsets == [i * m for i in range(8)]
    for s, o in zip(sb.shards, sb.offsets):
        assert s.batch_size == m
        assert torch.equal(s.positions, sb.positions[o:o + m])
        assert torch.equal(s.dt, sb.dt[o:o + m])
        np.testing.assert_array_equal(s.np_lengths, sb.np_lengths[o:o + m])
        # the shards keep the batch's survival-table dt
        assert s.dt_repr == float(tdata.median(tb.dt))
    assert (sb.np_lengths[B:] == 0).all()
    assert pmesh.shard_batch(sb, MESH8) is sb
    with pytest.raises(ValueError, match="devices"):
        pmesh.make_mesh(n_devices=9, devices=["cpu"] * 8)


def test_sharded_log_likelihood_and_gradient_match_jax():
    tracks, _ = _sim()
    jb = jdata.from_dict(tracks)
    tb = tdata.from_dict(tracks, device="cpu")
    jt, tt = _tables()
    jm = jmesh.make_mesh()
    assert jm.devices.size == 8
    kw = dict(window=4, min_len=3)
    want = float(jmesh.sharded_log_likelihood(jmesh.shard_batch(jb, jm), jt,
                                              mesh=jm, **kw))
    got = float(pmesh.sharded_log_likelihood(pmesh.shard_batch(tb, MESH8),
                                             tt, mesh=MESH8, **kw))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(
        float(pmesh.sharded_log_likelihood(tb, tt, **kw)), want, rtol=1e-12)
    # autograd through the shards' sum (the z-gradient against JAX's:
    # test_sharded_objective_matches_jax)
    d = _t([0.001, 0.08]).requires_grad_(True)
    tables_d = [ttables.build_tables(d, *(_t(a) for a in (
        0.02, [0.5, 0.5], [[0.0, 0.1], [0.1, 0.0]], 0.05)), 0.02,
        cell_dims=(0.5,)) for _ in range(2)]
    (g8,) = torch.autograd.grad(pmesh.sharded_log_likelihood(
        tb, tables_d[0], mesh=MESH8, **kw), d)
    (g1,) = torch.autograd.grad(pmesh.sharded_log_likelihood(
        tb, tables_d[1], **kw), d)
    np.testing.assert_allclose(g8.numpy(), g1.numpy(), rtol=1e-12)


def _objective_data(input_loc_err, per_step_dt):
    tracks, sigmas = _sim(seed=3, nb_tracks=150, LocErr_std=0.007)
    dts = _dts(tracks, "step") if per_step_dt else None
    kw = dict(input_loc_err=sigmas if input_loc_err else None, dt=dts)
    gen = dict(nb_states=2, LocErr_type=1, D_max=1.0,
               estimated_Ds=[0.003, 0.05])
    okw = dict(cell_dims=(0.5,), window=4, input_loc_err=input_loc_err)
    return tracks, kw, gen, okw


def _port_value_grad(tracks, kw, gen, okw, sharded):
    spec = tparams.generate_params(**gen)
    neg = tfit.make_objective(tdata.from_dict(tracks, **kw, device="cpu"),
                              spec, 0.02, 2, sharded=sharded, **okw)
    z = torch.tensor(spec.to_unconstrained(), requires_grad=True)
    v = neg(z)
    (g,) = torch.autograd.grad(v, z)
    return neg, float(v.detach()), g.numpy()


def test_sharded_objective_matches_jax():
    """make_objective(sharded=...) on eight CPU shards with per-peak
    errors and per-step dt: value 1e-12 and z-gradient 1e-10 against the
    JAX package's on its 8-device mesh (tests/test_sharded_tables.py)."""
    tracks, kw, gen, okw = _objective_data(True, True)
    jspec = jparams.generate_params(**gen)
    jneg = jfit.make_objective(jdata.from_dict(tracks, **kw), jspec, 0.02,
                               2, sharded=True, compute_engine="xla", **okw)
    want_v, want_g = jax.value_and_grad(jneg)(
        jnp.asarray(jspec.to_unconstrained()))
    neg, v, g = _port_value_grad(tracks, kw, gen, okw, MESH8)
    assert neg.mesh is MESH8
    np.testing.assert_allclose(v, float(want_v), rtol=1e-12)
    np.testing.assert_allclose(g, np.asarray(want_g), rtol=1e-10, atol=1e-9)
    assert np.isfinite(g).all()


@pytest.mark.parametrize("input_loc_err,per_step_dt", [
    (False, False), (True, False), (False, True), (True, True)])
def test_sharded_objective_matches_unsharded(input_loc_err, per_step_dt):
    """Eight shards, three shards and one shard (``sharded=True`` on a CPU
    batch) against the unsharded objective: value 1e-12, z-gradient
    1e-10; one shard bit for bit."""
    data = _objective_data(input_loc_err, per_step_dt)
    _, v1, g1 = _port_value_grad(*data, False)
    for sharded in (MESH8, pmesh.make_mesh(devices=["cpu"] * 3)):
        _, v, g = _port_value_grad(*data, sharded)
        np.testing.assert_allclose(v, v1, rtol=1e-12)
        np.testing.assert_allclose(g, g1, rtol=1e-10, atol=1e-9)
    neg, v, g = _port_value_grad(*data, True)
    assert neg.mesh.devices == (torch.device("cpu"),)
    assert v == v1 and np.array_equal(g, g1)


def test_table_specs():
    tracks, sigmas = _sim(seed=3, nb_tracks=50, LocErr_std=0.007)
    tb = tdata.from_dict(tracks, input_loc_err=sigmas,
                         dt=_dts(tracks, "step"), device="cpu")
    B = tb.batch_size
    tt = ttables.build_tables(
        *(_t(a) for a in ([0.0, 0.08],)), tb.loc_err,
        *(_t(a) for a in ([0.5, 0.5], [[0.0, 0.1], [0.1, 0.0]], 0.05)),
        tb.dt, cell_dims=(0.5,))
    specs = pmesh.table_specs(tt, B)
    assert specs.loc_err2 == pmesh.DATA_AXIS == "data"
    assert specs.sig2 == "data" and specs.log_trans is None
    _, tt0 = _tables()
    assert set(pmesh.table_specs(tt0, B)) == {None}
    # the per-track leaves split with the shards' rows, padded with ones
    sb = pmesh.shard_batch(tb, MESH8)
    parts = pmesh.split_tables(tt, sb)
    le2 = torch.cat([p.loc_err2 for p in parts])
    assert torch.equal(le2[:B], tt.loc_err2) and (le2[B:] == 1).all()
    assert all(torch.equal(p.log_trans, tt.log_trans) for p in parts)


def _batch_tables(seed=0, B=36, T=9, D=2):
    rng = np.random.default_rng(seed)
    tracks = {}
    lens = rng.integers(3, T + 1, B)
    for L in np.unique(lens):
        n = int((lens == L).sum())
        tracks[str(L)] = np.cumsum(rng.normal(0, 0.05, (n, int(L), D)),
                                   axis=1)
    args = ([0.0, 0.1], 0.02, [0.4, 0.6], [[0.0, 0.1], [0.15, 0.0]], 0.1,
            0.02)
    jt = jtables.build_tables(*(jnp.asarray(a) for a in args),
                              cell_dims=(0.8,))
    tt = ttables.build_tables(*(_t(a) for a in args), cell_dims=(0.8,))
    return tracks, jt, tt


def test_sharded_posteriors_match_jax():
    tracks, jt, tt = _batch_tables(1)
    jm = jmesh.make_mesh()
    jb, tb = jdata.from_dict(tracks), tdata.from_dict(tracks, device="cpu")
    B = tb.batch_size
    jl, jp = jmesh.sharded_posteriors(jmesh.shard_batch(jb, jm), jt,
                                      window=5, min_len=3, mesh=jm)
    tl, tp = pmesh.sharded_posteriors(tb, tt, window=5, min_len=3,
                                      mesh=MESH8)
    assert tl.shape == (B,) and tp.shape == (B, tb.max_len, 2)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[:B], rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp)[:B], rtol=1e-12,
                               atol=1e-12)


def test_sharded_histogram_matches_jax():
    tracks, jt, tt = _batch_tables(2)
    jm = jmesh.make_mesh()
    jb, tb = jdata.from_dict(tracks), tdata.from_dict(tracks, device="cpu")
    want = jmesh.sharded_histogram(jmesh.shard_batch(jb, jm), jt, window=5,
                                   min_len=3, mesh=jm)
    got = pmesh.sharded_histogram(tb, tt, window=5, min_len=3, mesh=MESH8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
    single = jhist.window_segment_histogram(
        jb.positions, jb.lengths, jb.is_bleached, jt, window=5, min_len=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(single), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("per_peak", [False, True])
def test_sharded_refine_matches_jax(per_peak):
    tracks, _, _ = _batch_tables(3 + per_peak)
    jm = jmesh.make_mesh()
    jb, tb = jdata.from_dict(tracks), tdata.from_dict(tracks, device="cpu")
    B = tb.batch_size
    trmat = np.array([[0.9, 0.1], [0.2, 0.8]])
    sig2 = np.array([0.02 ** 2, 0.1 ** 2])
    if per_peak:
        le2 = np.random.default_rng(0).uniform(
            0.01, 0.04, tuple(tb.positions.shape)) ** 2
    else:
        le2 = np.full((1, 1, 1), 0.02 ** 2)
    sb = jmesh.shard_batch(jb, jm)
    jle2 = jnp.asarray(le2)
    if per_peak:
        jle2 = jax.device_put(
            jnp.pad(jle2, ((0, sb.batch_size - B), (0, 0), (0, 0)),
                    constant_values=1.0),
            jax.sharding.NamedSharding(
                jm, jax.sharding.PartitionSpec(jmesh.DATA_AXIS)))
    jmu, jsg = jmesh.sharded_refine(sb.positions, sb.lengths, jle2,
                                    jnp.log(jnp.asarray(trmat)),
                                    jnp.asarray(sig2), window=5, mesh=jm)
    mu, sg = pmesh.sharded_refine(tb.positions, tb.lengths, _t(le2),
                                  torch.log(_t(trmat)), _t(sig2), window=5,
                                  mesh=MESH8)
    assert mu.shape == tuple(tb.positions.shape)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu)[:B], rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(sg.numpy(), np.asarray(jsg)[:B], rtol=1e-12,
                               atol=1e-12)
    # and the unsharded plain refinement of the JAX package
    umu, usg = jrefine.refine_positions(jb.positions, jb.lengths,
                                        jnp.asarray(le2),
                                        jnp.log(jnp.asarray(trmat)),
                                        jnp.asarray(sig2), window=5)
    np.testing.assert_allclose(mu.numpy(), np.asarray(umu), rtol=1e-12,
                               atol=1e-12)
    del usg


def test_engine_forward_unsharded_reference():
    """The sharded posteriors' logL equals the unsharded JAX engine's."""
    tracks, jt, tt = _batch_tables(5)
    jb, tb = jdata.from_dict(tracks), tdata.from_dict(tracks, device="cpu")
    want = jengine.forward(jb.positions, jb.lengths, jb.is_bleached, jt,
                           window=4, min_len=3)
    got, _ = pmesh.sharded_posteriors(tb, tt, window=4, min_len=3,
                                      mesh=pmesh.make_mesh(3, ["cpu"] * 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
