"""The port's multi-process input pipeline (``parallel.multihost``) in one
process: ``process_slice`` splits as the JAX package's does, and
``global_batch`` degenerates to this process's batch with the global
lengths (tests/test_multihost.py)."""
import numpy as np
import torch

from extrack_tpu import data as jdata, simulate as jsim
from extrack_tpu.core import tables as jtables
from extrack_tpu.parallel import mesh as jmesh, multihost as jmulti
from extrack_tpu_torch import data as tdata
from extrack_tpu_torch.core import tables as ttables
from extrack_tpu_torch.parallel import mesh as pmesh, multihost
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)


def test_process_slice_partitions_exactly():
    for n, pc in [(10, 4), (7, 3), (3, 8), (100, 8), (0, 2)]:
        slices = [multihost.process_slice(n, pi, pc) for pi in range(pc)]
        items = [i for s in slices for i in range(n)[s]]
        assert items == list(range(n))          # disjoint, ordered, complete
        assert slices == [jmulti.process_slice(n, pi, pc)
                          for pi in range(pc)]
    assert multihost.process_slice(5) == slice(0, 5)   # one process


def test_split_paths_single_process():
    paths = [f"f{i}.csv" for i in range(5)]
    assert multihost.split_paths(paths) == paths    # 1 process -> all files
    assert multihost.split_paths(paths) == jmulti.split_paths(paths)


def test_global_batch_matches_shard_batch():
    tracks, _, _ = jsim.sim_fov(
        nb_tracks=100, max_track_len=9, min_track_len=3, LocErr=0.02,
        Ds=(0.0, 0.08), TrMat=np.array([[0.9, .1], [.1, .9]]), dt=0.02,
        pBL=0.05, cell_dims=(0.5, None, None), seed=17)
    batch = tdata.from_dict(tracks, device="cpu")
    mesh = pmesh.make_mesh(devices=["cpu"] * 4)
    gb = multihost.global_batch(batch, mesh)
    assert gb.process_local and gb.batch_size % 4 == 0
    assert multihost.global_mesh().devices == (torch.device("cpu"),)
    np.testing.assert_array_equal(gb.np_lengths[:batch.batch_size],
                                  tdata.host_lengths(batch))
    assert (gb.np_lengths[batch.batch_size:] == 0).all()
    args = ([0.0, 0.08], 0.02, [0.5, 0.5], [[0.0, 0.1], [0.1, 0.0]], 0.05,
            0.02)
    tt = ttables.build_tables(*(torch.as_tensor(np.asarray(a, np.float64))
                                for a in args), cell_dims=(0.5,))
    logl = float(pmesh.sharded_log_likelihood(gb, tt, window=4, min_len=3,
                                              mesh=mesh))
    jt = jtables.build_tables(*(np.asarray(a) for a in args),
                              cell_dims=(0.5,))
    jgb = jmulti.global_batch(jdata.from_dict(tracks))
    want = float(jmesh.sharded_log_likelihood(jgb, jt, window=4, min_len=3,
                                              mesh=jmulti.global_mesh()))
    np.testing.assert_allclose(logl, want, rtol=1e-12)
