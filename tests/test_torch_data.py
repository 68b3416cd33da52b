"""Parity of the PyTorch port's data model and host simulator with the JAX
package: bucket cuts and padded arrays identical to from_dict_bucketed, and
the numpy simulator bit-identical for the same seed."""
import numpy as np
import pytest
import torch

from extrack_tpu import data as jdata, simulate as jsim
from extrack_tpu_torch import data as tdata, simulate as tsim
import tests.torch_threads  # noqa: F401,E402  (one intra-op thread)


def _tracks(seed=0):
    tracks, _, sigmas = jsim.sim_fov(
        nb_tracks=300, max_track_len=9, min_track_len=2, LocErr=0.02,
        Ds=(0.0, 0.08), dt=0.02, pBL=0.1, cell_dims=(0.5, None, None),
        LocErr_std=0.3, seed=seed)
    return tracks, sigmas


@pytest.mark.parametrize("max_buckets", [1, 3])
def test_from_dict_bucketed_matches(max_buckets):
    tracks, sigmas = _tracks()
    rng = np.random.default_rng(1)
    dts = {k: rng.uniform(0.01, 0.03, (v.shape[0], v.shape[1] - 1))
           for k, v in tracks.items()}
    kw = dict(max_buckets=max_buckets, input_loc_err=sigmas, dt=dts)
    jb = jdata.from_dict_bucketed(tracks, **kw)
    tb = tdata.from_dict_bucketed(tracks, **kw, device="cpu",
                                   dtype=torch.float64)
    assert len(jb) == len(tb)
    for j, t in zip(jb, tb):
        assert (t.batch_size, t.max_len, t.nb_dims) == (
            j.batch_size, j.max_len, j.nb_dims)
        for f in ("positions", "lengths", "loc_err", "is_bleached", "dt"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)),
                                          err_msg=f)
        np.testing.assert_array_equal(tdata.host_lengths(t),
                                      jdata.host_lengths(j))


def test_partition_cuts_and_helpers():
    rng = np.random.default_rng(2)
    for _ in range(5):
        lens = sorted(rng.choice(np.arange(2, 40), 12, replace=False))
        counts = rng.integers(1, 500, 12)
        for mb in (1, 2, 4, 7):
            assert tdata.partition_cuts(lens, counts, mb) == \
                jdata.partition_cuts(lens, counts, mb)
    tracks, _ = _tracks(3)
    b = tdata.from_dict(tracks, pad_batch=sum(map(len, tracks.values())) + 5,
                        device="cpu", dtype=torch.float32)
    assert b.positions.dtype == torch.float32
    assert b.lengths.dtype == torch.int32
    assert (tdata.host_lengths(b)[-5:] == 0).all()
    back = tdata.to_dict(b)
    assert sorted(back) == sorted(tracks, key=int)
    for k in tracks:
        np.testing.assert_allclose(back[k], tracks[k], rtol=1e-6)
    assert tdata.default_min_len(np.array([0, 1, 4, 3])) == 3
    assert tdata.default_min_len(np.array([0, 1])) == 2


def test_sim_fov_matches_jax_simulator():
    kw = dict(nb_tracks=400, max_track_len=12, min_track_len=3,
              LocErr=0.02, Ds=(0.0, 0.08), dt=0.02, pBL=0.1,
              LocErr_std=0.2, seed=7)
    want = jsim.sim_fov(cell_dims=(0.5, None, None), **kw)
    got = tsim.sim_fov(cell_dims=(0.5,), **kw)     # trailing None implied
    for w, g in zip(want, got):
        assert sorted(w) == sorted(g)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    # chunked path merges per-chunk dicts the same way
    kw2 = dict(kw, nb_tracks=300, max_chunk_tracks=128)
    for w, g in zip(jsim.sim_fov(cell_dims=(0.5, None, None), **kw2),
                    tsim.sim_fov(cell_dims=(0.5, None, None), **kw2)):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_from_dict_defaults_to_the_card():
    """Without ``device`` a batch is built on the card (float32), and
    where there is none the call raises, naming device='cpu'."""
    tracks, _ = _tracks(4)
    if torch.cuda.is_available():
        b = tdata.from_dict(tracks)
        assert b.positions.device.type == "cuda"
        assert b.positions.dtype == torch.float32
        return
    for build in (tdata.from_dict, tdata.from_dict_bucketed):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(tracks)
    b = tdata.from_dict(tracks, device="cpu")
    assert b.positions.dtype == torch.float64
