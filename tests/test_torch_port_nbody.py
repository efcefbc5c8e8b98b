"""The port's GeoTDM n-body layer (``data/nbody.py``) against the JAX
package's, on the CPU: the same numpy code, so bit for bit.

Trajectory windows (``at``, ``cut``, ``n_windows``), ``roll``, ``snapshot``
and ``state``; the edge functions; the synthetic leapfrog/gravity/charged
simulation and ``load_nbody`` on raw files; ``NBodyDataset`` samples of both
stages at one seed and a batch through the port's ``Loader`` and
``pad_collate_temporal``; the package exports.
"""

import functools

import numpy as np
import pytest

import lam_slide_tpu.data as jdata
import lam_slide_tpu_torch.data as tdata
from lam_slide_tpu.data import nbody as jnb
from lam_slide_tpu_torch.data import nbody as tnb


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k], want[k]
        if w is None:
            assert g is None, k
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def _traj(mod, t=6, n=4):
    rng = np.random.default_rng(0)
    return mod.Trajectory(x=rng.standard_normal((t, n, 3)).astype(np.float32),
                          v=rng.standard_normal((t, n, 3)).astype(np.float32),
                          h=rng.standard_normal((n, 1)).astype(np.float32),
                          t=np.arange(t, dtype=np.float32),
                          extras={"system_id": np.asarray([3.0], np.float32)})


def _fields(traj):
    return {"x": traj.x, "v": traj.v, "h": traj.h, "t": traj.t, **traj.extras}


OPS = {
    "at_slice": lambda tr: _fields(tr.at(slice(1, 4))),
    "at_int": lambda tr: _fields(tr.at(2)),
    "at_list": lambda tr: _fields(tr.at([0, 2, 5])),
    "at_tuple": lambda tr: _fields(tr.at((1, 3))),
    "cut": lambda tr: (tr.cut(slice(2, 5)), _fields(tr))[1],
    "cut_int": lambda tr: (tr.cut(3), _fields(tr))[1],
    "roll": lambda tr: (tr.roll(next_x=np.ones((2, 4, 3), np.float32),
                                next_v=np.zeros((2, 4, 3), np.float32),
                                next_t=np.asarray([6.0, 7.0])), _fields(tr))[1],
    "snapshot_last": lambda tr: tr.snapshot(),
    "snapshot_concat": lambda tr: tr.snapshot(reduce_x="concat", reduce_v="concat",
                                              reduce_t=None),
    "snapshot_full": lambda tr: tr.snapshot(reduce_x="all", reduce_v=None),
    "state": lambda tr: {"state": tr.state, "len": np.asarray(len(tr)),
                         "windows": np.asarray([tr.n_windows(s) for s in (1, 4, 6)])},
}


@pytest.mark.parametrize("op", list(OPS))
def test_trajectory_ops_match_jax(op):
    _assert_same(OPS[op](_traj(tnb)), OPS[op](_traj(jnb)))


def test_single_frame_promotes():
    got, want = tnb.Trajectory(x=np.ones((4, 3))), jnb.Trajectory(x=np.ones((4, 3)))
    assert got.x.shape == want.x.shape == (1, 4, 3)


@pytest.mark.parametrize("name", ["spring_train", "gravity_train", "charged_train"])
def test_edges_and_simulation_match_jax(name):
    for n in (1, 3, 5):
        np.testing.assert_array_equal(tnb.fully_connected_edges(n),
                                      jnb.fully_connected_edges(n))
    got = tnb._simulate_synthetic(name, 3, 12, 5, seed=2)
    want = jnb._simulate_synthetic(name, 3, 12, 5, seed=2)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    ei = tnb.fully_connected_edges(5)
    np.testing.assert_array_equal(tnb.nbody_edge_attr(name, ei, got[3][0], got[2][0]),
                                  jnb.nbody_edge_attr(name, ei, want[3][0], want[2][0]))


@pytest.mark.parametrize("name", ["spring_train", "gravity_train"])
def test_load_nbody_raw_files_match_jax(tmp_path, name):
    rng = np.random.default_rng(4)
    s, t, n = 3, 7, 5
    loc = rng.standard_normal((s, t, 3, n) if "gravity" not in name else (s, t, n, 3))
    np.save(tmp_path / "loc_x.npy", loc)
    np.save(tmp_path / "vel_x.npy", rng.standard_normal(loc.shape))
    np.save(tmp_path / "edges_x.npy", rng.integers(0, 2, (s, n, n)))
    np.save(tmp_path / "charges_x.npy", rng.choice([-1.0, 1.0], (s, n)))
    got = tnb.load_nbody(str(tmp_path), name, "x")
    want = jnb.load_nbody(str(tmp_path), name, "x")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


DATASETS = [
    dict(name="spring_train", span=10),
    dict(name="charged_train", span=None, obs_noise_scale=0.1, return_index=True),
    dict(name="gravity_train", span=20, project=True, force_length=5),
    dict(name="spring_train", first_stage=True, include_edges=False),
]


@pytest.mark.parametrize("kw", DATASETS, ids=lambda kw: "-".join(map(str, kw.values())))
def test_dataset_samples_match_jax(kw):
    tds, jds = tnb.NBodyDataset(**kw), jnb.NBodyDataset(**kw)
    assert len(tds) == len(jds)
    for idx in (0, len(jds) - 1):
        _assert_same(tds.sample(idx, np.random.default_rng(idx)),
                     jds.sample(idx, np.random.default_rng(idx)))


def test_loader_batch_matches_jax():
    def batch(pkg):
        ds = pkg.NBodyDataset(name="spring_train", span=10, include_edges=False)
        collate = functools.partial(pkg.pad_collate_temporal, num_entities=ds.num_entities)
        it = iter(pkg.Loader(ds, 4, collate, seed=1))
        out = next(it)
        it.close()
        return out

    _assert_same(batch(tdata), batch(jdata))


def test_package_exports():
    assert set(tdata.__all__) == set(jdata.__all__)
    assert tdata.NBodyDataset is tnb.NBodyDataset and tdata.Trajectory is tnb.Trajectory
