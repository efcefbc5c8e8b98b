"""The port's 4AA data (``data/peptide.py``, the peptide augmentations and
the registry's collate) against the JAX package's, on the CPU.

The synthetic fallback (generator v1 and v2) through both packages with the
precompute cache off: the port runs the forward kinematics and the
precompute on its torch geometry, JAX on its jnp ops, so atom14, frame-local
positions and torsions agree to fp32 rounding of the same math (1e-5
absolute; coordinates are O(10) Å), masks and aatypes exactly. Samples at
one seed draw the same frames, windows, entities and augmentations. The two
packages' cache files never meet: other roots, other keys; and the port's
cache gives back what it stored.
"""

import os

import numpy as np
import pytest

from lam_slide_tpu.data import augment as jaug
from lam_slide_tpu.data import peptide as jpep
from lam_slide_tpu.experiments import registry as jreg
from lam_slide_tpu_torch.data import augment as taug
from lam_slide_tpu_torch.data import peptide as tpep
from lam_slide_tpu_torch.experiments import registry as treg

ATOL = 1e-5
FLOAT_KEYS = ("atom14_pos", "atom14_pos_frame", "torsions")


@pytest.fixture(autouse=True)
def no_data_cache(monkeypatch):
    monkeypatch.setenv("LAM_SLIDE_NO_DATA_CACHE", "1")


def _pair(**kw):
    return jpep.PeptideDataset(**kw), tpep.PeptideDataset(**kw)


def _assert_close(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k in FLOAT_KEYS:
            np.testing.assert_allclose(g, w, atol=ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("first_stage", [True, False])
def test_synthetic_dataset_matches_jax(version, first_stage):
    jds, tds = _pair(first_stage=first_stage, synthetic_peptides=2, synthetic_frames=48,
                     n_timesteps=16, synthetic_version=version, rand_rotation=True,
                     rand_translation=0.1, scale=10.0, shift=0.5)
    assert len(tds) == len(jds)
    for jt, tt in zip(jds.trajectories, tds.trajectories):
        assert tt["name"] == jt["name"] and tt["n_frames"] == jt["n_frames"]
        _assert_close({k: v for k, v in tt.items() if k not in ("name", "n_frames")},
                      {k: v for k, v in jt.items() if k not in ("name", "n_frames")})
    for idx in range(len(jds)):
        _assert_close(tds.sample(idx, np.random.default_rng(idx)),
                      jds.sample(idx, np.random.default_rng(idx)))


def test_frame_split_samples_match_jax():
    jds, tds = _pair(first_stage=False, synthetic_peptides=1, synthetic_frames=60,
                     n_timesteps=8, frame_split=(0.5, 1.0), repeats=3)
    assert len(tds) == len(jds) == 3
    for idx in range(3):
        _assert_close(tds.sample(idx, np.random.default_rng(7)),
                      jds.sample(idx, np.random.default_rng(7)))


def test_collate_and_augmentations_match_jax():
    jds, tds = _pair(first_stage=True, synthetic_peptides=2, synthetic_frames=24)
    rng_j, rng_t = np.random.default_rng(3), np.random.default_rng(3)
    samples_j = [jds.sample(i, rng_j) for i in range(2)]
    samples_t = [tds.sample(i, rng_t) for i in range(2)]
    _assert_close(treg._pep_collate(samples_t), jreg._pep_collate(samples_j))
    for seed in range(3):
        np.testing.assert_array_equal(taug.uniform_rotation_matrix(np.random.default_rng(seed)),
                                      jaug.uniform_rotation_matrix(np.random.default_rng(seed)))
    pts = np.random.default_rng(4).standard_normal((2, 5, 3)).astype(np.float32)
    rot, shift = jaug.uniform_rotation_matrix(np.random.default_rng(5)), np.ones(3, np.float32)
    np.testing.assert_array_equal(taug.centre_random_augmentation(pts, rot, shift),
                                  jaug.centre_random_augmentation(pts, rot, shift))


def test_cache_roots_and_keys_are_the_ports_own(monkeypatch, tmp_path):
    """Neither package reads the other's precompute: the default roots
    differ and, under one root, the file names do too; the port's cache
    returns the trajectory it stored."""
    monkeypatch.delenv("LAM_SLIDE_NO_DATA_CACHE")
    monkeypatch.delenv("LAM_SLIDE_DATA_CACHE", raising=False)
    monkeypatch.delenv("LAM_SLIDE_TORCH_DATA_CACHE", raising=False)
    kw = dict(first_stage=True, synthetic_peptides=1, synthetic_frames=24)
    jds = jpep.PeptideDataset.__new__(jpep.PeptideDataset)
    tds = tpep.PeptideDataset.__new__(tpep.PeptideDataset)
    for ds, cls in ((jds, jpep.PeptideDataset), (tds, tpep.PeptideDataset)):
        for field, default in cls.__dataclass_fields__.items():
            setattr(ds, field, kw.get(field, default.default))
    jpath, tpath = jds._cache_path("synth0"), tds._cache_path("synth0")
    assert jpath != tpath
    assert os.path.dirname(jpath) != os.path.dirname(tpath)
    monkeypatch.setenv("LAM_SLIDE_DATA_CACHE", str(tmp_path))
    monkeypatch.setenv("LAM_SLIDE_TORCH_DATA_CACHE", str(tmp_path))
    assert os.path.basename(jds._cache_path("synth0")) != os.path.basename(
        tds._cache_path("synth0"))

    fresh = tpep.PeptideDataset(**kw)  # stores into tmp_path
    assert [p.name for p in tmp_path.iterdir()] == [os.path.basename(tds._cache_path("synth0"))]
    cached = tpep.PeptideDataset(**kw)  # loads it
    for a, b in zip(fresh.trajectories, cached.trajectories):
        assert a["name"] == b["name"] and a["n_frames"] == b["n_frames"]
        for k in FLOAT_KEYS + ("atom14_mask", "aatype", "torsions_mask"):
            np.testing.assert_array_equal(a[k], b[k])
    monkeypatch.setenv("LAM_SLIDE_NO_DATA_CACHE", "1")
    assert tds._cache_path("synth0") is None
