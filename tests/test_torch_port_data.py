"""The port's copied MD17 data pipeline against the JAX package's, on the CPU.

``lam_slide_tpu_torch.data`` (``MD17Dataset``, the collates, ``Loader``) and
the registry's loaders must give the JAX package's batches for the same seed,
bit for bit: the same numpy code on the same draws. Both packages also
assemble stage-2 batches in a C++ engine whose float sums may round
differently from numpy's; here both run their numpy forms (the engines are
held to each other and to the numpy forms in
``tests/test_torch_port_native_engine.py``).
"""

import threading

import numpy as np
import pytest
import torch

from lam_slide_tpu import native
from lam_slide_tpu.data import collate as jcollate
from lam_slide_tpu.data import loader as jloader
from lam_slide_tpu.data import md17 as jmd17
from lam_slide_tpu.experiments import registry as jreg
from lam_slide_tpu_torch.data import collate as tcollate
from lam_slide_tpu_torch.data import loader as tloader
from lam_slide_tpu_torch.data import md17 as tmd17
from lam_slide_tpu_torch.data.loader import device_batch
from lam_slide_tpu_torch.experiments import registry as treg


@pytest.fixture(autouse=True)
def numpy_batch_assembly(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    monkeypatch.setenv("LAM_SLIDE_NO_NATIVE", "1")  # the port's numpy forms too


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


DATASETS = [
    dict(molecule="aspirin", mode="train", first_stage=True, rand_rotation=True),
    dict(molecule="benzene", mode="val", first_stage=False, rand_rotation=False),
    dict(molecule="ethanol", mode="train", first_stage=False, rand_rotation=True,
         rand_translation=0.1, scale=0.893, shift=0.1),
]


@pytest.mark.parametrize("kw", DATASETS, ids=lambda kw: f"{kw['molecule']}-{kw['mode']}")
def test_md17_dataset_samples_match_jax(kw):
    common = dict(span=30, num_entities=32, synthetic_frames=3000, force_length=40)
    jds, tds = jmd17.MD17Dataset(**common, **kw), tmd17.MD17Dataset(**common, **kw)
    assert len(tds) == len(jds)
    np.testing.assert_array_equal(tds.x, jds.x)
    for idx in (0, 7, len(jds) - 1):
        _assert_same(tds.sample(idx, np.random.default_rng(idx)),
                     jds.sample(idx, np.random.default_rng(idx)))
    if not kw["first_stage"]:
        idxs = np.array([3, 0, 11, 5])
        _assert_same(tds.sample_batch(idxs, np.random.default_rng(1)),
                     jds.sample_batch(idxs, np.random.default_rng(1)))


def test_load_md17_split_matches_jax():
    for mode in ("train", "val", "test"):
        got = tmd17.load_md17_split(None, "uracil", mode, 30, synthetic_frames=2000)
        want = jmd17.load_md17_split(None, "uracil", mode, 30, synthetic_frames=2000)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("temporal", [False, True], ids=["pad_collate", "temporal"])
def test_collates_match_jax(temporal):
    ds = dict(span=30, num_entities=32, synthetic_frames=3000, first_stage=not temporal)
    samples = [jmd17.MD17Dataset(molecule=m, mode="train", **ds).sample(i, np.random.default_rng(i))
               for i, m in enumerate(("aspirin", "benzene", "uracil"))]
    name = "pad_collate_temporal" if temporal else "pad_collate"
    _assert_same(getattr(tcollate, name)(samples, 32), getattr(jcollate, name)(samples, 32))


@pytest.mark.parametrize("first_stage", [True, False], ids=["stage1", "stage2"])
@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffled", "ordered"])
def test_loader_gives_the_jax_batches(first_stage, shuffle):
    """Two epochs of the same seed: per-sample path + collate for stage 1,
    the dataset's whole-batch path for stage 2 (a single MD17Dataset with
    the canonical temporal collate, as the val loaders are)."""
    import functools

    kw = dict(molecule="aspirin", mode="train", span=30, num_entities=32,
              synthetic_frames=3000, first_stage=first_stage, force_length=40)
    name = "pad_collate" if first_stage else "pad_collate_temporal"
    loaders = [mod.Loader(ds_mod.MD17Dataset(**kw), 8,
                          functools.partial(getattr(col, name), num_entities=32),
                          shuffle=shuffle, seed=3, drop_last=False)
               for mod, ds_mod, col in ((tloader, tmd17, tcollate), (jloader, jmd17, jcollate))]
    assert len(loaders[0]) == len(loaders[1]) == 5
    for _ in range(2):
        got, want = (list(loader) for loader in loaders)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)


@pytest.mark.parametrize("stage", [1, 2])
def test_registry_loaders_give_the_jax_batches(stage):
    """The smoke registries' train and val loaders (the train sets of two
    molecules concatenated, drawn per sample; one val loader each)."""
    if stage == 1:
        trun, jrun = treg.md17_first_stage(smoke=True, device="cpu"), jreg.md17_first_stage(
            smoke=True)
    else:
        t1 = treg.md17_first_stage(smoke=True, device="cpu")
        trun = treg.md17_second_stage(first_stage=t1, smoke=True, device="cpu")
        jrun = jreg.md17_second_stage(smoke=True)
    # the JAX registry draws one train batch for its model's init, which
    # starts the loader's epoch 0 (the port draws its weights from a seed)
    jrun.train_loader._epoch = 0
    assert len(trun.train_loader) == len(jrun.train_loader)
    assert set(trun.val_loaders) == set(jrun.val_loaders)
    for got, want in zip(trun.train_loader, jrun.train_loader):
        _assert_same(got, want)
    for name, loader in trun.val_loaders.items():
        _assert_same(next(iter(loader)), next(iter(jrun.val_loaders[name])))


def test_device_batch_keeps_dtypes_and_shares_memory_on_the_cpu():
    batch = next(iter(treg.md17_first_stage(smoke=True, device="cpu").train_loader))
    out = device_batch(batch, "cpu")
    for k, v in batch.items():
        assert out[k].dtype == torch.from_numpy(v).dtype and tuple(out[k].shape) == v.shape
        assert out[k].data_ptr() == v.ctypes.data  # no copy on the CPU
    assert out["attention_mask"].dtype == torch.bool


def test_loader_stopped_early_leaves_no_thread():
    loader = treg.md17_first_stage(smoke=True, device="cpu").train_loader
    before = threading.active_count()
    it = iter(loader)
    next(it)
    it.close()
    assert threading.active_count() == before
    with pytest.raises(ZeroDivisionError):  # a worker's error reaches the consumer
        list(tloader.Loader(_Failing(), 2, lambda s: s))


class _Failing(tloader.Dataset):
    def __len__(self):
        return 4

    def sample(self, idx, rng):
        return 1 / 0
