"""The pedestrian and NBA registry experiments of the port against the JAX
registry's, on the CPU: each of the four (smoke and full width) with the
same config and meta (through JSON, as the run registry stores them),
TrainerConfig, loaders and DiT dtypes; the smoke registries' first batches
bit for bit (the JAX native batch engine off); ``test_batches``.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_slide_tpu import native
from lam_slide_tpu.experiments import registry as jreg
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


EXPERIMENTS = ("pedestrian_first_stage", "pedestrian_second_stage", "nba_first_stage",
               "nba_second_stage")


def _two_sample_batch(loader):
    """A stand-in for the JAX registry's init batch: two samples of the
    loader's dataset (its first batch at full width would run the DiT init
    over a whole registry batch; the pedestrian stage 1 has no whole batch
    of the synthetic data)."""
    rng = np.random.default_rng(0)
    samples = [loader.dataset.sample(i, rng) for i in range(2)]
    return jax.tree.map(jnp.asarray, loader.collate_fn(samples))


@functools.lru_cache(maxsize=None)
def _jax_smoke_run(name):
    """The JAX registry's smoke run (its init compiles: built once here)."""
    return getattr(jreg, name)(smoke=True)


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("name", EXPERIMENTS)
def test_registry_matches_jax(monkeypatch, name, smoke):
    """Each experiment from both registries (full width: the JAX stage 2 on
    a JAX stage 1's init variables in place of a run id, the port's on a
    stage-1 run of the same process; NBA stage 2 at B=2 on both): the
    config and meta (through JSON, as the run registry stores them), the
    TrainerConfig, the loaders' batch sizes and names, the training DiT's
    dtype and the fp32 test model."""
    if not smoke:
        monkeypatch.setattr(jreg, "_concat_loaders_batch", _two_sample_batch)
    kw = dict(smoke=smoke)
    if name == "nba_second_stage" and not smoke:
        kw["batch_size"] = 2
    tkw = dict(kw, device="cpu")
    if name.endswith("second_stage") and not smoke:
        first = name.replace("second", "first")
        jrun1 = getattr(jreg, first)()
        monkeypatch.setattr(jreg, "load_first_stage_variables",
                            lambda ws, run_id, which="best": (jrun1.variables, jrun1.meta))
        kw["first_stage_run"] = "s1"
        tkw["first_stage"] = getattr(treg, first)(device="cpu")
    jrun = _jax_smoke_run(name) if smoke else getattr(jreg, name)(**kw)
    run = treg.build_experiment(name, **tkw)
    jmeta = json.loads(json.dumps(jrun.meta))
    meta = json.loads(json.dumps(run.meta))
    if not smoke and name.endswith("second_stage"):
        assert jmeta.pop("first_stage_run") == "s1" and meta.pop("first_stage_run") is None
    assert meta == jmeta
    assert dataclasses.asdict(run.trainer_cfg) == dataclasses.asdict(jrun.trainer_cfg)
    assert run.train_loader.batch_size == jrun.train_loader.batch_size
    assert run.train_loader.drop_last == jrun.train_loader.drop_last
    assert len(run.train_loader) == len(jrun.train_loader)
    assert {k: (l.batch_size, len(l)) for k, l in run.val_loaders.items()} == {
        k: (l.batch_size, len(l)) for k, l in jrun.val_loaders.items()}
    if name.endswith("second_stage"):
        assert set(run.test_loaders) == set(jrun.test_loaders)
        assert set(run.eval_fns) == set(jrun.eval_fns) == {"val_sample"}
        dit = run.model.backbone
        assert dit.dtype == (torch.float32 if smoke else torch.bfloat16)
        assert run.test_model.backbone.backbone.dtype == torch.float32
        assert (dit.hidden_size, dit.num_heads, dit.depth) == (
            run.config.hidden_size, run.config.num_heads, run.config.depth)


@pytest.mark.parametrize("name", EXPERIMENTS)
def test_registry_first_batches_match_jax(name):
    """The smoke registries' train batches of the same epoch and first val
    batches, bit for bit (the JAX registry takes its init batch from the
    train loader's first epoch)."""
    jrun = _jax_smoke_run(name)
    run = treg.build_experiment(name, smoke=True, device="cpu")
    next(iter(run.train_loader))
    _assert_same(next(iter(run.train_loader)), next(iter(jrun.train_loader)))
    for key in jrun.val_loaders:
        _assert_same(next(iter(run.val_loaders[key])), next(iter(jrun.val_loaders[key])))


def test_test_batches_keeps_the_first_batches():
    run = treg.nba_second_stage(smoke=True, device="cpu", test_batches=2)
    full = treg.nba_second_stage(smoke=True, device="cpu")
    (name, loader), = run.test_loaders.items()
    assert len(loader) == 2 < len(full.test_loaders[name])
    got = list(loader)
    assert len(got) == 2
    for g, w in zip(got, full.test_loaders[name]):
        _assert_same(g, w)
    assert loader.dataset is run.val_loaders[name].dataset
