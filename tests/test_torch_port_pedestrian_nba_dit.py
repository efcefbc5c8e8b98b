"""The pedestrian and NBA stage 2 of the port against the JAX package, on
the CPU: the DiTs at their real head splits and the min-over-K test
protocol.

* Both stage-2 DiTs (``build_pedestrian_second_stage``,
  ``build_nba_second_stage``: the class-conditional ``LatentDiT``) at depth 2
  and the registries' widths and head splits, 4 x dh 32 at hidden 128 over
  L = 2 latents and 16 x dh 16 at hidden 256 over L = 8, T = 20 frames, in
  fp32 on weights from the JAX init carried over by ``convert.py``: the
  output within 1e-5 of the largest, against the JAX DiT with its Pallas
  kernels (K2, K7, K8 and K9) engaged in interpret mode, as the JAX
  package's own tests run them.
* ``evaluate_min_k`` on the smoke registries' fp32 test models (their DiT
  weights perturbed, so that the reference init's zero gates do not make
  every block the identity), K=4 samples of a test batch with the final
  position clustering off and on, each sample fed the same noise on both
  sides: the same keys, the min-over-K metrics within 1e-4 relative; and
  every metric, the clustering's included, within 1e-4 on the same
  samples (the clustering's picks are discontinuous in the samples; see
  the test).
* The val hook's domain branch (``make_protocol_val_hook(..., "nba")``) on
  a state's EMA weights, fed the same noise: within 1e-4.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lam_slide_tpu.ops.attention as jattn
from lam_slide_tpu import native
from lam_slide_tpu.composites import nba as jnba
from lam_slide_tpu.composites import pedestrian as jped
from lam_slide_tpu.composites import testing as jtesting
from lam_slide_tpu.experiments import registry as jreg
from lam_slide_tpu.ops import fused_adaln as jad
from lam_slide_tpu.ops import fused_mlp as jfm
from lam_slide_tpu.ops import fused_spatial_block as jsb
from lam_slide_tpu.train.state import create_train_state as j_create_train_state
from lam_slide_tpu.train.trainer import TrainerConfig as JTrainerConfig
from lam_slide_tpu.train.trainer import make_optimizer as j_make_optimizer
from lam_slide_tpu_torch import convert
from lam_slide_tpu_torch.composites import nba as tnba
from lam_slide_tpu_torch.composites import pedestrian as tped
from lam_slide_tpu_torch.composites import testing as ttesting
from lam_slide_tpu_torch.experiments import registry as treg
from lam_slide_tpu_torch.train import create_train_state

DIT_TOL = 1e-5  # fp32 sums in another order through two layers
PROTOCOL_RTOL = 1e-4  # Euler-10, two stages, then the min over K (and k-means)

WORKLOADS = {
    "pedestrian": (jped.PedestrianFirstStageConfig, jped.PedestrianSecondStageConfig,
                   jped.build_pedestrian_first_stage, jped.build_pedestrian_second_stage,
                   tped.PedestrianFirstStageConfig, tped.PedestrianSecondStageConfig,
                   tped.build_pedestrian_first_stage, tped.build_pedestrian_second_stage),
    "nba": (jnba.NBAFirstStageConfig, jnba.NBASecondStageConfig, jnba.build_nba_first_stage,
            jnba.build_nba_second_stage, tnba.NBAFirstStageConfig, tnba.NBASecondStageConfig,
            tnba.build_nba_first_stage, tnba.build_nba_second_stage),
}


@pytest.fixture(autouse=True)
def numpy_batch_assembly(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    monkeypatch.setenv("LAM_SLIDE_NO_NATIVE", "1")  # the port's numpy forms too


def _close(got, want, tol, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    scale = np.abs(want).max()
    assert scale > 0, f"{name} is zero: a vacuous match"
    assert np.abs(got - want).max() <= tol * scale, name


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_stage2_dit_matches_jax(monkeypatch, workload):
    """The class-conditional DiT at depth 2, the registry's width and head
    split (T = 20, L latents of the first stage's dim), in fp32 with random
    gates (``reference_init=False``), against the JAX DiT with K2, K7 and K8
    forced through their Pallas kernels and the temporal axis on K9's
    (``short``), in interpret mode."""
    for mod in (jad, jsb, jfm):
        monkeypatch.setattr(mod, "FORCE_KERNEL", True)
    monkeypatch.setattr(jattn, "FORCE_BACKEND", "short")
    j1c, j2c, j1b, j2b, t1c, t2c, t1b, t2b = WORKLOADS[workload]
    s1 = dict(dim_input=16, dim_latent=8, dim_entity=16, dim_head_cross=8, dim_head_latent=8,
              num_head_cross=2)
    full = t2c()
    s2 = dict(depth=2, in_dim=8, class_conditional=True, reference_init=False)
    jcfg, tcfg = j2c(**s2), t2c(**s2)
    assert (jcfg.hidden_size, jcfg.num_heads) == (full.hidden_size, full.num_heads)
    l = j1c().num_latents
    s1["num_latents"] = l
    jfs = j1b(j1c(**s1))
    rng = np.random.default_rng(20)
    b, t = 2, jcfg.num_timesteps
    x = rng.standard_normal((b, t, l, 8)).astype(np.float32)
    mask = np.zeros((b, t, l), np.int32)
    mask[:, :jcfg.cond_idx[1]] = 1
    x_cond = (x * mask[..., None]).astype(np.float32)
    tt = np.array([0.25, 0.8], np.float32)
    y = np.array([1, 0])
    jss = j2b(jcfg, jfs, None)
    args = (jnp.asarray(x), jnp.asarray(tt), jnp.asarray(x_cond), jnp.asarray(mask),
            jnp.asarray(y))
    params = jax.tree.map(np.asarray, jax.jit(jss.backbone.init)(jax.random.PRNGKey(2),
                                                                 *args)["params"])
    want = jax.jit(lambda p, *a: jss.backbone.apply({"params": p}, *a))(params, *args)
    ss = t2b(tcfg, t1b(t1c(**s1), device="cpu"), device="cpu")
    ss.backbone.load_state_dict(convert.class_cond_dit_state_dict_from_jax(params))
    dit = ss.backbone.backbone
    assert (dit.hidden_size // dit.num_heads, dit.num_heads) == (
        full.hidden_size // full.num_heads, full.num_heads)
    with torch.no_grad():
        got = ss.backbone(*(torch.from_numpy(np.array(a)) for a in (x, tt, x_cond, mask, y)))
    _close(got, want, DIT_TOL, "DiT output")


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype),
                        params)


@functools.lru_cache(maxsize=None)
def _jax_smoke_run(workload):
    """The JAX registry's smoke stage 2 (its init compiles: built once here;
    the tests read its variables and models, and change neither)."""
    return getattr(jreg, f"{workload}_second_stage")(smoke=True)


def _smoke_test_models(workload, seed):
    """The smoke registries' fp32 test models on the same weights: (the JAX
    run, its perturbed DiT params, its first-stage variables, the port's
    test model, the port's run); the port's two stage-2 bundles share the
    first stage."""
    jrun = _jax_smoke_run(workload)
    run = treg.build_experiment(f"{workload}_second_stage", smoke=True, device="cpu")
    params = _perturbed(jax.tree.map(np.asarray, jrun.variables["params"]), seed)
    fs_vars = jax.tree.map(np.asarray, jrun.variables["constants"]["first_stage"])
    ss = run.test_model
    ss.backbone.load_state_dict(convert.class_cond_dit_state_dict_from_jax(params))
    ss.first_stage.load_state_dict(convert.first_stage_state_dict_from_jax(
        fs_vars["params"], fs_vars["constants"]))
    return jrun, params, fs_vars, ss, run


K, NUM_RUNS = 4, 2
EULER = {"sampling_method": "euler", "num_steps": 10}


@pytest.mark.parametrize("post_process", [False, True])
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_evaluate_min_k_matches_jax(monkeypatch, workload, post_process):
    """K=4 samples of one test batch, k_chunk=1, the min over the first
    NUM_RUNS (and, with ``post_process``, over the k-means picks of the K
    final positions), two ways:

    * end to end, each sample from its own noise, fed alike to both
      protocols (JAX's K repeats traced one by one with ``normal``
      returning that repeat's noise; the port's through
      ``make_k_sample_fn``'s ``noise``): the min-over-K metrics within
      PROTOCOL_RTOL. The final-position clustering is left out of this
      comparison: its picks are discontinuous in the samples, and at the
      smoke width the K final positions of an entity lie within ~1e-2 of
      each other, so the fp32 rounding differences of the two samplers
      (~2e-7 of the largest position) can flip a k-means assignment or a
      nearest sample (read once: ade_post 1.8e-4 apart while the same
      function of the same samples agrees to 2e-7);
    * on the same samples (the port's, handed to both protocols): every
      metric, the clustering's included, within PROTOCOL_RTOL."""
    jrun, params, fs_vars, ss, run = _smoke_test_models(workload, 30)
    jss = jrun.test_model
    name, loader = next(iter(run.test_loaders.items()))
    batch = next(iter(loader))
    loaders = {name: [batch]}
    x1, _ = jax.jit(jss.prepare_batch)(fs_vars, {k: jnp.asarray(v) for k, v in batch.items()})
    noise = np.random.default_rng(31).standard_normal((K, *x1.shape)).astype(np.float32)
    repeat = [0]

    def jax_normal(key, shape, dtype=jnp.float32):
        assert tuple(shape) == noise.shape[1:]
        return jnp.asarray(noise[repeat[0]], dtype)

    def jax_k_sample_fn(self, k, k_chunk=None, **kw):
        sample = self.make_sample_fn(**kw)

        def sample_k(p, fs, b, rng):
            outs = []
            for i in range(k):
                repeat[0] = i
                outs.append(sample(p, fs, b, rng))
            return jax.tree.map(lambda *xs: jnp.stack(xs), *outs)

        return sample_k

    real = type(ss).make_k_sample_fn

    def torch_k_sample_fn(self, k, k_chunk=None, **kw):
        sample_k = real(self, k, k_chunk=k_chunk, **kw)
        return lambda b, noise_=None, generator=None: sample_k(b, noise=torch.from_numpy(noise))

    monkeypatch.setattr(jax.random, "normal", jax_normal)
    monkeypatch.setattr(type(jss), "make_k_sample_fn", jax_k_sample_fn)
    monkeypatch.setattr(type(ss), "make_k_sample_fn", torch_k_sample_fn)
    kw = dict(scale=2.5, k=K, num_runs=NUM_RUNS, post_process=post_process, k_chunk=1)
    want = jtesting.evaluate_min_k(jss, params, fs_vars, loaders, **kw)
    got = ttesting.evaluate_min_k(ss, loaders, **kw)
    suffixes = ("ade", "fde", "ade_post", "fde_post") if post_process else ("ade", "fde")
    assert set(got) == set(want) == {f"test/{name}/{s}" for s in suffixes}
    assert all(np.isfinite(v) for v in got.values())
    for key in (f"test/{name}/ade", f"test/{name}/fde"):
        assert abs(got[key] - want[key]) <= PROTOCOL_RTOL * abs(want[key]), (key, got, want)

    # the same samples on both sides: the port's, for the zeroed batch
    zeroed = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    zeroed["pos"][:, ss.cond_idx[1]:] = 0
    with torch.no_grad():
        samples = real(ss, K, k_chunk=1, sampling_method="ODE", sampling_kwargs=EULER)(
            zeroed, noise=torch.from_numpy(noise))
    monkeypatch.setattr(type(jss), "make_k_sample_fn", lambda self, k, k_chunk=None, **_: (
        lambda p, fs, b, rng: {key: jnp.asarray(v.numpy()) for key, v in samples.items()}))
    monkeypatch.setattr(type(ss), "make_k_sample_fn", lambda self, k, k_chunk=None, **_: (
        lambda b, noise=None, generator=None: samples))
    want = jtesting.evaluate_min_k(jss, params, fs_vars, loaders, **kw)
    got = ttesting.evaluate_min_k(ss, loaders, **kw)
    assert set(got) == set(want)
    for key, value in want.items():
        assert abs(got[key] - value) <= PROTOCOL_RTOL * abs(value), (key, got[key], value)
    with pytest.raises(ValueError, match="num_runs"):
        ttesting.evaluate_min_k(ss, loaders, k=1, num_runs=2)


def test_nba_val_hook_on_ema_weights_matches_jax(monkeypatch):
    """The min-over-K val hook (K=2 repeats as one batch, the first batch of
    the loader) on the state's EMA weights, which differ from its weights,
    fed the same initial noise on both sides."""
    jrun, params, fs_vars, _, run = _smoke_test_models("nba", 32)
    ema = _perturbed(params, 33)
    jtx, _ = j_make_optimizer(JTrainerConfig(), 1)
    jstate = j_create_train_state({"params": params, "constants": {"first_stage": fs_vars}},
                                  jtx).replace(ema_params=jax.tree.map(jnp.asarray, ema))
    ss = run.second_stage
    run.model.load_state_dict(convert.class_cond_dit_state_dict_from_jax(params))
    state = create_train_state(run.model, run.tx)
    state.ema_params = {k: v.clone() for k, v in
                        convert.class_cond_dit_state_dict_from_jax(ema).items()
                        if k in state.ema_params}
    name, loader = next(iter(run.val_loaders.items()))
    batch = next(iter(loader))
    x1, _ = jax.jit(jrun.model.prepare_batch)(fs_vars, {k: jnp.asarray(v)
                                                        for k, v in batch.items()})
    noise = np.random.default_rng(34).standard_normal(x1.shape).astype(np.float32)

    def jax_normal(key, shape, dtype=jnp.float32):
        return jnp.asarray(noise, dtype)

    def torch_randn(shape, generator=None, device=None, dtype=None):
        return torch.from_numpy(np.broadcast_to(noise, tuple(shape)).copy()).to(device, dtype)

    monkeypatch.setattr(jax.random, "normal", jax_normal)
    monkeypatch.setattr(torch, "randn", torch_randn)
    loaders = {name: [batch, batch]}
    kw = dict(k=2, num_runs=2, limit_batches=1)
    want = jtesting.make_protocol_val_hook(jrun.model, loaders, "nba", **kw)(jstate, 0)
    hook = ttesting.make_protocol_val_hook(ss, loaders, "nba", **kw)
    got = hook(state, 0)
    assert set(got) == set(want) == {"ade", "fde"}
    for key in got:
        assert abs(got[key] - want[key]) <= PROTOCOL_RTOL * abs(want[key]), key
    on_weights = dataclasses.replace(state, ema_params=dict(run.model.named_parameters()))
    assert hook(on_weights, 0) != got
