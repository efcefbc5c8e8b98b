"""The port's 4AA eval pieces (``analysis/``) against the JAX package's, on
the CPU.

* One Euler-10 rollout window in fp32, at smoke width and at 2 x dh 128
  (hidden 256, the head width of the 3 x 128 split, whose temporal
  attention takes K5's branch): the port's
  ``make_sample_fn(...)(batch, noise=...)`` fed the noise JAX draws
  (lam_slide_tpu/composites/second_stage.py:202-203: split the key, then
  ``normal``) on the JAX weights, decoded ``atom14_pos`` within 1e-4 of the
  largest |pos| (nine Euler steps through a two-layer fp32 DiT and the fp32
  decoder, sums in another order). Then a chain of two windows through
  ``RolloutSampler.sample_rollout`` and ``sample_rollout_batched`` against
  JAX's with each window fed JAX's draws: the same chain semantics (the
  exact conditioning first frame, masks, scale and shift) within the same
  limit; ``create_batch`` equal.
* The copied numpy/scipy modules (``jsd``, ``tica``, ``msm``,
  ``decorrelation``, ``backbone``) give JAX's outputs bit for bit on the
  same arrays; ``features`` (the port's geometry) within 1e-5 rad of JAX's
  angles; ``evaluate_peptides`` on the same samples gives JAX's summary
  within 1e-6 (the torsion histograms bin the same angles).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_slide_tpu.analysis import backbone as jbackbone
from lam_slide_tpu.analysis import decorrelation as jdecor
from lam_slide_tpu.analysis import eval_peptide as jeval
from lam_slide_tpu.analysis import features as jfeat
from lam_slide_tpu.analysis import jsd as jjsd
from lam_slide_tpu.analysis import msm as jmsm
from lam_slide_tpu.analysis import tica as jtica
from lam_slide_tpu.analysis.rollout import RolloutSampler as JRollout
from lam_slide_tpu.composites import peptide as jpep
from lam_slide_tpu_torch import convert
from lam_slide_tpu_torch.analysis import backbone as tbackbone
from lam_slide_tpu_torch.analysis import decorrelation as tdecor
from lam_slide_tpu_torch.analysis import eval_peptide as teval
from lam_slide_tpu_torch.analysis import features as tfeat
from lam_slide_tpu_torch.analysis import jsd as tjsd
from lam_slide_tpu_torch.analysis import msm as tmsm
from lam_slide_tpu_torch.analysis import tica as ttica
from lam_slide_tpu_torch.analysis.rollout import RolloutSampler as TRollout
from lam_slide_tpu_torch.composites.peptide import build_peptide_second_stage
from lam_slide_tpu_torch.data.peptide import PeptideDataset
from lam_slide_tpu_torch.experiments import registry as treg

POS_RTOL = 1e-4
ANGLE_ATOL = 1e-5
SUMMARY_ATOL = 1e-6
EULER = {"sampling_method": "euler", "num_steps": 10}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# DiT widths of the world: the smoke registry's, and a dh-128 one
WIDTHS = {"smoke": {}, "2x128": {"hidden_size": 256, "num_heads": 2}}


@pytest.fixture(scope="module", params=list(WIDTHS))
def world(request):
    """The port's smoke stage 1 and 2 (fp32) holding the JAX init's weights
    (the DiT's perturbed: the reference init zeroes its output layer), the
    JAX second stage on the same weights, and one test batch; the DiT at
    the smoke width or widened to 2 x dh 128."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LAM_SLIDE_NO_DATA_CACHE", "1")
        run1 = treg.peptide_first_stage(smoke=True, device="cpu")
        run2 = treg.peptide_second_stage(first_stage=run1, smoke=True, device="cpu")
    batch = next(iter(run2.test_loaders["test"]))
    cfg = dataclasses.replace(run2.config, **WIDTHS[request.param])
    jfs = jpep.build_peptide_first_stage(jpep.PeptideFirstStageConfig(
        **dataclasses.asdict(run1.config)))
    fs_vars = jax.tree.map(np.asarray, jax.jit(jfs.init)(
        jax.random.PRNGKey(0), {k: jnp.asarray(v[:, 0]) for k, v in batch.items()}))
    run1.model.load_state_dict(convert.first_stage_state_dict_from_jax(
        fs_vars["params"], fs_vars["constants"]))
    jcfg = jpep.PeptideSecondStageConfig(**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in dataclasses.asdict(cfg).items()})
    jss = jpep.build_peptide_second_stage(jcfg, jfs, fs_vars)
    x1, mk = jax.jit(jss.prepare_batch)(fs_vars, _jb(batch))
    params = jax.jit(jss.backbone.init)(jax.random.PRNGKey(1), x1, jnp.zeros((x1.shape[0],)),
                                        mk["x_cond"], mk["x_cond_mask"])["params"]
    rng = np.random.default_rng(11)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        params)
    ss = (run2.test_model if cfg == run2.config
          else build_peptide_second_stage(cfg, run1.model, device="cpu"))
    ss.backbone.load_state_dict(convert.latent_dit_state_dict_from_jax(params))
    return ss, jss, params, fs_vars, batch


def _window_noise(key, shape):
    """The noise JAX's sample fn draws from ``key``."""
    k_noise, _ = jax.random.split(key)
    return np.asarray(jax.random.normal(k_noise, shape, dtype=jnp.float32))


def test_one_euler_window_matches_jax(world):
    ss, jss, params, fs_vars, batch = world
    key = jax.random.PRNGKey(5)
    want = jax.jit(jss.make_sample_fn(sampling_kwargs=EULER))(params, fs_vars, _jb(batch), key)
    noise = torch.from_numpy(_window_noise(key, ss.prepare_batch(
        {k: torch.from_numpy(v) for k, v in batch.items()})[0].shape))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = ss.make_sample_fn(sampling_kwargs=EULER)(tb, noise=noise)
    assert set(got) == set(want)
    pos, wpos = got["atom14_pos"].numpy(), np.asarray(want["atom14_pos"])
    assert pos.shape == wpos.shape and np.isfinite(pos).all()
    assert np.abs(pos - wpos).max() <= POS_RTOL * np.abs(wpos).max()


def _replay_jax_noise(sampler, rng):
    """Feed ``sampler``'s windows the noise JAX's chain draws from ``rng``
    (one split a window, then the sample fn's own split)."""
    orig, state = sampler._sample, {"rng": rng}

    def sample(batch, generator=None):
        state["rng"], key = jax.random.split(state["rng"])
        shape = sampler.ss.prepare_batch(batch)[0].shape
        return orig(batch, noise=torch.from_numpy(_window_noise(key, shape)))

    sampler._sample = sample


@pytest.mark.parametrize("batched", [False, True])
def test_rollout_chain_matches_jax(world, batched):
    ss, jss, params, fs_vars, batch = world
    scale, shift = 2.0, 0.25
    jsampler = JRollout(jss, params, fs_vars, scale=scale, shift=shift, sampling_kwargs=EULER)
    tsampler = TRollout(ss, scale=scale, shift=shift, sampling_kwargs=EULER)
    _replay_jax_noise(tsampler, jax.random.PRNGKey(9))
    pos, res, mask = (batch[k][:, 0] for k in ("atom14_pos", "aatype", "atom14_mask"))
    pos = pos * scale + shift  # data units
    rng = jax.random.PRNGKey(9)
    if batched:
        want = jsampler.sample_rollout_batched(rng, jnp.asarray(pos), jnp.asarray(res),
                                               jnp.asarray(mask), num_rollouts=2)
        got = tsampler.sample_rollout_batched(torch.Generator(), pos, res, mask, num_rollouts=2)
    else:
        want = jsampler.sample_rollout(rng, jnp.asarray(pos[0]), jnp.asarray(res[0]),
                                       jnp.asarray(mask[0]), num_rollouts=2)
        got = tsampler.sample_rollout(torch.Generator(), pos[0], res[0], mask[0],
                                      num_rollouts=2)
    assert got.shape == want.shape and got.shape[-4] == 2 * ss.num_timesteps
    np.testing.assert_array_equal(got[..., 0, :, :, :] if batched else got[0],
                                  want[..., 0, :, :, :] if batched else want[0])
    assert np.abs(got - want).max() <= POS_RTOL * np.abs(want).max()

    jb = jsampler.create_batch(jnp.asarray(pos), jnp.asarray(res), jnp.asarray(mask))
    tb = tsampler.create_batch(torch.from_numpy(pos), torch.from_numpy(res),
                               torch.from_numpy(mask).float())
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)


@pytest.fixture(scope="module")
def trajectories():
    """Two synthetic reference trajectories (v2: metastable basins) and a
    perturbed copy of each as the "sampled" ensemble, in atom14."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LAM_SLIDE_NO_DATA_CACHE", "1")
        ds = PeptideDataset(first_stage=False, synthetic_peptides=2, synthetic_frames=400,
                            n_timesteps=16, synthetic_version=2)
    rng = np.random.default_rng(0)
    out = {}
    for t in ds.trajectories:
        ref = t["atom14_pos"]
        gen = (ref[::-1][:300] + 0.05 * rng.standard_normal(ref[:300].shape)
               * t["atom14_mask"][:300, ..., None]).astype(np.float32)
        out[t["name"]] = {"traj": gen, "ref": ref, "aatype": t["aatype"][0]}
    return out


def test_numpy_analysis_modules_equal_jax(trajectories):
    rng = np.random.default_rng(1)
    a, b = rng.uniform(-np.pi, np.pi, (2, 500, 3))
    names = ["PHI 1", "PSI 1", "CHI1 2"]
    assert tjsd.hist_jsd(a[:, 0], b[:, 0]) == jjsd.hist_jsd(a[:, 0], b[:, 0])
    assert tjsd.hist2d_jsd(a[:, :2], b[:, :2]) == jjsd.hist2d_jsd(a[:, :2], b[:, :2])
    assert tjsd.torsion_jsd(a, b, names) == jjsd.torsion_jsd(a, b, names)
    assert tjsd.tica_jsd(a[:, :2], b[:, :2]) == jjsd.tica_jsd(a[:, :2], b[:, :2])
    x = np.cumsum(rng.standard_normal((600, 4)), axis=0)
    tm, jm = ttica.tica(x, lag=5, kinetic_map=True), jtica.tica(x, lag=5, kinetic_map=True)
    np.testing.assert_array_equal(tm.transform(x), jm.transform(x))
    np.testing.assert_array_equal(tm.timescales, jm.timescales)
    ms_t = tmsm.estimate_msm(x[:, :2], n_clusters=20, n_metastable=3, lag=5, seed=3)
    ms_j = jmsm.estimate_msm(x[:, :2], n_clusters=20, n_metastable=3, lag=5, seed=3)
    np.testing.assert_array_equal(ms_t.transition, ms_j.transition)
    np.testing.assert_array_equal(ms_t.discretize(x[:, :2]), ms_j.discretize(x[:, :2]))
    np.testing.assert_array_equal(tdecor.torsion_decorrelation(a[:, 0], nlag=50),
                                  jdecor.torsion_decorrelation(a[:, 0], nlag=50))
    assert tdecor.effective_sample_size(x[:, 0]) == jdecor.effective_sample_size(x[:, 0])
    ca = next(iter(trajectories.values()))["ref"][:, :, 1]
    assert tbackbone.traj_analysis(ca[:100], ca[100:200]) == jbackbone.traj_analysis(
        ca[:100], ca[100:200])
    assert tbackbone.contact_rmse(ca[:50], ca[50:100]) == jbackbone.contact_rmse(ca[:50],
                                                                                 ca[50:100])


def test_features_match_jax(trajectories):
    for d in trajectories.values():
        tf, jf = tfeat.TorsionFeatures(d["aatype"]), jfeat.TorsionFeatures(d["aatype"])
        assert tf.describe() == jf.describe()
        np.testing.assert_allclose(tf(d["ref"][:100]), jf(d["ref"][:100]), atol=ANGLE_ATOL)
        np.testing.assert_allclose(tf(d["ref"][:100], cossin=True),
                                   jf(d["ref"][:100], cossin=True), atol=ANGLE_ATOL)
        np.testing.assert_allclose(tfeat.tica_feature_matrix(d["ref"][:100], d["aatype"]),
                                   jfeat.tica_feature_matrix(d["ref"][:100], d["aatype"]),
                                   atol=ANGLE_ATOL)


def test_evaluate_peptides_matches_jax(trajectories):
    cfg_t = teval.EvalConfig(tica_lag=20, msm_lag=20, n_clusters=20, decorr_nlag=20)
    cfg_j = jeval.EvalConfig(**dataclasses.asdict(cfg_t))
    per_t, summary_t = teval.evaluate_peptides(trajectories, cfg_t)
    per_j, summary_j = jeval.evaluate_peptides(trajectories, cfg_j)
    assert set(summary_t) == set(summary_j) == {"BB", "SC", "ALL", "TICA-0", "TICA-0,1", "MSMS"}
    for k in summary_j:
        assert np.isfinite(summary_t[k])
        assert abs(summary_t[k] - summary_j[k]) <= SUMMARY_ATOL, k
    for name in per_j:
        assert set(per_t[name]["JSD"]) == set(per_j[name]["JSD"])
