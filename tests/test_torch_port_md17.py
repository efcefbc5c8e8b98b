"""The port's MD17 sampling protocol against the JAX package, on the CPU.

Both stages at narrow widths with the MD17 structure (padded, masked
molecules; more than 8 latents, so the DiT's spatial axis takes the packed
attention path as at L=192, and a temporal axis of 8 < T < 128, where the
card takes K9), fp32 on both sides, weights drawn by the JAX init and
carried over with ``lam_slide_tpu_torch.convert``, inputs and noise from
numpy seeds. The JAX side runs the protocol's steps with the noise injected
(``make_sample_fn``'s body), since its own draw cannot be fed.

Tolerance: 1e-5 of the largest value, as tests/test_torch_port_sampler.py
holds an Euler-10 DiT solve (fp32 sums in another order, over ten steps and
two stages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_slide_tpu.composites import evaluation as jeval
from lam_slide_tpu.composites import md17 as jmd17
from lam_slide_tpu.composites import second_stage as jss
from lam_slide_tpu.transport import Sampler as JSampler
from lam_slide_tpu_torch import convert
from lam_slide_tpu_torch.composites import evaluation as teval
from lam_slide_tpu_torch.composites import md17 as tmd17
from lam_slide_tpu_torch.composites import second_stage as tss
from lam_slide_tpu_torch.composites.testing import evaluate_md17

REL_TOL = 1e-5
B, T, N_PAD, K = 2, 12, 12, 2
S1 = dict(n_atom_types=10, num_entities=N_PAD, dim_input=16, dim_latent=8, dim_entity=16,
          num_latents=10, dim_head_cross=4, dim_head_latent=4, num_head_cross=2,
          num_head_latent=2)
S2 = dict(depth=2, in_dim=8, hidden_size=32, num_heads=4, cond_idx=(0, 4),
          class_conditional=True, n_classes=8, vec_in_dim=32)
EULER = {"sampling_method": "euler", "num_steps": 10}


def _close(got, want, rel=REL_TOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max() + 1e-7


def _batch(seed=0):
    """An MD17 stage-2 batch (data/md17.py:174-244 layout): molecules of 5-12
    atoms padded to N_PAD, per-trajectory entity permutations, class ids."""
    rng = np.random.default_rng(seed)
    n_real = rng.integers(5, N_PAD + 1, size=B)
    atom_mask = np.arange(N_PAD)[None, :] < n_real[:, None]
    mask = np.broadcast_to(atom_mask[:, None], (B, T, N_PAD)).copy()
    pos = (rng.standard_normal((B, T, N_PAD, 3)) * mask[..., None]).astype(np.float32)
    atom = np.broadcast_to((rng.integers(0, 10, size=(B, N_PAD)) * atom_mask)[:, None],
                           (B, T, N_PAD)).copy()
    perms = np.stack([rng.permutation(N_PAD) for _ in range(B)]) * atom_mask
    entities = np.broadcast_to(perms[:, None], (B, T, N_PAD)).copy()
    return {"pos": pos, "atom": atom, "entities": entities, "attention_mask": mask,
            "cond_molecule": rng.integers(0, 8, size=B)}


@pytest.fixture(scope="module")
def stages():
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jfs = jmd17.build_md17_first_stage(jmd17.MD17FirstStageConfig(**S1))
    fs_vars = jax.tree.map(np.asarray, jfs.init(
        jax.random.PRNGKey(0), {k: v[:, 0] for k, v in jb.items() if k != "cond_molecule"}))
    jcfg = jmd17.MD17SecondStageConfig(**S2, num_timesteps=T, checkpointing=False)
    jsecond = jmd17.build_md17_second_stage(jcfg, jfs, fs_vars)
    x1, mk = jsecond.prepare_batch(fs_vars, jb)
    params = jax.tree.map(np.asarray, jsecond.backbone.init(
        jax.random.PRNGKey(1), x1, jnp.zeros((B,)), mk["x_cond"], mk["x_cond_mask"],
        mk["y_class"])["params"])

    tfs = tmd17.build_md17_first_stage(tmd17.MD17FirstStageConfig(**S1), device="cpu").eval()
    tfs.load_state_dict(convert.first_stage_state_dict_from_jax(fs_vars["params"],
                                                                fs_vars["constants"]))
    tsecond = tmd17.build_md17_second_stage(tmd17.MD17SecondStageConfig(**S2), tfs,
                                            device="cpu")
    tsecond.backbone.load_state_dict(convert.class_cond_dit_state_dict_from_jax(params))
    return batch, (jsecond, fs_vars, params), tsecond


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.mark.parametrize("mask_cond_mean", [True, False])
def test_setup_conditioning_matches_jax(mask_cond_mean):
    lat = np.random.default_rng(1).standard_normal((B, T, 5, 3)).astype(np.float32)
    want = jss.setup_conditioning(jnp.asarray(lat), (2, 6), mask_cond_mean)
    got = tss.setup_conditioning(torch.from_numpy(lat), (2, 6), mask_cond_mean)
    _close(got[0], want[0], rel=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_prepare_batch_matches_jax(stages):
    batch, (jsecond, fs_vars, _), tsecond = stages
    x1, mk = jsecond.prepare_batch(fs_vars, {k: jnp.asarray(v) for k, v in batch.items()})
    tx1, tmk = tsecond.prepare_batch(_torch_batch(batch))
    _close(tx1, x1)
    _close(tmk["x_cond"], mk["x_cond"])
    np.testing.assert_array_equal(tmk["x_cond_mask"].numpy(), np.asarray(mk["x_cond_mask"]))
    np.testing.assert_array_equal(tmk["y_class"].numpy(), np.asarray(mk["y_class"]))


def test_class_cond_dit_matches_jax(stages):
    batch, (jsecond, fs_vars, params), tsecond = stages
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, T, S1["num_latents"], 8)).astype(np.float32)
    t = np.array([0.2, 0.7], np.float32)
    x1, mk = jsecond.prepare_batch(fs_vars, {k: jnp.asarray(v) for k, v in batch.items()})
    want = jsecond.backbone.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), **mk)
    tmk = {k: torch.from_numpy(np.array(v)) for k, v in mk.items()}
    with torch.no_grad():
        got = tsecond.backbone(torch.from_numpy(x), torch.from_numpy(t), **tmk)
    _close(got, want)


def test_k_sample_and_ade_fde_match_jax(stages):
    """The protocol's steps at K=2, Euler-10: zero the target frames, encode,
    sample each repeat from the same noise, decode every frame, mean-over-K
    ADE/FDE over the target frames."""
    batch, (jsecond, fs_vars, params), tsecond = stages
    cond_end = S2["cond_idx"][1]
    noise = np.random.default_rng(3).standard_normal(
        (K, B, T, S1["num_latents"], S1["dim_latent"])).astype(np.float32)

    jb = jeval.zero_target_frames({k: jnp.asarray(v) for k, v in batch.items()}, cond_end)
    x1, mk = jsecond.prepare_batch(fs_vars, jb)
    solve = JSampler(jsecond.transport).get_sample_fn("ODE", EULER)
    want_pos = []
    for kk in range(K):
        lat = solve(None, jnp.asarray(noise[kk]), jsecond.model_fn(params), **mk)
        dec = jsecond.decode(fs_vars, lat.reshape(B * T, *lat.shape[2:]),
                             jb["entities"].reshape(B * T, -1))
        want_pos.append(dec["pos"].reshape(B, T, *dec["pos"].shape[1:]))
    want_pos = jnp.stack(want_pos)

    tb = teval.zero_target_frames(_torch_batch(batch), cond_end)
    np.testing.assert_array_equal(tb["pos"].numpy(), np.asarray(jb["pos"]))
    preds = tsecond.make_k_sample_fn(K, sampling_kwargs=EULER)(tb, noise=torch.from_numpy(noise))
    _close(preds["pos"], want_pos)
    chunked = tsecond.make_k_sample_fn(K, k_chunk=1, sampling_kwargs=EULER)(
        tb, noise=torch.from_numpy(noise))
    _close(chunked["pos"], want_pos)

    true_pos, mask = batch["pos"][:, cond_end:], batch["attention_mask"][:, cond_end:]
    want = jeval.mean_over_k_ade_fde(want_pos[:, :, cond_end:], jnp.asarray(true_pos),
                                     jnp.asarray(mask))
    got = teval.mean_over_k_ade_fde(preds["pos"][:, :, cond_end:], torch.from_numpy(true_pos),
                                    torch.from_numpy(mask))
    for a, w in zip(got, want):
        _close(a, w)


def test_masked_ade_fde_matches_jax():
    rng = np.random.default_rng(4)
    pred, true = (rng.standard_normal((3, 5, 7, 3)).astype(np.float32) for _ in range(2))
    pred[0, 1, 2] = true[0, 1, 2]  # a zero error: safe_norm's branch
    mask = rng.random((3, 5, 7)) > 0.3
    for m in (mask, None):
        want = jeval.masked_ade_fde(jnp.asarray(pred), jnp.asarray(true),
                                    None if m is None else jnp.asarray(m))
        got = teval.masked_ade_fde(torch.from_numpy(pred), torch.from_numpy(true),
                                   None if m is None else torch.from_numpy(m))
        for a, w in zip(got, want):
            _close(a, w)


def test_evaluate_md17_runs_the_protocol(stages):
    """evaluate_md17 end to end on two batches of one molecule: finite
    ADE/FDE, scaled, and the same metrics for the same generator seed."""
    batch, _, tsecond = stages
    run = lambda: evaluate_md17(tsecond, {"aspirin": [batch, _batch(5)]}, scale=2.0, k=K,
                                generator=torch.Generator().manual_seed(0))
    out = run()
    assert set(out) == {"test/aspirin/ade", "test/aspirin/fde"}
    assert all(np.isfinite(v) and v > 0 for v in out.values())
    assert out == run()
