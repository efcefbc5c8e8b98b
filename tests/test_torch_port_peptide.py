"""The port's 4AA peptide composite (``composites/peptide.py``) against the JAX
package's, on the CPU.

Both stages at the JAX registry's smoke widths (registry.py:581-583,
681-684), the port's models built by its registry and loaded with the JAX
init's weights through ``lam_slide_tpu_torch.convert``, batches from the
port's loaders (``tests/test_torch_port_peptide_data.py`` holds the data to
JAX's), fp32 on both sides, so only the order of fp32 sums differs:

* ``PeptideInputEmbedder``, the ``DecoderQuerySplitter`` decode and the whole
  ``build_peptide_first_stage`` forward within 1e-5 of the largest output;
  ``make_peptide_first_stage_loss`` in deterministic mode: the total and
  every metric within 1e-5 relative, every grad within 1e-4 of its largest
  element (fp32 sums in another order through the geometry's backward);
* the trained reference checkpoint ``tests/golden/ref_trained_probe.ckpt``
  loaded straight into the port's smoke-width stage 1 (``load_state_dict``,
  strict) reproduces the golden raw and EMA outputs within the JAX test's
  limits (tests/test_torch_import.py:511-513: positions 3e-5 x max |pos|,
  aatype logits 3e-4);
* ``make_peptide_second_stage_loss`` fed the t and x0 JAX draws: the SI loss
  and every aux part within 1e-5 relative, every DiT grad within 1e-4 of its
  largest element, the frozen first stage without a grad.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_slide_tpu.composites import peptide as jpep
from lam_slide_tpu_torch import convert
from lam_slide_tpu_torch.composites import peptide as tpep
from lam_slide_tpu_torch.data.loader import device_batch
from lam_slide_tpu_torch.experiments import registry as treg

LOSS_RTOL = 1e-5
OUT_TOL = 1e-5
GRAD_TOL = 1e-4
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(autouse=True)
def no_data_cache(monkeypatch):
    monkeypatch.setenv("LAM_SLIDE_NO_DATA_CACHE", "1")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel_close(got, want, rtol=LOSS_RTOL, name=""):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, name
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-30), name


def _assert_grads_close(named_params, want_sd):
    for name, p in named_params:
        want = want_sd[name].numpy()
        scale = np.abs(want).max()
        assert scale > 0, f"grad {name} is zero: a vacuous match"
        err = np.abs(_np(p.grad) - want).max()
        assert err <= GRAD_TOL * scale, f"grad {name}: max err {err} > {GRAD_TOL} x {scale}"


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _fs_sd(tree, constants):
    return convert.first_stage_state_dict_from_jax(jax.tree.map(np.asarray, tree), constants)


@pytest.fixture(scope="module")
def stage1():
    """The port's smoke stage-1 run and its first batch, the JAX model, config
    and init variables; the port model holds the JAX weights."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LAM_SLIDE_NO_DATA_CACHE", "1")
        run = treg.peptide_first_stage(smoke=True, device="cpu")
    batch = next(iter(run.train_loader))
    jcfg = jpep.PeptideFirstStageConfig(**dataclasses.asdict(run.config))
    jmodel = jpep.build_peptide_first_stage(jcfg)
    variables = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0), _jb(batch)))
    run.model.load_state_dict(_fs_sd(variables["params"], variables["constants"]))
    return run, batch, jmodel, jcfg, variables


def test_stage1_modules_match_jax(stage1):
    run, batch, jmodel, _, variables = stage1
    tb = device_batch(batch, "cpu")
    with torch.no_grad():
        emb = run.model._embed_inputs(tb)
        z = run.model.encode(tb)
        dec = run.model.decode(z, tb["entities"])
        full = run.model(tb)
    jemb = jmodel.apply(variables, _jb(batch), method=lambda m, b: m.input_embedder(b))
    jz = jmodel.apply(variables, _jb(batch), method=jmodel.encode)
    jdec = jmodel.apply(variables, jnp.asarray(z.numpy()), _jb(batch)["entities"],
                        method=jmodel.decode)
    jfull = jmodel.apply(variables, _jb(batch), deterministic=True)
    _rel_close(emb, jemb, OUT_TOL, "embedder")
    _rel_close(z, jz, OUT_TOL, "encode")
    assert set(dec) == set(jdec) == {"atom14_pos", "aatype"}
    for k in dec:
        _rel_close(dec[k], jdec[k], OUT_TOL, f"decode {k}")
        _rel_close(full[k], jfull[k], OUT_TOL, f"forward {k}")
    # the splitter widens the 2 latents to 2 * num_split tokens, d-major
    assert run.model.decoder.extender[1].weight.shape == (16 * 4, 16, 1)


def test_stage1_loss_and_grads_match_jax(stage1):
    run, batch, jmodel, jcfg, variables = stage1
    jloss = jpep.make_peptide_first_stage_loss(jmodel, jcfg)
    (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jloss(p, variables["constants"], _jb(batch), jax.random.PRNGKey(1), False),
        has_aux=True))(variables["params"])
    run.model.zero_grad(set_to_none=True)
    total, metrics = run.loss_fn(run.model, device_batch(batch, "cpu"), None, False)
    total.backward()
    _rel_close(total, jtotal, name="total")
    assert set(metrics) == set(jmetrics)
    for k, v in metrics.items():
        _rel_close(v, jmetrics[k], name=k)
    _assert_grads_close(run.model.named_parameters(), _fs_sd(jgrads, variables["constants"]))


@pytest.mark.parametrize("which", ["raw", "ema"])
def test_trained_reference_checkpoint_golden(which):
    """The genuinely trained reference checkpoint (60 AdamW steps of the
    reference's own modules) loads into the port's stage 1 by its reference
    keys, strictly, and reproduces the reference forward of both weights."""
    ckpt = torch.load(os.path.join(GOLDEN, "ref_trained_probe.ckpt"), weights_only=True)
    gd = np.load(os.path.join(GOLDEN, "ref_trained_probe_golden.npz"))
    sd = ckpt["state_dict"] if which == "raw" else ckpt["ema"]["params"]
    model = tpep.build_peptide_first_stage(treg._smoke_peptide_first_stage_config(),
                                           device="cpu")
    model.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()}, strict=True)
    batch = {k[len("batch_"):]: torch.from_numpy(gd[k]) for k in gd.files
             if k.startswith("batch_")}
    with torch.no_grad():
        preds = model(batch)
    pos_ref = gd[f"{which}_atom14_pos"]
    pos = preds["atom14_pos"].numpy().reshape(pos_ref.shape)
    assert np.max(np.abs(pos - pos_ref)) < 3e-5 * np.abs(pos_ref).max()
    assert np.max(np.abs(preds["aatype"].numpy() - gd[f"{which}_aatype"])) < 3e-4


@pytest.fixture(scope="module")
def stage2(stage1):
    """The port's smoke stage-2 run on the port first stage with the JAX
    weights, its first batch, and the JAX second stage with its init."""
    run1, _, jfs, _, fs_vars = stage1
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LAM_SLIDE_NO_DATA_CACHE", "1")
        run2 = treg.peptide_second_stage(first_stage=run1, smoke=True, device="cpu")
    batch = next(iter(run2.train_loader))
    jcfg = jpep.PeptideSecondStageConfig(**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in dataclasses.asdict(run2.config).items()})
    jss = jpep.build_peptide_second_stage(jcfg, jfs, fs_vars)
    x1, mk = jax.jit(jss.prepare_batch)(fs_vars, _jb(batch))
    params = jax.tree.map(np.asarray, jax.jit(jss.backbone.init)(
        jax.random.PRNGKey(1), x1, jnp.zeros((x1.shape[0],)), mk["x_cond"],
        mk["x_cond_mask"])["params"])
    # the reference init zeroes the modulations and the output layer, which
    # leaves most grads zero: both sides take the same perturbed weights
    rng = np.random.default_rng(5)
    params = jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), params)
    run2.model.load_state_dict(convert.latent_dit_state_dict_from_jax(params))
    return run2, batch, jss, jcfg, fs_vars, params


def test_stage2_loss_with_aux_losses_and_grads_match_jax(stage2, monkeypatch):
    run2, batch, jss, jcfg, fs_vars, params = stage2
    key = jax.random.PRNGKey(3)
    jloss = jpep.make_peptide_second_stage_loss(jss, jcfg)
    (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jloss(p, {"first_stage": fs_vars}, _jb(batch), key, True),
        has_aux=True))(params)
    x1, _ = jax.jit(jss.prepare_batch)(fs_vars, _jb(batch))
    t, x0, _ = jss.transport.sample(key, x1)
    t, x0 = torch.from_numpy(np.array(t)), torch.from_numpy(np.array(x0))
    monkeypatch.setattr(type(run2.second_stage.transport), "sample",
                        lambda self, x1, generator: (t, x0, x1))
    run2.model.zero_grad(set_to_none=True)
    run2.second_stage.first_stage.zero_grad(set_to_none=True)  # stage 1's own tests' grads
    total, metrics = run2.loss_fn(run2.model, device_batch(batch, "cpu"), None, True)
    total.backward()
    _rel_close(total, jtotal, name="total")
    assert set(metrics) == set(jmetrics) == {"si_loss", "pos_loss", "pos_frame_loss",
                                             "inter_distance_loss", "norm_loss",
                                             "torsion_loss"}
    for k, v in metrics.items():
        _rel_close(v, jmetrics[k], name=k)
    _assert_grads_close(run2.model.named_parameters(),
                        convert.latent_dit_state_dict_from_jax(jax.tree.map(np.asarray, jgrads)))
    assert all(p.grad is None and not p.requires_grad
               for p in run2.second_stage.first_stage.parameters())


def test_stage2_bundle_matches_jax_config(stage2):
    """The second stage's conditioning, window and frame keys, and the fp32
    test model beside a training DiT of the registry's dtype."""
    run2, _, jss, _, _, _ = stage2
    ss = run2.second_stage
    assert ss.cond_idx == jss.cond_idx == (0, 1)
    assert ss.num_timesteps == jss.num_timesteps == 16
    assert ss.frame_keys == jss.frame_keys
    assert run2.test_model.backbone.dtype == torch.float32
    assert run2.meta["domain"] == "peptide" and run2.meta["stage"] == 2
