"""The port's training path against the JAX package, on the CPU.

* ``nn/losses.py`` function by function, the schedules and ``ema_update``;
* ``Transport.training_losses`` for every path, model type and weighting,
  fed the t and x0 that JAX drew;
* one train step of a small DiT at both head splits (dh 24, and 1 head x
  dh 128 with the JAX kernels engaged): loss, grad norm, every parameter's
  grad, the updated parameters and EMA, mapped through ``convert.py``;
* ten steps of the AdamW/clip/EMA trajectory, then the eval step on the EMA
  weights; and ``grad_accum`` against the whole batch.

Inputs are made with numpy from a seed; fp32 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import lam_slide_tpu.ops.attention as jattn
from lam_slide_tpu.models import LatentDiT as JLatentDiT
from lam_slide_tpu.nn import ema as jema
from lam_slide_tpu.nn import losses as jlosses
from lam_slide_tpu.nn import schedules as jsched
from lam_slide_tpu.ops import fused_adaln as jad
from lam_slide_tpu.ops import fused_mlp as jfm
from lam_slide_tpu.ops import fused_spatial_block as jsb
from lam_slide_tpu.train.state import create_train_state as j_create_train_state
from lam_slide_tpu.train.steps import make_eval_step as j_make_eval_step
from lam_slide_tpu.train.steps import make_train_step as j_make_train_step
from lam_slide_tpu.train.trainer import TrainerConfig as JTrainerConfig
from lam_slide_tpu.train.trainer import make_optimizer as j_make_optimizer
from lam_slide_tpu.transport import create_transport as j_create_transport
from lam_slide_tpu_torch.convert import latent_dit_state_dict_from_jax
from lam_slide_tpu_torch.models import LatentDiT
from lam_slide_tpu_torch.nn import ema as tema
from lam_slide_tpu_torch.nn import losses as tlosses
from lam_slide_tpu_torch.nn import schedules as tsched
from lam_slide_tpu_torch.train import create_train_state, make_eval_step, make_train_step
from lam_slide_tpu_torch.train.state import param_count
from lam_slide_tpu_torch.train.trainer import TrainerConfig, make_optimizer
from lam_slide_tpu_torch.transport import create_transport


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------- losses

def _loss_inputs():
    rng = np.random.default_rng(0)
    pred, target = (rng.standard_normal((3, 7, 4)).astype(np.float32) for _ in range(2))
    pred[0, 1] = target[0, 1]  # a zero difference: safe_norm's zero branch
    mask = (rng.uniform(size=(3, 7)) > 0.3).astype(np.float32)
    logits = rng.standard_normal((3, 7, 5)).astype(np.float32)
    labels = rng.integers(0, 5, size=(3, 7)).astype(np.int32)
    adj = (rng.uniform(size=(3, 7, 7)) > 0.5).astype(np.float32)
    traj_p, traj_t = (rng.standard_normal((2, 6, 5, 3)).astype(np.float32) for _ in range(2))
    traj_mask = (rng.uniform(size=(2, 6, 5)) > 0.2).astype(np.float32)
    return dict(pred=pred, target=target, mask=mask, logits=logits, labels=labels, adj=adj,
                traj_p=traj_p, traj_t=traj_t, traj_mask=traj_mask)


# name -> (argument keys, keyword arguments)
LOSSES = {
    "masked_mse": (("pred", "target", "mask"), {}),
    "masked_l1": (("pred", "target", "mask"), {}),
    "masked_huber": (("pred", "target", "mask"), {"delta": 0.5}),
    "masked_norm": (("pred", "target", "mask"), {}),
    "masked_cross_entropy": (("logits", "labels", "mask"), {"label_smoothing": 0.1}),
    "masked_cosine": (("pred", "target", "mask"), {}),
    "masked_cosine_v2": (("pred", "target", "mask"), {}),
    "masked_cosine_v3": (("pred", "target", "mask"), {}),
    "cdist": (("pred", "target"), {}),
    "inter_distance": (("pred", "target", "mask"), {}),
    "inter_distance_huber": (("pred", "target", "mask"), {"delta": 0.5}),
    "inter_distance_relative": (("pred", "target", "mask"), {}),
    "similarity": (("pred", "mask"), {"sigma": 0.5}),
    "inter_distance_signed": (("pred", "target", "mask"), {}),
    "inter_distance_adjacent": (("pred", "target", "adj"), {}),
    "mean_flat": (("pred",), {}),
    "cross_entropy": (("logits", "labels"), {}),
    "ade_fde": (("traj_p", "traj_t", "traj_mask"), {}),
    "ade_fde_unmasked": (("traj_p", "traj_t"), {}),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_jax(name):
    keys, kwargs = LOSSES[name]
    inputs = _loss_inputs()
    fn = name.replace("_unmasked", "")
    want = getattr(jlosses, fn)(*(jnp.asarray(inputs[k]) for k in keys), **kwargs)
    got = getattr(tlosses, fn)(*(torch.from_numpy(inputs[k]) for k in keys), **kwargs)
    want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        # fp32 on both sides; sums in another order
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-5, rtol=1e-5)


def test_safe_norm_grad_is_zero_at_the_origin():
    x = torch.zeros(2, 3, requires_grad=True)
    tlosses.safe_norm(x).sum().backward()
    assert torch.equal(x.grad, torch.zeros(2, 3))


# ---------------------------------------------------------------- schedules, EMA

SCHEDULES = [
    ("linear_warmup_cosine", (1e-3, 2, 5, 4, 1e-7)),
    ("linear_warmup_cosine", (1e-3, 0, 3, 7, 0.0)),
    ("warmup_cosine_per_epoch", (5e-4, 1, 4, 3, 1e-6)),
]


@pytest.mark.parametrize("name,args", SCHEDULES)
def test_schedule_matches_jax(name, args):
    want, got = getattr(jsched, name)(*args), getattr(tsched, name)(*args)
    steps = range(0, args[2] * args[3] + 3)
    # JAX evaluates in fp32, the port in Python floats: fp32 rounding of
    # 1 + cos near the end of the cosine, where it cancels, grows to ~1e-6
    np.testing.assert_allclose([got(s) for s in steps], [float(want(s)) for s in steps],
                               rtol=1e-5, atol=1e-12)


def test_ema_update_matches_jax():
    rng = np.random.default_rng(1)
    ema = {"a": rng.standard_normal((3, 4)).astype(np.float32),
           "b": rng.standard_normal(5).astype(np.float32)}
    params = {k: v + rng.standard_normal(v.shape).astype(np.float32) for k, v in ema.items()}
    want = jema.ema_update(jax.tree.map(jnp.asarray, ema), jax.tree.map(jnp.asarray, params),
                           0.999)
    got = tema.ema_update({k: torch.from_numpy(v.copy()) for k, v in ema.items()},
                          {k: torch.from_numpy(v) for k, v in params.items()}, 0.999)
    for k in ema:  # the same fp32 formula on both sides
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), atol=1e-7, rtol=1e-7)


# ---------------------------------------------------------------- training losses

TRANSPORTS = [(path, pred, weight) for path in ("Linear", "GVP", "VP")
              for pred in ("velocity", "noise", "score", "data")
              for weight in (None, "velocity", "likelihood")]


@pytest.mark.parametrize("path,prediction,weight", TRANSPORTS)
def test_training_losses_match_jax(path, prediction, weight):
    x1 = np.random.default_rng(2).standard_normal((4, 5, 3)).astype(np.float32)
    jtr = j_create_transport(path_type=path, prediction=prediction, loss_weight=weight)
    ttr = create_transport(path_type=path, prediction=prediction, loss_weight=weight)
    key = jax.random.PRNGKey(3)
    want = jtr.training_losses(key, lambda x, t: jnp.tanh(x) * (1 + t[:, None, None]),
                               jnp.asarray(x1))
    t, x0, _ = jtr.sample(key, jnp.asarray(x1))
    got = ttr.training_losses(lambda x, t: torch.tanh(x) * (1 + t[:, None, None]),
                              torch.from_numpy(x1), t=torch.from_numpy(np.array(t)),
                              x0=torch.from_numpy(np.array(x0)))
    for k in ("loss", "pred"):
        assert got[k].shape == want[k].shape
        # fp32; the VP path's sigma_t near t1 makes the weights large, so relative
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=2e-5, atol=1e-6)


def test_sample_draws_from_the_generator():
    tr = create_transport(path_type="GVP", prediction="noise")
    x1 = torch.zeros(1000, 3)
    t, x0, _ = tr.sample(x1, torch.Generator().manual_seed(0))
    t0, t1 = tr.check_interval(tr.train_eps, tr.sample_eps)
    assert t.shape == (1000,) and bool(((t >= t0) & (t <= t1)).all())
    assert x0.shape == x1.shape and abs(x0.std().item() - 1) < 0.05
    again, _, _ = tr.sample(x1, torch.Generator().manual_seed(0))
    assert torch.equal(t, again)


# ---------------------------------------------------------------- train step

# Small DiTs: T exceeds packed_threshold=8, so the temporal axis takes the
# flash (dh 24) or QKNorm + RoPE flash (dh 128) path.
SPLITS = {
    "dh24": dict(depth=2, in_dim=6, hidden_size=48, num_heads=2, mlp_ratio=2),
    "dh128": dict(depth=2, in_dim=6, hidden_size=128, num_heads=1, mlp_ratio=2),
}
B, T, L = 2, 12, 2
# One fp32 step: grads, the loss and the grad norm differ only in the order
# of fp32 sums through two layers.
GRAD_TOL = 1e-4


def _batch():
    rng = np.random.default_rng(4)
    x1 = rng.standard_normal((B, T, L, 6)).astype(np.float32)
    mask = np.zeros((B, T, L), np.int32)
    mask[:, :3] = 1
    return {"x1": x1, "x_cond": x1 * mask[..., None], "mask": mask}


@pytest.fixture
def jax_kernels(monkeypatch):
    monkeypatch.setattr(jattn, "FORCE_BACKEND", "pallas")
    monkeypatch.setenv("LAM_SLIDE_KERNEL_NORMROPE", "1")
    for mod in (jad, jsb, jfm):
        monkeypatch.setattr(mod, "FORCE_KERNEL", True)


def _jax_side(cfg, batch):
    jmodel = JLatentDiT(**cfg, reference_init=False)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(batch["x1"]),
                                  jnp.zeros((B,)), jnp.asarray(batch["x_cond"]),
                                  jnp.asarray(batch["mask"]))["params"]
    jtr = j_create_transport(path_type="GVP", prediction="data")

    def loss_fn(p, constants, b, rng, train):
        out = jtr.training_losses(
            rng, lambda xt, tt, **kw: jmodel.apply({"params": p}, xt, tt, **kw), b["x1"],
            model_kwargs={"x_cond": b["x_cond"], "x_cond_mask": b["mask"]})
        loss = out["loss"].mean()
        return loss, {"si_loss": loss}

    return jtr, params, loss_fn


def _port_loss(model, batch, generator, train):
    out = create_transport(path_type="GVP", prediction="data").training_losses(
        model, batch["x1"], {"x_cond": batch["x_cond"], "x_cond_mask": batch["mask"]},
        generator=generator, t=batch.get("t"), x0=batch.get("x0"))
    loss = out["loss"].mean()
    return loss, {"si_loss": loss}


def _port_batch(batch, jtr, key, x1):
    """The port's batch with the t and x0 JAX draws from ``key``."""
    t, x0, _ = jtr.sample(key, x1)
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    return {**out, "t": torch.from_numpy(np.array(t)), "x0": torch.from_numpy(np.array(x0))}


def _port_model(cfg, params):
    model = LatentDiT(**cfg, reference_init=False, device="cpu")
    model.load_state_dict(latent_dit_state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return model


def _sd(tree):
    return latent_dit_state_dict_from_jax(jax.tree.map(np.asarray, tree))


def _assert_grads_close(model, jgrads):
    want = _sd(jgrads)
    for name, p in model.named_parameters():
        scale = max(np.abs(want[name].numpy()).max(), 1e-30)
        err = np.abs(_np(p.grad) - want[name].numpy()).max()
        assert err <= GRAD_TOL * scale, f"grad {name}: max err {err} > {GRAD_TOL} x {scale}"
        assert scale > 0, f"grad {name} is zero: a vacuous match"


def _assert_moved_alike(start, got, want, tol):
    """Per tensor, what the updates moved agrees in norm: Adam's normalized
    update is lr-sized wherever a grad is nonzero, so a grad element that is
    fp32 noise in one framework and the other can move either way by up to
    lr per step; the norm of the difference stays a small share."""
    for name, p in got.items():
        moved = want[name] - start[name]
        assert moved.norm() > 0, name
        err = (p.detach() - want[name]).norm()
        assert err <= tol * moved.norm(), f"{name}: {err} > {tol} x {moved.norm()}"


@pytest.mark.parametrize("split", sorted(SPLITS))
def test_one_train_step_matches_jax(jax_kernels, split):
    """The port's step against the body of JAX's step (steps.py:96-106) on
    the same grads: the optax AdamW + clip update, the EMA and the metrics."""
    cfg, batch = SPLITS[split], _batch()
    jtr, params, j_loss = _jax_side(cfg, batch)
    jcfg, tcfg = (C(lr=1e-3, grad_clip=0.5, warmup_epochs=1, max_epochs=2)
                  for C in (JTrainerConfig, TrainerConfig))
    jtx, _ = j_make_optimizer(jcfg, 3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    step_key = jax.random.fold_in(jax.random.PRNGKey(5), jnp.int32(0))  # step 0's key
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: j_loss(p, None, jbatch, step_key, True)[0]))(params)
    updates, _ = jtx.update(jgrads, jtx.init(params), params)
    jparams = optax.apply_updates(params, updates)
    jema_params = jema.ema_update(params, jparams, 0.999)

    model = _port_model(cfg, params)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    tbatch = _port_batch(batch, jtr, step_key, jbatch["x1"])
    _port_loss(model, tbatch, None, True)[0].backward()
    _assert_grads_close(model, jgrads)
    model.zero_grad(set_to_none=True)

    ttx, _ = make_optimizer(tcfg, 3)
    state = create_train_state(model, ttx)
    state, metrics = make_train_step(_port_loss, ttx)(state, tbatch, 0)
    assert state.step == 1
    assert param_count(state.params) == sum(p.size for p in jax.tree.leaves(params))
    np.testing.assert_allclose(_np(metrics["loss"]), np.asarray(jloss), rtol=GRAD_TOL)
    np.testing.assert_allclose(_np(metrics["grad_norm"]), np.asarray(optax.global_norm(jgrads)),
                               rtol=GRAD_TOL)
    assert float(metrics["grad_norm"]) > 0.5  # the clip at 0.5 is engaged
    _assert_moved_alike(start, dict(model.named_parameters()), _sd(jparams), 1e-2)
    _assert_moved_alike(start, state.ema_params, _sd(jema_params), 1e-2)


def test_ten_steps_and_eval_match_jax():
    """Ten steps with a warmup-cosine schedule, the clip at 0.5 and EMA
    0.999 on one fixed batch (each step draws its own t and x0), then the
    eval step on the EMA weights."""
    cfg, batch = SPLITS["dh24"], _batch()
    jtr, params, j_loss = _jax_side(cfg, batch)
    jtx, _ = j_make_optimizer(JTrainerConfig(lr=1e-3, grad_clip=0.5, warmup_epochs=1,
                                             max_epochs=3), 4)
    jstate = j_create_train_state({"params": params}, jtx)
    jstep = j_make_train_step(j_loss, jtx, donate_state=False)
    ttx, _ = make_optimizer(TrainerConfig(lr=1e-3, grad_clip=0.5, warmup_epochs=1,
                                          max_epochs=3), 4)
    model = _port_model(cfg, params)
    state = create_train_state(model, ttx)
    step = make_train_step(_port_loss, ttx)
    key = jax.random.PRNGKey(6)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    for i in range(10):
        jstate, jm = jstep(jstate, jbatch, key)
        tbatch = _port_batch(batch, jtr, jax.random.fold_in(key, jnp.int32(i)), jbatch["x1"])
        state, tm = step(state, tbatch, 0)
        # the loss of step i is taken before step i's update
        np.testing.assert_allclose(_np(tm["loss"]), np.asarray(jm["loss"]), rtol=1e-4)
    _assert_moved_alike(start, dict(model.named_parameters()), _sd(jstate.params), 2e-2)
    _assert_moved_alike(start, state.ema_params, _sd(jstate.ema_params), 2e-2)
    eval_key = jax.random.PRNGKey(7)
    jm = j_make_eval_step(j_loss)(jstate, jbatch, eval_key)
    tm = make_eval_step(_port_loss)(state, _port_batch(batch, jtr, eval_key, jbatch["x1"]), 0)
    np.testing.assert_allclose(_np(tm["loss"]), np.asarray(jm["loss"]), rtol=1e-4)


def test_grad_accum_matches_the_whole_batch():
    """Two microbatches of one row each give the whole batch's averaged
    loss and grads, hence the same update (equal microbatch sizes)."""
    cfg, batch = SPLITS["dh24"], _batch()
    jtr, params, _ = _jax_side(cfg, batch)
    tbatch = _port_batch(batch, jtr, jax.random.PRNGKey(8), jnp.asarray(batch["x1"]))
    results = []
    for accum in (1, 2):
        tx, _ = make_optimizer(TrainerConfig(lr=1e-3, grad_clip=0.5), 1)
        state = create_train_state(_port_model(cfg, params), tx)
        state, metrics = make_train_step(_port_loss, tx, grad_accum=accum)(state, tbatch, 0)
        results.append((metrics, dict(state.model.named_parameters())))
    (m1, p1), (m2, p2) = results
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(_np(m2[k]), _np(m1[k]), rtol=1e-5)
    _assert_moved_alike(_sd(params), p2, {k: v.detach() for k, v in p1.items()}, 1e-3)


def test_checkpointing_gives_the_same_loss_and_grads():
    """``checkpointing=True`` recomputes each layer in the backward
    (``nn.remat`` in JAX): the same loss and grads, to the last bit on the
    CPU, where the recompute repeats the same operations."""
    cfg, batch = SPLITS["dh24"], _batch()
    jtr, params, _ = _jax_side(cfg, batch)
    tbatch = _port_batch(batch, jtr, jax.random.PRNGKey(9), jnp.asarray(batch["x1"]))
    results = []
    for checkpointing in (False, True):
        model = _port_model(cfg, params)
        model.checkpointing = checkpointing
        loss, _ = _port_loss(model, tbatch, None, True)
        loss.backward()
        results.append((loss.detach(), {n: p.grad for n, p in model.named_parameters()}))
    (loss0, g0), (loss1, g1) = results
    assert torch.equal(loss1, loss0)
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], atol=0, rtol=0)
