"""The port's MD17 training path against the JAX package, on the CPU.

Both stages at the JAX registry's smoke widths (registry.py:166-168,
256-258), the port's models built by its registry and loaded with the JAX
init's weights through ``lam_slide_tpu_torch.convert``, batches from the
port's loaders (``tests/test_torch_port_data.py`` holds those to the JAX
loaders bit for bit), fp32 on both sides:

* ``make_md17_first_stage_loss`` in deterministic mode: the total and every
  metric within 1e-5 relative, every grad against ``jax.grad`` within 1e-4
  of its largest element (fp32 sums in another order through two blocks);
* ``SecondStage.make_loss`` with the aux losses through the frozen first
  stage, fed the t and x0 that JAX draws: the loss and metrics within 1e-5
  relative, every DiT grad within 1e-4 of its largest element;
* ``make_protocol_val_hook`` on a state whose EMA weights differ from its
  weights, fed the noise JAX's hook is fed: ADE/FDE within 1e-5 relative;
* one ``make_train_step`` per stage against JAX's (stage 1 with its dropout
  set to 0, since torch and JAX draw different masks): loss and grad norm
  within 1e-4 relative, and what the update moved within 1e-2 of its norm
  per tensor (Adam normalizes fp32-noise-sized grads to lr-sized steps, as
  tests/test_torch_port_train.py explains);
* the dropout helpers: keep fraction, 1/(1-p) scaling, rows dropped whole,
  the same draws for the same seed, and ``dropout_seq``'s compaction.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lam_slide_tpu.composites import md17 as jmd17
from lam_slide_tpu.composites import testing as jtesting
from lam_slide_tpu.train.state import create_train_state as j_create_train_state
from lam_slide_tpu.train.steps import make_train_step as j_make_train_step
from lam_slide_tpu.train.trainer import TrainerConfig as JTrainerConfig
from lam_slide_tpu.train.trainer import make_optimizer as j_make_optimizer
from lam_slide_tpu_torch import convert
from lam_slide_tpu_torch.composites import md17 as tmd17
from lam_slide_tpu_torch.composites.testing import make_protocol_val_hook
from lam_slide_tpu_torch.data.loader import device_batch
from lam_slide_tpu_torch.experiments import registry as treg
from lam_slide_tpu_torch.nn.blocks import dropout, dropout_seq
from lam_slide_tpu_torch.train import create_train_state, make_train_step

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
MOVED_TOL = 1e-2
SCALE = treg.MD17_SCALES["all"]


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


def _assert_moved_alike(start, got, want):
    for name, p in got.items():
        moved = want[name] - start[name]
        assert moved.norm() > 0, name
        err = (p.detach() - want[name]).norm()
        assert err <= MOVED_TOL * moved.norm(), f"{name}: {err} > {MOVED_TOL} x {moved.norm()}"


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _fs_sd(tree, constants):
    return convert.first_stage_state_dict_from_jax(jax.tree.map(np.asarray, tree), constants)


def _dit_sd(tree):
    return convert.class_cond_dit_state_dict_from_jax(jax.tree.map(np.asarray, tree))


# ---------------------------------------------------------------- stage 1

def _stage1(dropout_query=None):
    """The port's smoke stage-1 run and its first batch, and the JAX model and
    its init variables; the port model holds the JAX weights."""
    run = treg.md17_first_stage(smoke=True, device="cpu")
    if dropout_query is not None:
        run = dataclasses.replace(run, config=dataclasses.replace(run.config,
                                                                  dropout_query=dropout_query))
        run.model.decoder.query_mlp[0].rate = dropout_query
    batch = next(iter(run.train_loader))
    jcfg = jmd17.MD17FirstStageConfig(**dataclasses.asdict(run.config))
    jmodel = jmd17.build_md17_first_stage(jcfg)
    variables = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0), _jb(batch)))
    run.model.load_state_dict(_fs_sd(variables["params"], variables["constants"]))
    return run, batch, jmodel, jcfg, variables


def test_first_stage_loss_and_grads_match_jax():
    run, batch, jmodel, jcfg, variables = _stage1()
    jloss = jmd17.make_md17_first_stage_loss(jmodel, jcfg)
    (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jloss(p, variables["constants"], _jb(batch), jax.random.PRNGKey(1), False),
        has_aux=True))(variables["params"])
    total, metrics = run.loss_fn(run.model, device_batch(batch, "cpu"), None, False)
    total.backward()
    _rel_close(total, jtotal, name="total")
    assert set(metrics) == set(jmetrics)
    for k, v in metrics.items():
        _rel_close(v, jmetrics[k], name=k)
    _assert_grads_close(run.model.named_parameters(), _fs_sd(jgrads, variables["constants"]))


def test_first_stage_train_mode_draws_its_dropout_from_the_generator():
    """Train mode drops decoder queries (dropout_query 0.1) with draws from
    the step's generator: the same seed gives the same loss, another seed
    another loss, and eval mode none of that."""
    run, batch, *_ = _stage1()
    tb = device_batch(batch, "cpu")
    loss = lambda seed, train: run.loss_fn(
        run.model, tb, torch.Generator().manual_seed(seed), train)[0].item()
    assert loss(0, True) == loss(0, True)
    assert loss(0, True) != loss(1, True)
    assert loss(0, True) != loss(0, False) == loss(1, False)
    with pytest.raises(ValueError, match="Generator"):
        run.loss_fn(run.model, tb, None, True)


def test_first_stage_train_step_matches_jax():
    run, batch, jmodel, jcfg, variables = _stage1(dropout_query=0.0)
    jtx, _ = j_make_optimizer(JTrainerConfig(max_epochs=2, lr=4e-4), len(run.train_loader))
    jstate = j_create_train_state(variables, jtx)
    jstate, jm = j_make_train_step(jmd17.make_md17_first_stage_loss(jmodel, jcfg), jtx,
                                   donate_state=False)(jstate, _jb(batch), jax.random.PRNGKey(2))
    start = {n: p.detach().clone() for n, p in run.model.named_parameters()}
    state = create_train_state(run.model, run.tx)
    state, metrics = make_train_step(run.loss_fn, run.tx)(state, device_batch(batch, "cpu"), 0)
    _rel_close(metrics["loss"], jm["loss"], GRAD_TOL, "loss")
    _rel_close(metrics["grad_norm"], jm["grad_norm"], GRAD_TOL, "grad_norm")
    want = _fs_sd(jstate.params, variables["constants"])
    _assert_moved_alike(start, dict(run.model.named_parameters()), want)
    _assert_moved_alike(start, state.ema_params, _fs_sd(jstate.ema_params, variables["constants"]))


# ---------------------------------------------------------------- stage 2

@pytest.fixture(scope="module")
def stage2():
    """The port's smoke stage-2 run on a port first stage with the JAX
    weights, its first train batch and two val batches, and the JAX second
    stage with its init."""
    run1, _, jfs, _, fs_vars = _stage1()
    run2 = treg.md17_second_stage(first_stage=run1, smoke=True, device="cpu")
    batch = next(iter(run2.train_loader))
    val = {m: next(iter(loader)) for m, loader in list(run2.val_loaders.items())[:2]}
    jcfg = jmd17.MD17SecondStageConfig(in_dim=8, depth=2, hidden_size=32, num_heads=4,
                                       class_conditional=True, vec_in_dim=32,
                                       checkpointing=False)
    jss = jmd17.build_md17_second_stage(jcfg, jfs, fs_vars)
    x1, mk = jax.jit(jss.prepare_batch)(fs_vars, _jb(batch))
    params = jax.tree.map(np.asarray, jax.jit(jss.backbone.init)(
        jax.random.PRNGKey(1), x1, jnp.zeros((x1.shape[0],)), mk["x_cond"], mk["x_cond_mask"],
        mk["y_class"])["params"])
    return run2, batch, val, jss, fs_vars, params


def _jax_loss(jss):
    return jss.make_loss(weight_si_loss=1.0, weight_pos_loss=0.25, weight_inter_dist_loss=0.25,
                         calc_additional_losses=True, scale=SCALE)


def _inject_draws(monkeypatch, run2, jss, fs_vars, batch, key):
    """The port's transport replays the t and x0 JAX draws from ``key``."""
    x1, _ = jax.jit(jss.prepare_batch)(fs_vars, _jb(batch))
    t, x0, _ = jss.transport.sample(key, x1)
    t, x0 = torch.from_numpy(np.array(t)), torch.from_numpy(np.array(x0))
    monkeypatch.setattr(type(run2.second_stage.transport), "sample",
                        lambda self, x1, generator: (t, x0, x1))


def test_second_stage_loss_with_aux_losses_matches_jax(stage2, monkeypatch):
    run2, batch, _, jss, fs_vars, params = stage2
    run2.model.load_state_dict(_dit_sd(params))
    key = jax.random.PRNGKey(3)
    (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(jss)(p, {"first_stage": fs_vars}, _jb(batch), key, True),
        has_aux=True))(params)
    _inject_draws(monkeypatch, run2, jss, fs_vars, batch, key)
    run2.model.zero_grad(set_to_none=True)
    total, metrics = run2.loss_fn(run2.model, device_batch(batch, "cpu"), None, True)
    total.backward()
    _rel_close(total, jtotal, name="total")
    assert set(metrics) == set(jmetrics) == {"si_loss", "pos_loss", "inter_dist_loss", "dist"}
    for k, v in metrics.items():
        _rel_close(v, jmetrics[k], name=k)
    _assert_grads_close(run2.model.named_parameters(), _dit_sd(jgrads))
    # the first stage is frozen: the aux losses' gradient stops at the prediction
    assert all(p.grad is None and not p.requires_grad
               for p in run2.second_stage.first_stage.parameters())


def test_second_stage_train_step_matches_jax(stage2, monkeypatch):
    run2, batch, _, jss, fs_vars, params = stage2
    run2.model.load_state_dict(_dit_sd(params))
    jtx, _ = j_make_optimizer(JTrainerConfig(max_epochs=2, lr=1e-3), len(run2.train_loader))
    jstate = j_create_train_state({"params": params, "constants": {"first_stage": fs_vars}}, jtx)
    key = jax.random.PRNGKey(4)
    jstate, jm = j_make_train_step(_jax_loss(jss), jtx, donate_state=False)(
        jstate, _jb(batch), key)
    _inject_draws(monkeypatch, run2, jss, fs_vars, batch, jax.random.fold_in(key, jnp.int32(0)))
    start = {n: p.detach().clone() for n, p in run2.model.named_parameters()}
    state = create_train_state(run2.model, run2.tx)
    state, metrics = make_train_step(run2.loss_fn, run2.tx)(state, device_batch(batch, "cpu"),
                                                            0)
    for k in ("loss", "grad_norm", "si_loss", "pos_loss", "inter_dist_loss"):
        _rel_close(metrics[k], jm[k], GRAD_TOL, k)
    _assert_moved_alike(start, dict(run2.model.named_parameters()), _dit_sd(jstate.params))
    _assert_moved_alike(start, state.ema_params, _dit_sd(jstate.ema_params))


def test_protocol_val_hook_on_ema_weights_matches_jax(stage2, monkeypatch):
    """Both hooks sample the protocol (K=2, Euler-10) on the state's EMA
    weights, which differ from its weights, over the first batch of each of
    two molecules, fed the same initial noise."""
    run2, _, val, jss, fs_vars, params = stage2
    rng = np.random.default_rng(5)
    ema = jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(a.dtype), params)
    jtx, _ = j_make_optimizer(JTrainerConfig(), 1)
    jstate = j_create_train_state({"params": params, "constants": {"first_stage": fs_vars}},
                                  jtx).replace(ema_params=jax.tree.map(jnp.asarray, ema))
    run2.model.load_state_dict(_dit_sd(params))
    state = create_train_state(run2.model, run2.tx)
    state.ema_params = {k: v.clone() for k, v in _dit_sd(ema).items()
                        if k in state.ema_params}
    x1, _ = jax.jit(jss.prepare_batch)(fs_vars, _jb(next(iter(val.values()))))
    noise = rng.standard_normal(x1.shape).astype(np.float32)

    def jax_normal(key, shape, dtype=jnp.float32):
        assert tuple(shape) == noise.shape
        return jnp.asarray(noise, dtype)

    def torch_randn(shape, generator=None, device=None, dtype=None):
        return torch.from_numpy(np.broadcast_to(noise, tuple(shape)).copy()).to(device, dtype)

    monkeypatch.setattr(jax.random, "normal", jax_normal)
    monkeypatch.setattr(torch, "randn", torch_randn)
    kw = dict(scale=SCALE, k=2, limit_batches=1)
    loaders = {m: [b, b] for m, b in val.items()}
    want = jtesting.make_protocol_val_hook(jss, loaders, "md17", **kw)(jstate, 0)
    hook = make_protocol_val_hook(run2.second_stage, loaders, **kw)
    got = hook(state, 0)
    assert set(got) == {"ade", "fde"}
    for k in got:
        _rel_close(got[k], want[k], name=k)
    on_weights = dataclasses.replace(state, ema_params=dict(run2.model.named_parameters()))
    assert hook(on_weights, 0) != got


# ---------------------------------------------------------------- dropout

def test_dropout_keeps_one_minus_rate_and_rescales():
    x = torch.ones(200, 100)
    out = dropout(x, 0.25, torch.Generator().manual_seed(0), deterministic=False)
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 1 / 0.75))
    again = dropout(x, 0.25, torch.Generator().manual_seed(0), deterministic=False)
    assert torch.equal(out, again)
    other = dropout(x, 0.25, torch.Generator().manual_seed(1), deterministic=False)
    assert not torch.equal(out, other)
    assert dropout(x, 0.25, None) is x  # deterministic: identity, no draw
    rows = dropout(torch.ones(64, 10, 8), 0.5, torch.Generator().manual_seed(2),
                   deterministic=False, broadcast_dims=(2,))
    assert bool(((rows == 0).all(-1) | (rows == 2).all(-1)).all())
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.25, None, deterministic=False)


def test_dropout_seq_compacts_and_drops_padding_first():
    x = torch.arange(2 * 10, dtype=torch.float32).reshape(2, 10, 1)
    mask = torch.ones(2, 10, dtype=torch.bool)
    mask[1, 6:] = False
    out, out_mask = dropout_seq(x, mask, 0.4, torch.Generator().manual_seed(0))
    assert out.shape == (2, 6, 1) and out_mask.shape == (2, 6)
    assert bool(out_mask.all())  # the six real elements of row 1 are kept
    assert sorted(out[1, :, 0].tolist()) == list(range(10, 16))
    assert len(set(out[0, :, 0].tolist())) == 6
    again, _ = dropout_seq(x, mask, 0.4, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
