"""fp32 training through the port against the JAX package, on the CPU.

The fp32 stage-2 DiTs of both registries' ``--smoke`` runs, and the fp32
DiT at a registry's width (``--exp-set dit_dtype=float32``), train on the
card through K9-fp32's backward, K4-fp32 up to dh 128 (its register-tiled
pair above dh 64), K6 in fp32 (that pair on the transformed q/k, then the
plain chain VJP) and K8-fp32 under autograd. Here, on CPU tensors, the
port takes the plain versions those kernels are held to on the card, and
they are held to JAX on inputs made with numpy from a seed; the JAX Pallas
kernels run in interpret mode, as the JAX package's own tests run them:

* ``reference_short_backward`` against JAX ``_short_bwd`` at dh 8 and 16
  (the smoke DiTs' 4 x dh 8, MD17's 16 x dh 16) over n 16 and 30, and
  ``_ShortAttention`` (its launches replaced by the plain versions) against
  ``jax.grad`` through ``short_attention``;
* ``reference_flash_backward`` against JAX ``_flash_backward`` at dh 96 and
  128 over ragged N, with and without the key-padding bias;
* ``_FlashNormRope`` in fp32 at dh 128 (the forward's q_t/k_t kept, the
  attention grads from K4's formulas, the plain chain VJP) against
  ``jax.vjp`` of ``flash_attention_normrope``;
* an fp32 ``LatentDiT`` of depth 2 and hidden 256 at 2 x dh 128 and at
  16 x dh 16 on weights from ``convert.py``: the SI loss (with the t and x0
  JAX draws) and every grad against ``jax.grad`` of the JAX DiT with its
  kernels engaged;
* one train step of each registry's ``--smoke`` stage 2 (MD17 with its
  aux losses, 4AA with its geometry losses) on the same weights and batch:
  the loss, its parts, the grad norm and every DiT grad against JAX's.

fp32 on both sides: only the order of fp32 sums differs. Each test states
its tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lam_slide_tpu.ops.attention as jattn
from lam_slide_tpu.composites import md17 as jmd17
from lam_slide_tpu.composites import peptide as jpep
from lam_slide_tpu.models import LatentDiT as JLatentDiT
from lam_slide_tpu.models.latent_dit import rope_cos_sin as j_rope_cos_sin
from lam_slide_tpu.ops import flash_attention as jfa
from lam_slide_tpu.ops import flash_normrope as jnr
from lam_slide_tpu.ops import fused_adaln as jad
from lam_slide_tpu.ops import fused_mlp as jfm
from lam_slide_tpu.ops import fused_spatial_block as jsb
from lam_slide_tpu.ops import short_attention as jsa
from lam_slide_tpu.transport import create_transport as j_create_transport
from lam_slide_tpu_torch import convert
from lam_slide_tpu_torch.data.loader import device_batch
from lam_slide_tpu_torch.experiments import registry as treg
from lam_slide_tpu_torch.models import LatentDiT
from lam_slide_tpu_torch.ops import flash_attention as tfa
from lam_slide_tpu_torch.ops import flash_normrope as tnr
from lam_slide_tpu_torch.ops import short_attention as tsa
from lam_slide_tpu_torch.train import create_train_state, make_train_step
from lam_slide_tpu_torch.transport import create_transport


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a, requires_grad=False):
    return torch.from_numpy(np.array(a, dtype=np.float32)).requires_grad_(requires_grad)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel_close(got, want, tol, name=""):
    """max |got - want| <= tol x max |want|, and want not all zero."""
    got, want = _np(got), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    scale = np.abs(want).max()
    assert scale > 0, f"{name} is zero: a vacuous match"
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{name}: max err {err} > {tol} x {scale}"


@pytest.fixture
def jax_kernels(monkeypatch):
    """The JAX kernels of K2, K7 and K8 engaged (interpret mode on the CPU)."""
    for mod in (jad, jsb, jfm):
        monkeypatch.setattr(mod, "FORCE_KERNEL", True)


# ---------------------------------------------------------------- K9 fp32

# K9's fp32 backward: grads of size ~1 summed over n <= 30 keys or queries
# of dh <= 16 products in another order.
SHORT_TOL = 1e-5


@pytest.mark.parametrize("n,heads,dh", [(16, 4, 8), (30, 4, 8), (30, 16, 16), (16, 2, 16)])
def test_short_backward_plain_matches_jax_kernel_in_fp32(n, heads, dh):
    """``reference_short_backward`` (K9-fp32's oracle on the card) against
    JAX ``_short_bwd`` on head-major flattened rows, from the same q, k, v
    and output gradient: dq, dk and dv within SHORT_TOL of the largest."""
    rng = np.random.default_rng(n + dh)
    b = 3
    q, k, v, g = (_randn(rng, b, n, heads * dh) for _ in range(4))
    scale = dh ** -0.5

    def rows(a):  # packed [B, n, H*dh] -> JAX's [B*H*n, dh]
        return jnp.asarray(a.reshape(b, n, heads, dh).transpose(0, 2, 1, 3).reshape(-1, dh))

    want = jsa._short_bwd(*(rows(a) for a in (q, k, v, g)), n=n, scale=scale)
    got = tsa.reference_short_backward(*(_t(a) for a in (q, k, v, g)), heads, scale)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32
        w = np.asarray(w).reshape(b, heads, n, dh).transpose(0, 2, 1, 3).reshape(b, n, -1)
        _rel_close(a, w, SHORT_TOL, name)


def test_short_attention_function_matches_jax_grad_in_fp32(monkeypatch):
    """``_ShortAttention`` in fp32 (its forward launch replaced by the plain
    version; on CPU tensors its backward takes the plain backward) against
    jax.grad through JAX ``short_attention`` at the MD17 smoke DiT's
    temporal shape (T = 30, 4 x dh 8)."""
    monkeypatch.setattr(tsa, "_forward", tsa.reference_short_attention)
    rng = np.random.default_rng(7)
    q, k, v, g = (_randn(rng, 4, 30, 32) for _ in range(4))
    want = jax.grad(lambda *a: jnp.sum(jsa.short_attention(*a, 4) * jnp.asarray(g)),
                    argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [_t(a, True) for a in (q, k, v)]
    (tsa._ShortAttention.apply(*leaves, 4, 8 ** -0.5) * _t(g)).sum().backward()
    for name, t, w in zip(("dq", "dk", "dv"), leaves, want):
        _rel_close(t.grad, w, SHORT_TOL, name)


# ---------------------------------------------------------- K4 fp32 dh 128

# K4's fp32 formulas at dh 96/128: grads of size ~1 over up to 200 keys.
FLASH_TOL = 2e-5


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "bias"])
@pytest.mark.parametrize("nq,nk", [(30, 30), (130, 200)])
@pytest.mark.parametrize("dh", [96, 128])
def test_flash_backward_plain_matches_jax_kernels_at_wide_heads(dh, nq, nk, masked):
    """``reference_flash_backward`` (K4-fp32's oracle on the card) against JAX
    ``_flash_backward`` in 64-row blocks (ragged query and key tiles at 130
    and 200), from the JAX forward's out and lse: dq, dk and dv within
    FLASH_TOL of the largest; with a key-padding bias whose first row masks
    every key."""
    rng = np.random.default_rng(dh + nq)
    b, h = 2, 2
    q, g = (_randn(rng, b, h, nq, dh) for _ in range(2))
    k, v = (_randn(rng, b, h, nk, dh) for _ in range(2))
    mask = rng.uniform(size=(b, nk)) < 0.7
    mask[0] = False
    bias = jnp.asarray(tfa.mask_to_bias(torch.from_numpy(mask)).numpy()) if masked else None
    scale = dh ** -0.5
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    out, lse = jfa._flash_forward(jq, jk, jv, bias, scale, block_q=64, block_k=64,
                                  with_lse=True)
    want = jfa._flash_backward(jq, jk, jv, bias, out, lse, jg, scale, block_q=64, block_k=64)
    got = tfa.reference_flash_backward(_t(q), _t(k), _t(v), _t(out), _t(lse), _t(g), scale,
                                       None if bias is None else _t(bias))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32
        _rel_close(a, w, FLASH_TOL, name)


# --------------------------------------------------------------- K6 fp32

# The chain to the raw q/k and the scales carries the attention grads
# through rsqrt and the rotation: a few more fp32 roundings.
NORMROPE_TOL = 5e-5


@pytest.mark.parametrize("n", [30, 70])
def test_normrope_fp32_function_matches_jax_vjp(monkeypatch, n):
    """``_FlashNormRope`` in fp32 at dh 128, its forward launch replaced by the
    plain transform and attention (on CPU tensors its backward takes K4's
    plain formulas on the kept q_t/k_t, then the plain chain VJP), against
    ``jax.vjp`` of ``flash_attention_normrope`` (its Pallas K5/K6 in
    interpret mode): the output and the grads of q, k, v and both scales."""
    def forward(q, k, v, qs, ks, cos, sin, scale, with_lse):
        q_t, k_t = tnr.pre_transform(q, k, qs, ks, cos, sin)
        return (*tfa.reference_attention(q_t, k_t, v, scale, return_lse=True), q_t, k_t)

    monkeypatch.setattr(tnr, "_forward_kernels", forward)
    rng = np.random.default_rng(n)
    d = 128
    q, k, v, g = (_randn(rng, 2, 2, n, d) for _ in range(4))
    qs, ks = ((1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32) for _ in range(2))
    cos, sin = (np.asarray(t) for t in j_rope_cos_sin(n, d))
    jcos, jsin = jnp.asarray(cos), jnp.asarray(sin)
    want_out, vjp = jax.vjp(lambda *a: jnr.flash_attention_normrope(*a, jcos, jsin),
                            *(jnp.asarray(a) for a in (q, k, v, qs, ks)))
    want = vjp(jnp.asarray(g))
    leaves = [_t(a, True) for a in (q, k, v, qs, ks)]
    out = tnr._FlashNormRope.apply(*leaves, _t(cos), _t(sin), d ** -0.5)
    (out * _t(g)).sum().backward()
    _rel_close(out, want_out, NORMROPE_TOL, "out")
    for name, t, w in zip(("dq", "dk", "dv", "dq_scale", "dk_scale"), leaves, want):
        _rel_close(t.grad, w, NORMROPE_TOL, name)


# ------------------------------------------------------- the fp32 DiT grads

# One fp32 SI loss through two layers: the loss within 1e-5 relative, every
# grad within 1e-4 of its largest element (tests/test_torch_port_train.py's
# limit for the same step).
DIT_LOSS_TOL = 1e-5
DIT_GRAD_TOL = 1e-4
# hidden 256 at both MD17 splits; T = 30 and L = 16 put both axes past the
# packed threshold (8): the 2 x 128 split takes the K5 branch on both, the
# 16 x 16 split K9 on both (8 < n < 128), as JAX's "short" route does.
DIT_SPLITS = {"2x128": (2, "pallas"), "16x16": (16, "short")}
DB, DT, DL, DIN = 2, 30, 16, 8


@pytest.mark.parametrize("split", sorted(DIT_SPLITS))
def test_fp32_dit_loss_and_grads_match_jax(monkeypatch, jax_kernels, split):
    """The fp32 DiT (depth 2, hidden 256) on weights converted from the JAX
    init: the GVP SI loss fed the t and x0 JAX draws, and every parameter's
    grad, against ``jax.grad`` of the JAX DiT with its attention kernels
    engaged (K5/K6 at 2 x 128, K9 at 16 x 16, interpret mode)."""
    heads, backend = DIT_SPLITS[split]
    monkeypatch.setattr(jattn, "FORCE_BACKEND", backend)
    monkeypatch.setenv("LAM_SLIDE_KERNEL_NORMROPE", "1")
    cfg = dict(depth=2, in_dim=DIN, hidden_size=256, num_heads=heads, mlp_ratio=2)
    rng = np.random.default_rng(16)
    x1 = _randn(rng, DB, DT, DL, DIN)
    mask = np.zeros((DB, DT, DL), np.int32)
    mask[:, :3] = 1
    x_cond = x1 * mask[..., None]
    jmodel = JLatentDiT(**cfg, reference_init=False)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x1), jnp.zeros((DB,)),
                                  jnp.asarray(x_cond), jnp.asarray(mask))["params"]
    jtr = j_create_transport(path_type="GVP", prediction="data")
    key = jax.random.PRNGKey(17)

    def j_loss(p):
        out = jtr.training_losses(
            key, lambda xt, tt, **kw: jmodel.apply({"params": p}, xt, tt, **kw),
            jnp.asarray(x1), model_kwargs={"x_cond": jnp.asarray(x_cond),
                                           "x_cond_mask": jnp.asarray(mask)})
        return out["loss"].mean()

    jloss, jgrads = jax.jit(jax.value_and_grad(j_loss))(params)
    t, x0, _ = jtr.sample(key, jnp.asarray(x1))
    model = LatentDiT(**cfg, reference_init=False, dtype=torch.float32, device="cpu")
    model.load_state_dict(convert.latent_dit_state_dict_from_jax(
        jax.tree.map(np.asarray, params)))
    out = create_transport(path_type="GVP", prediction="data").training_losses(
        model, _t(x1), {"x_cond": _t(x_cond), "x_cond_mask": torch.from_numpy(mask)},
        t=torch.from_numpy(np.array(t)), x0=torch.from_numpy(np.array(x0)))
    loss = out["loss"].mean()
    loss.backward()
    _rel_close(loss, jloss, DIT_LOSS_TOL, "loss")
    want = convert.latent_dit_state_dict_from_jax(jax.tree.map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        _rel_close(p.grad, want[name].numpy(), DIT_GRAD_TOL, f"grad {name}")


# --------------------------------------------- the smoke stage-2 train steps

# One fp32 train step of a smoke stage 2: the loss and its parts within 1e-5
# relative and every DiT grad within 1e-4 of its largest element (fp32 sums
# in another order through the DiT and the frozen first stage's decode), the
# grad norm within 1e-4 relative.
STEP_LOSS_TOL = 1e-5
STEP_GRAD_TOL = 1e-4


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _inject_draws(monkeypatch, run2, jss, fs_vars, batch, key):
    """The port's transport replays the t and x0 JAX draws from ``key``."""
    x1, _ = jax.jit(jss.prepare_batch)(fs_vars, _jb(batch))
    t, x0, _ = jss.transport.sample(key, x1)
    t, x0 = torch.from_numpy(np.array(t)), torch.from_numpy(np.array(x0))
    monkeypatch.setattr(type(run2.second_stage.transport), "sample",
                        lambda self, x1, generator: (t, x0, x1))


def _smoke_step(monkeypatch, run2, batch, jss, fs_vars, params, j_loss, to_sd):
    """The port's train step (AdamW, clip, EMA) on the smoke stage 2 against
    jax.value_and_grad of the JAX loss, both fed the same draws and weights:
    the loss, its parts, the grad norm and every grad the optimizer is
    handed; every parameter moves."""
    key = jax.random.PRNGKey(21)
    (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: j_loss(p, {"first_stage": fs_vars}, _jb(batch), key, True),
        has_aux=True))(params)
    _inject_draws(monkeypatch, run2, jss, fs_vars, batch, key)
    run2.model.load_state_dict(to_sd(params))
    handed = {}
    real_step = run2.tx.step

    def step(params_, grads, *args):
        handed.update({k: g.detach().clone() for k, g in grads.items()})
        return real_step(params_, grads, *args)

    monkeypatch.setattr(run2.tx, "step", step)
    state = create_train_state(run2.model, run2.tx)
    state, metrics = make_train_step(run2.loss_fn, run2.tx)(state, device_batch(batch, "cpu"), 0)
    _rel_close(metrics["loss"], jtotal, STEP_LOSS_TOL, "loss")
    for k in jmetrics:
        _rel_close(metrics[k], jmetrics[k], STEP_LOSS_TOL, k)
    jnorm = float(jnp.sqrt(sum(jnp.sum(g * g) for g in jax.tree.leaves(jgrads))))
    _rel_close(metrics["grad_norm"], jnorm, STEP_GRAD_TOL, "grad_norm")
    want, start = to_sd(jgrads), to_sd(params)
    assert set(handed) == {n for n, _ in run2.model.named_parameters()}
    for name, p in run2.model.named_parameters():
        _rel_close(handed[name], want[name].numpy(), STEP_GRAD_TOL, f"grad {name}")
        assert not torch.equal(p.detach(), start[name]), f"{name} did not move"
    return metrics


def _md17_stage2():
    run1 = treg.md17_first_stage(smoke=True, device="cpu")
    batch1 = next(iter(run1.train_loader))
    jfs_cfg = jmd17.MD17FirstStageConfig(**dataclasses.asdict(run1.config))
    jfs = jmd17.build_md17_first_stage(jfs_cfg)
    fs_vars = jax.tree.map(np.asarray, jax.jit(jfs.init)(jax.random.PRNGKey(0), _jb(batch1)))
    run1.model.load_state_dict(convert.first_stage_state_dict_from_jax(
        fs_vars["params"], fs_vars["constants"]))
    run2 = treg.md17_second_stage(first_stage=run1, smoke=True, device="cpu")
    batch = next(iter(run2.train_loader))
    jcfg = jmd17.MD17SecondStageConfig(in_dim=8, depth=2, hidden_size=32, num_heads=4,
                                       class_conditional=True, vec_in_dim=32,
                                       checkpointing=False)
    jss = jmd17.build_md17_second_stage(jcfg, jfs, fs_vars)
    x1, mk = jax.jit(jss.prepare_batch)(fs_vars, _jb(batch))
    params = jax.tree.map(np.asarray, jax.jit(jss.backbone.init)(
        jax.random.PRNGKey(1), x1, jnp.zeros((x1.shape[0],)), mk["x_cond"], mk["x_cond_mask"],
        mk["y_class"])["params"])
    j_loss = jss.make_loss(weight_si_loss=1.0, weight_pos_loss=0.25,
                           weight_inter_dist_loss=0.25, calc_additional_losses=True,
                           scale=treg.MD17_SCALES["all"])
    return run2, batch, jss, fs_vars, params, j_loss


def _peptide_stage2():
    run1 = treg.peptide_first_stage(smoke=True, device="cpu")
    batch1 = next(iter(run1.train_loader))
    jfs_cfg = jpep.PeptideFirstStageConfig(**dataclasses.asdict(run1.config))
    jfs = jpep.build_peptide_first_stage(jfs_cfg)
    fs_vars = jax.tree.map(np.asarray, jax.jit(jfs.init)(jax.random.PRNGKey(0), _jb(batch1)))
    run1.model.load_state_dict(convert.first_stage_state_dict_from_jax(
        fs_vars["params"], fs_vars["constants"]))
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
    return run2, batch, jss, fs_vars, params, jpep.make_peptide_second_stage_loss(jss, jcfg)


def test_md17_smoke_stage2_train_step_matches_jax(monkeypatch):
    """``md17_second_stage --smoke``: the fp32 class-conditional DiT (hidden
    32, 4 x dh 8, 8 latents, T = 30: K8-fp32 and K9-fp32 on the card) with
    the aux losses through the frozen first stage."""
    run2, batch, jss, fs_vars, params, j_loss = _md17_stage2()
    assert run2.model.backbone.dtype == torch.float32
    metrics = _smoke_step(monkeypatch, run2, batch, jss, fs_vars, params, j_loss,
                          lambda tree: convert.class_cond_dit_state_dict_from_jax(
                              jax.tree.map(np.asarray, tree)))
    assert {"si_loss", "pos_loss", "inter_dist_loss"} <= set(metrics)


def test_peptide_smoke_stage2_train_step_matches_jax(monkeypatch):
    """``peptide_second_stage --smoke``: the fp32 DiT (hidden 32, 4 x dh 8,
    L = 2, T = 16: K8-fp32 and K9-fp32 on the card) with the geometry aux
    losses through the frozen first stage."""
    monkeypatch.setenv("LAM_SLIDE_NO_DATA_CACHE", "1")
    run2, batch, jss, fs_vars, params, j_loss = _peptide_stage2()
    assert run2.model.dtype == torch.float32
    metrics = _smoke_step(monkeypatch, run2, batch, jss, fs_vars, params, j_loss,
                          lambda tree: convert.latent_dit_state_dict_from_jax(
                              jax.tree.map(np.asarray, tree)))
    assert {"si_loss", "pos_loss", "torsion_loss"} <= set(metrics)
