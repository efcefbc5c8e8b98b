"""The port's attention backward and the autograd of its kernel wrappers
against the JAX package, on the CPU.

* K1's lse and K4's formulas: ``reference_attention(return_lse=True)`` and
  ``reference_flash_backward`` against JAX ``_flash_forward(with_lse=True)``
  and ``_flash_backward``, whose Pallas kernels run in interpret mode here,
  also with the key-padding bias row in fp32 and bf16 (the MD17 encoder's
  32 keys in one tile, and a ragged case with an all-masked row).
* K6: ``reference_normrope_backward`` against JAX ``_nr_backward``, and the
  whole chain to the raw q/k and the norm scales against ``jax.grad``
  through ``_nr_core``, at dh 128.
* The ``torch.autograd.Function`` of every kernel wrapper (K1/K3 + K4,
  K5 + K6, K2, K7, K8), run on CPU tensors with the kernel launch replaced
  by its plain version, against ``jax.grad`` / ``jax.vjp`` of the JAX
  wrappers with their kernels engaged (interpret mode).

Inputs are made with numpy from a seed. fp32 on both sides unless a test
says otherwise: only the order of fp32 sums differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_slide_tpu.models.latent_dit import rope_cos_sin as j_rope_cos_sin
from lam_slide_tpu.ops import flash_attention as jfa
from lam_slide_tpu.ops import flash_normrope as jnr
from lam_slide_tpu.ops import fused_adaln as jad
from lam_slide_tpu.ops import fused_mlp as jfm
from lam_slide_tpu.ops import fused_spatial_block as jsb
from lam_slide_tpu.ops.packed_attention import lane_rope_tables
from lam_slide_tpu_torch.models.latent_dit import rope_cos_sin
from lam_slide_tpu_torch.ops import flash_attention as tfa
from lam_slide_tpu_torch.ops import flash_normrope as tnr
from lam_slide_tpu_torch.ops import fused_adaln as tad
from lam_slide_tpu_torch.ops import fused_mlp as tfm
from lam_slide_tpu_torch.ops import fused_spatial_block as tsb

# fp32 gradients through one attention or block: sums in another order
# (XLA on the JAX side); values are O(1).
TOL = 2e-5


def _close(got, want, tol=TOL, err_msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=err_msg)


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a, requires_grad=False):
    return torch.from_numpy(np.array(a, dtype=np.float32)).requires_grad_(requires_grad)


@pytest.fixture
def jax_kernels(monkeypatch):
    """The JAX kernels of K2/K7/K8 engaged (interpret mode on the CPU)."""
    for mod in (jad, jsb, jfm):
        monkeypatch.setattr(mod, "FORCE_KERNEL", True)


@pytest.fixture
def plain_launches(monkeypatch):
    """Each wrapper's kernel launch replaced by its plain version, so that
    the autograd Functions run on CPU tensors."""
    monkeypatch.setattr(tfa, "_forward", lambda q, k, v, scale, with_lse, mask=None:
                        tfa.reference_attention(q, k, v, scale, return_lse=True, mask=mask))
    def normrope_forward(q, k, v, qs, ks, cos, sin, scale, with_lse):
        q_t, k_t = tnr.pre_transform(q, k, qs, ks, cos, sin)
        return (*tfa.reference_attention(q_t, k_t, v, scale, return_lse=True), q_t, k_t)

    monkeypatch.setattr(tnr, "_forward_kernels", normrope_forward)
    monkeypatch.setattr(tfm, "_launch", tfm.reference_mlp)

    def adaln(x, h, gate, shift, scale, eps):
        if h is None:
            return x, tad.reference_adaln_modulate(x, shift, scale, eps)
        return tad.reference_residual_adaln_modulate(x, h, gate, shift, scale, eps)

    monkeypatch.setattr(tad, "_launch", adaln)
    monkeypatch.setattr(tsb, "_launch", tsb.reference_spatial_block)


# (b, h, nq, nk, d, block): one block; padded q and k blocks; ragged Nq != Nk
SHAPES = [(1, 2, 64, 64, 16, 512), (1, 2, 260, 260, 16, 128), (2, 2, 130, 200, 24, 128)]


def _attn_inputs(seed, b, h, nq, nk, d):
    rng = np.random.default_rng(seed)
    return (_randn(rng, b, h, nq, d), _randn(rng, b, h, nk, d), _randn(rng, b, h, nk, d),
            _randn(rng, b, h, nq, d))


@pytest.mark.parametrize("b,h,nq,nk,d,blk", SHAPES)
def test_lse_matches_jax_flash_forward(b, h, nq, nk, d, blk):
    q, k, v, _ = _attn_inputs(0, b, h, nq, nk, d)
    scale = d ** -0.5
    out, lse = jfa._flash_forward(*(jnp.asarray(a) for a in (q, k, v)), None, scale,
                                  block_q=blk, block_k=blk, with_lse=True)
    got_out, got_lse = tfa.reference_attention(_t(q), _t(k), _t(v), scale, return_lse=True)
    assert got_lse.shape == (b, h, nq) and got_lse.dtype == torch.float32
    _close(got_out, out)
    _close(got_lse, lse)


@pytest.mark.parametrize("b,h,nq,nk,d,blk", SHAPES)
def test_flash_backward_matches_jax_kernels(b, h, nq, nk, d, blk):
    """K4's plain version against the JAX kernels pair, from the same out,
    lse and output gradient."""
    q, k, v, g = _attn_inputs(1, b, h, nq, nk, d)
    scale = d ** -0.5
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    out, lse = jfa._flash_forward(jq, jk, jv, None, scale, block_q=blk, block_k=blk,
                                  with_lse=True)
    want = jfa._flash_backward(jq, jk, jv, None, out, lse, jg, scale, block_q=blk, block_k=blk)
    got = tfa.reference_flash_backward(_t(q), _t(k), _t(v), _t(out), _t(lse), _t(g), scale)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape
        _close(a, w, err_msg=name)


def test_flash_backward_bf16_matches_jax_kernels():
    """bf16 operands on both sides: P and dS round to bf16 at the same
    points, but a differently summed fp32 value can land one bf16 ulp
    apart, which moves grads of size ~1 by ~1e-2."""
    b, h, nq, nk, d, blk = SHAPES[1]
    q, k, v, g = _attn_inputs(2, b, h, nq, nk, d)
    jq, jk, jv, jg = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g))
    out, lse = jfa._flash_forward(jq, jk, jv, None, 0.25, block_q=blk, block_k=blk,
                                  with_lse=True)
    want = jfa._flash_backward(jq, jk, jv, None, out, lse, jg, 0.25, block_q=blk, block_k=blk)
    bf = [torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
          for a in (jq, jk, jv, out, jg)]
    got = tfa.reference_flash_backward(*bf[:4], _t(lse), bf[4], 0.25)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16
        _close(a, w, tol=3e-2, err_msg=name)


# (b, h, nq, nk, d, block): the MD17 encoder's cross-attention (32 keys, one
# key tile: JAX's single_kb); ragged, padded q and key tiles
BIAS_SHAPES = [(2, 8, 192, 32, 16, 512), (2, 2, 130, 257, 24, 128)]


def _bias_row(seed, b, nk):
    """A key-padding bias row [B, Nk]: ragged lengths, batch row 0 all masked."""
    lengths = np.random.default_rng(seed).integers(1, nk + 1, size=b)
    mask = np.arange(nk)[None, :] < lengths[:, None]
    mask[0] = False
    return mask, np.asarray(jfa._mask_to_bias(jnp.asarray(mask), b, nk))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,nq,nk,d,blk", BIAS_SHAPES)
def test_flash_backward_with_bias_matches_jax_kernels(b, h, nq, nk, d, blk, dtype):
    """K4's plain version with the bias row against the JAX kernel pair with
    ``has_bias``, from the same out, lse and output gradient. An all-masked
    row's lse is the mask fill itself, so each of its keys gets P = 1 on both
    sides. fp32: sums in another order; bf16: P and dS one bf16 ulp apart
    (as in test_flash_backward_bf16_matches_jax_kernels)."""
    q, k, v, g = _attn_inputs(10, b, h, nq, nk, d)
    mask, bias = _bias_row(11, b, nk)
    scale = d ** -0.5
    jdt = jnp.dtype(dtype)
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in (q, k, v, g))
    out, lse = jfa._flash_forward(jq, jk, jv, jnp.asarray(bias), scale, block_q=blk,
                                  block_k=blk, with_lse=True)
    want = jfa._flash_backward(jq, jk, jv, jnp.asarray(bias), out, lse, jg, scale, block_q=blk,
                               block_k=blk)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tout, tg = (torch.from_numpy(np.array(a, np.float32)).to(tdt)
                            for a in (jq, jk, jv, out, jg))
    got = tfa.reference_flash_backward(tq, tk, tv, tout, _t(lse), tg, scale, _t(bias))
    assert bool(np.isclose(np.asarray(lse)[0], jfa._NEG_INF).all())  # the all-masked row
    via_mask = tfa.flash_attention_backward(tq, tk, tv, tout, _t(lse), tg, scale,
                                            mask=torch.from_numpy(mask))
    for name, a, w, m in zip(("dq", "dk", "dv"), got, want, via_mask):
        assert a.dtype == tdt and a.shape == w.shape
        assert torch.equal(a, m)
        _close(a, w, tol=TOL if dtype == "float32" else 3e-2, err_msg=name)


def test_masked_fp32_flash_attention_function_matches_jax_grad(plain_launches):
    """``_FlashAttention`` carries the mask: fp32 masked attention through it
    (K1 with lse and the bias, then K4 with the bias) against jax.grad of the
    JAX flash attention with the same mask."""
    b, h, nq, nk, d = 2, 8, 192, 32, 16
    q, k, v, g = _attn_inputs(12, b, h, nq, nk, d)
    mask, _ = _bias_row(13, b, nk)
    mask[0, :5] = True  # jax.grad's XLA backward: no all-masked row
    want = jax.grad(lambda *a: jnp.sum(jfa.flash_attention(*a, mask=jnp.asarray(mask))
                                       * jnp.asarray(g)), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (_t(a, True) for a in (q, k, v))
    out = tfa._FlashAttention.apply(tq, tk, tv, torch.from_numpy(mask), d ** -0.5)
    (out * _t(g)).sum().backward()
    for name, t, w in zip(("dq", "dk", "dv"), (tq, tk, tv), want):
        _close(t.grad, w, err_msg=name)


def test_flash_attention_function_matches_jax_grad(plain_launches):
    """``_FlashAttention`` (K1 with lse + K4) and the packed entry through it,
    against jax.grad of the JAX flash attention."""
    b, h, n, d = 2, 3, 150, 16
    q, k, v, g = _attn_inputs(3, b, h, n, n, d)
    want = jax.grad(lambda *a: jnp.sum(jfa.flash_attention(*a) * jnp.asarray(g)),
                    argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (_t(a, True) for a in (q, k, v))
    (tfa._FlashAttention.apply(tq, tk, tv, None, d ** -0.5) * _t(g)).sum().backward()
    for name, t, w in zip(("dq", "dk", "dv"), (tq, tk, tv), want):
        _close(t.grad, w, err_msg=name)


def _nr_inputs(seed, b, h, n, d):
    rng = np.random.default_rng(seed)
    q, k, v, g = (_randn(rng, b, h, n, d) for _ in range(4))
    qs, ks = ((1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32) for _ in range(2))
    cos, sin = (np.asarray(t) for t in j_rope_cos_sin(n, d))
    return q, k, v, qs, ks, cos, sin, g


def test_normrope_backward_matches_jax_kernels():
    """K6's plain version against JAX ``_nr_backward`` (dq_t, dk_t, dv) at
    dh 128, N=70 in 32-row blocks: padded q and key tiles."""
    q, k, v, qs, ks, cos, sin, g = _nr_inputs(4, 1, 2, 70, 128)
    scale = 128 ** -0.5
    ja = [jnp.asarray(a) for a in (q, k, v, qs, ks, cos, sin)]
    out, lse = jnr._nr_forward(*ja, scale, block_q=32, block_k=32, with_lse=True)
    want = jnr._nr_backward(*ja, out, lse, jnp.asarray(g), scale, block_q=32, block_k=32)
    got = tnr.reference_normrope_backward(*(_t(a) for a in (q, k, v, qs, ks, cos, sin)),
                                          _t(out), _t(lse), _t(g), scale)
    for name, a, w in zip(("dq_t", "dk_t", "dv"), got, want):
        _close(a, w, err_msg=name)


def test_normrope_function_matches_jax_grad(plain_launches):
    """``_FlashNormRope`` (K5 with lse, K6, then autograd of the plain
    pre-transform to the raw q/k and both scales) against jax.grad through
    JAX ``_nr_core`` at dh 128 with 32-row blocks."""
    q, k, v, qs, ks, cos, sin, g = _nr_inputs(5, 1, 2, 70, 128)
    scale = 128 ** -0.5
    jcos, jsin = jnp.asarray(cos), jnp.asarray(sin)
    want = jax.grad(lambda *a: jnp.sum(jnr._nr_core(*a[:5], jcos, jsin, scale, 32, 32)
                                       * jnp.asarray(g)),
                    argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a) for a in (q, k, v, qs, ks)))
    leaves = [_t(a, True) for a in (q, k, v, qs, ks)]
    out = tnr._FlashNormRope.apply(*leaves, _t(cos), _t(sin), scale)
    (out * _t(g)).sum().backward()
    for name, t, w in zip(("dq", "dk", "dv", "dq_scale", "dk_scale"), leaves, want):
        _close(t.grad, w, tol=5e-5, err_msg=name)


def _vjp(fn, args, cotangents):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    return out, vjp(cotangents)


def test_fused_mlp_function_matches_jax_vjp(jax_kernels, plain_launches):
    rng = np.random.default_rng(6)
    x, w1, b1, w2 = (_randn(rng, 2, 37, 32), _randn(rng, 32, 64, scale=0.2),
                     _randn(rng, 64, scale=0.1), _randn(rng, 64, 48, scale=0.2))
    g = _randn(rng, 2, 37, 48)
    out, want = _vjp(jfm.fused_mlp, (x, w1, b1, w2), jnp.asarray(g))
    leaves = [_t(a, True) for a in (x, w1, b1, w2)]
    got = tfm._FusedMLP.apply(*leaves)
    _close(got, out)
    (got * _t(g)).sum().backward()
    for name, t, w in zip(("dx", "dw1", "db1", "dw2"), leaves, want):
        _close(t.grad, w, err_msg=name)


def test_residual_adaln_function_matches_jax_vjp(jax_kernels, plain_launches):
    rng = np.random.default_rng(7)
    x, h = (_randn(rng, 2, 9, 3, 32, scale=2.0) for _ in range(2))
    gate, shift, scale = (_randn(rng, 2, 1, 1, 32, scale=0.5) for _ in range(3))
    gx, gy = (_randn(rng, 2, 9, 3, 32) for _ in range(2))
    (jx, jy), want = _vjp(jad.residual_adaln_modulate, (x, h, gate, shift, scale),
                          (jnp.asarray(gx), jnp.asarray(gy)))
    leaves = [_t(a, True) for a in (x, h, gate, shift, scale)]
    tx, ty = tad._ResidualAdaLN.apply(*leaves, 1e-6)
    _close(tx, jx)
    _close(ty, jy)
    ((tx * _t(gx)).sum() + (ty * _t(gy)).sum()).backward()
    for name, t, w in zip(("dx", "dh", "dgate", "dshift", "dscale"), leaves, want):
        _close(t.grad, w, err_msg=name)


def test_adaln_function_matches_jax_vjp(jax_kernels, plain_launches):
    rng = np.random.default_rng(8)
    x = _randn(rng, 2, 9, 2, 48, scale=3.0)
    shift, scale = (_randn(rng, 2, 1, 1, 48, scale=0.5) for _ in range(2))
    g = _randn(rng, 2, 9, 2, 48)
    out, want = _vjp(jad.adaln_modulate, (x, shift, scale), jnp.asarray(g))
    leaves = [_t(a, True) for a in (x, shift, scale)]
    got = tad._AdaLN.apply(*leaves, 1e-6)
    _close(got, out)
    (got * _t(g)).sum().backward()
    for name, t, w in zip(("dx", "dshift", "dscale"), leaves, want):
        _close(t.grad, w, err_msg=name)


@pytest.mark.parametrize("heads,dh", [(4, 8), (1, 32)])
def test_spatial_block_function_matches_jax_vjp(jax_kernels, plain_launches, heads, dh):
    rng = np.random.default_rng(9)
    n, l, m = 21, 2, 64
    d = heads * dh
    x = _randn(rng, n, l, d)
    w1, b1 = _randn(rng, d, 3 * d + m, scale=d ** -0.5), _randn(rng, 3 * d + m, scale=0.1)
    qs, ks = ((np.abs(rng.standard_normal(dh)) + 0.5).astype(np.float32) for _ in range(2))
    w2, b2 = _randn(rng, d + m, d, scale=(d + m) ** -0.5), _randn(rng, d, scale=0.1)
    g = _randn(rng, n, l, d)
    cos_l, sin_l = lane_rope_tables(*j_rope_cos_sin(l, dh), heads)
    out, want = _vjp(lambda *a: jsb.fused_spatial_block(*a, cos_l, sin_l, heads),
                     (x, w1, b1, qs, ks, w2, b2), jnp.asarray(g))
    # torch nn.Linear layout: w1 [3D+M, D], w2 [D, D+M]
    leaves = [_t(a, True) for a in (x, w1.T, b1, qs, ks, w2.T, b2)]
    cos, sin = rope_cos_sin(l, dh)
    got = tsb._SpatialBlock.apply(*leaves, cos, sin, heads, dh ** -0.5)
    _close(got, out)
    (got * _t(g)).sum().backward()
    want = list(want)
    want[1], want[5] = want[1].T, want[5].T
    for name, t, w in zip(("dx", "dw1", "db1", "dq_scale", "dk_scale", "dw2", "db2"),
                          leaves, want):
        _close(t.grad, w, tol=5e-5, err_msg=name)
