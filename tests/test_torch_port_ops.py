"""PyTorch port ops vs their JAX counterparts, on the CPU in fp32.

Inputs are made with numpy from a seed and fed to both sides. Where the JAX
function reaches a Pallas kernel (flash attention, fused MLP) it runs in
interpret mode here, as the JAX package's own tests run it; the port's
wrappers take their plain PyTorch versions on CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_slide_tpu.models import latent_dit as jdit
from lam_slide_tpu.nn import norms as jnorms
from lam_slide_tpu.nn.embeddings import timestep_embedding as j_timestep_embedding
from lam_slide_tpu.ops import fused_adaln as jadaln
from lam_slide_tpu.ops import fused_mlp as jfm
from lam_slide_tpu.ops import fused_spatial_block as jfsb
from lam_slide_tpu.ops import packed_attention as jpa
from lam_slide_tpu.ops.flash_attention import _flash_forward, flash_attention as j_flash
from lam_slide_tpu_torch.models import latent_dit as tdit
from lam_slide_tpu_torch.nn import norms as tnorms
from lam_slide_tpu_torch.nn.blocks import gelu_exact
from lam_slide_tpu_torch.nn.embeddings import timestep_embedding as t_timestep_embedding
from lam_slide_tpu_torch.ops import flash_attention as tfa
from lam_slide_tpu_torch.ops import fused_adaln as tadaln
from lam_slide_tpu_torch.ops import fused_mlp as tfm
from lam_slide_tpu_torch.ops import packed_attention as tpa
from lam_slide_tpu_torch.ops.attention import attention
from lam_slide_tpu_torch.ops.fused_spatial_block import reference_spatial_block

# fp32 on both sides; only the order of fp32 sums differs.
ATOL = RTOL = 2e-5


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(t_out, j_out, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), atol=atol, rtol=rtol)


# --- K1: flash attention -------------------------------------------------------------


def test_flash_plain_matches_jax_kernel():
    rng = np.random.default_rng(0)
    q, k, v = (_randn(rng, 2, 4, 40, 12) for _ in range(3))
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    _close(got, want)


def test_flash_plain_matches_jax_kernel_multi_block_padded():
    """N=260 with 128-row blocks: three key blocks, the last one padded."""
    rng = np.random.default_rng(1)
    q, k, v = (_randn(rng, 2, 3, 260, 16) for _ in range(3))
    scale = 16 ** -0.5
    want = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, scale,
                          block_q=128, block_k=128)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              scale=scale)
    _close(got, want)


def test_attention_dispatch_on_cpu_is_plain():
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(_randn(rng, 1, 2, 130, 8)) for _ in range(3))
    before = tfa.launches
    for backend in ("auto", "plain"):
        torch.testing.assert_close(attention(q, k, v, backend=backend),
                                   tfa.reference_attention(q, k, v), atol=0, rtol=0)
    assert tfa.launches == before
    with pytest.raises(ValueError):
        attention(q, k, v, backend="pallas")


# --- K2: fused MLP -------------------------------------------------------------------


@pytest.mark.parametrize("shape,dims", [
    ((16, 40), (384, 768, 384)),
    ((3, 5, 7), (64, 128, 32)),
    ((2, 1000), (384, 768, 384)),
])
def test_fused_mlp_plain_matches_jax_kernel(monkeypatch, shape, dims):
    monkeypatch.setattr(jfm, "FORCE_KERNEL", True)
    d_in, d_mid, d_out = dims
    rng = np.random.default_rng(3)
    x = _randn(rng, *shape, d_in)
    w1 = _randn(rng, d_in, d_mid, scale=0.05)
    b1 = _randn(rng, d_mid)
    w2 = _randn(rng, d_mid, d_out, scale=0.05)
    want = jfm.fused_mlp(*(jnp.asarray(a) for a in (x, w1, b1, w2)))
    got = tfm.fused_mlp(*(torch.from_numpy(a) for a in (x, w1, b1, w2)))
    assert got.dtype == torch.float32
    # same tolerance as tests/test_fused_mlp.py for the kernel vs its reference
    _close(got, want, atol=2e-5, rtol=2e-5)


# --- norms, embeddings, activations --------------------------------------------------


def test_layer_norm_and_rms_normalize_match_jax():
    x = _randn(np.random.default_rng(4), 3, 7, 48, scale=3.0) + 1.5
    _close(tnorms.layer_norm(torch.from_numpy(x)), jnorms.layer_norm(jnp.asarray(x)))
    _close(tnorms.layer_norm(torch.from_numpy(x), eps=1e-5),
           jnorms.layer_norm(jnp.asarray(x), eps=1e-5))
    _close(tnorms.rms_normalize(torch.from_numpy(x)), jnorms.rms_normalize(jnp.asarray(x)))


def test_timestep_embedding_matches_jax():
    t = np.random.default_rng(5).uniform(0, 1, size=(6,)).astype(np.float32)
    for dim in (256, 7):
        # time_factor 1000 puts args up to ~1e3: fp32 cos/sin of large
        # arguments differ by a few ulp of the argument between libraries
        _close(t_timestep_embedding(torch.from_numpy(t), dim),
               j_timestep_embedding(jnp.asarray(t), dim), atol=1e-4, rtol=0)


def test_gelu_exact_matches_jax():
    x = _randn(np.random.default_rng(6), 1000, scale=4.0)
    _close(gelu_exact(torch.from_numpy(x)), jax.nn.gelu(jnp.asarray(x), approximate=False),
           atol=1e-6, rtol=1e-6)


# --- QKNorm, RoPE, small attention (packed JAX vs head-major port) -------------------


def _packed_to_headmajor(x, h):
    n, l, d = x.shape
    return x.reshape(n, l, h, d // h).transpose(0, 2, 1, 3)


def test_qknorm_matches_packed_rmsnorm():
    rng = np.random.default_rng(7)
    n, l, h, dh = 5, 6, 4, 12
    x = _randn(rng, n, l, h * dh, scale=2.0)
    scale = _randn(rng, dh) + 1.0
    want = jpa.packed_rmsnorm(jnp.asarray(x), h, jnp.asarray(scale))
    got = tpa.headmajor_rmsnorm(torch.from_numpy(_packed_to_headmajor(x, h)), torch.from_numpy(scale))
    _close(got, _packed_to_headmajor(np.asarray(want), h))


def test_rope_matches_packed_rope_and_tables():
    rng = np.random.default_rng(8)
    n, l, h, dh = 3, 20, 4, 12
    cos, sin = tdit.rope_cos_sin(l, dh)
    jcos, jsin = jdit.rope_cos_sin(l, dh)
    _close(cos, jcos, atol=1e-6, rtol=1e-6)
    _close(sin, jsin, atol=1e-6, rtol=1e-6)
    x = _randn(rng, n, l, h * dh)
    cos_l, sin_l = jpa.lane_rope_tables(jcos, jsin, h)
    want = jpa.packed_rope(jnp.asarray(x), cos_l, sin_l)
    got = tpa.headmajor_rope(torch.from_numpy(_packed_to_headmajor(x, h)), cos, sin)
    _close(got, _packed_to_headmajor(np.asarray(want), h))
    # apply_rope is the same rotation (reference mmdit.py:84-90)
    _close(tdit.apply_rope(torch.from_numpy(x[..., :dh]), cos, sin),
           jdit.apply_rope(jnp.asarray(x[..., :dh]), jcos, jsin))


def test_small_attention_matches_packed_small_attention():
    rng = np.random.default_rng(9)
    n, l, h, dh = 7, 3, 4, 8
    q, k, v = (_randn(rng, n, l, h * dh) for _ in range(3))
    want = jpa.packed_small_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h)
    got = tpa.small_attention(*(torch.from_numpy(_packed_to_headmajor(a, h)) for a in (q, k, v)))
    _close(got, _packed_to_headmajor(np.asarray(want), h))


# --- compositions --------------------------------------------------------------------


def test_spatial_block_matches_jax_reference():
    rng = np.random.default_rng(10)
    n, l, d, h, m = 6, 2, 48, 4, 96
    dh = d // h
    x = _randn(rng, n, l, d)
    w1 = _randn(rng, d, 3 * d + m, scale=0.1)  # JAX layout [in, out]
    b1 = _randn(rng, 3 * d + m, scale=0.1)
    qs, ks = _randn(rng, dh) + 1.0, _randn(rng, dh) + 1.0
    w2 = _randn(rng, d + m, d, scale=0.1)
    b2 = _randn(rng, d, scale=0.1)
    jcos, jsin = jdit.rope_cos_sin(l, dh)
    cos_l, sin_l = jpa.lane_rope_tables(jcos, jsin, h)
    want = jfsb._reference_spatial_block(
        *(jnp.asarray(a) for a in (x, w1, b1, qs, ks, w2, b2)), cos_l, sin_l, h, dh ** -0.5)
    cos, sin = tdit.rope_cos_sin(l, dh)
    t = torch.from_numpy
    got = reference_spatial_block(t(x), t(w1.T.copy()), t(b1), t(qs), t(ks), t(w2.T.copy()),
                                  t(b2), cos, sin, h, dh ** -0.5)
    _close(got, want)


def test_adaln_compositions_match_jax():
    rng = np.random.default_rng(11)
    x, hh = _randn(rng, 2, 5, 3, 16), _randn(rng, 2, 5, 3, 16)
    gate, shift, scale = (_randn(rng, 2, 1, 1, 16) for _ in range(3))
    jx, jy = jadaln.residual_adaln_modulate(*(jnp.asarray(a) for a in (x, hh, gate, shift, scale)))
    tx, ty = tadaln.residual_adaln_modulate(*(torch.from_numpy(a) for a in (x, hh, gate, shift, scale)))
    _close(tx, jx)
    _close(ty, jy)
    _close(tadaln.adaln_modulate(*(torch.from_numpy(a) for a in (x, shift, scale))),
           jadaln.adaln_modulate(*(jnp.asarray(a) for a in (x, shift, scale))))
