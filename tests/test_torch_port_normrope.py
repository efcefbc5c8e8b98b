"""K5 (flash attention with QKNorm + RoPE inside) and K3 (the packed flash
entry): the port's plain versions against the JAX kernels, on the CPU.

Inputs are made with numpy from a seed and fed to both sides; the JAX
kernels run in interpret mode, as the JAX package's own tests run them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_slide_tpu.models.latent_dit import rope_cos_sin as j_rope_cos_sin
from lam_slide_tpu.ops import flash_attention as jfa
from lam_slide_tpu.ops import flash_normrope as jnr
from lam_slide_tpu_torch.models.latent_dit import rope_cos_sin
from lam_slide_tpu_torch.ops import flash_attention as tfa
from lam_slide_tpu_torch.ops import flash_normrope as tnr

# fp32: only the order of fp32 sums differs. bf16: q/k round to bf16 after
# the norm and after the rope on both sides, but one-ulp flips of those
# roundings and of the softmax weights move outputs of size ~1 by ~1e-2.
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _inputs(seed, b, h, n, d):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3))
    qs, ks = ((1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32) for _ in range(2))
    cos, sin = (np.array(t) for t in j_rope_cos_sin(n, d))
    return q, k, v, qs, ks, cos, sin


def _both(arrays, dtype):
    """(jax args, torch args): q/k/v in ``dtype``, scales and tables fp32."""
    jargs = [jnp.asarray(a, dtype=dtype if i < 3 else jnp.float32) for i, a in enumerate(arrays)]
    targs = [torch.from_numpy(a).to(getattr(torch, dtype) if i < 3 else torch.float32)
             for i, a in enumerate(arrays)]
    return jargs, targs


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, dtype=np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_port_tables_are_the_jax_tables():
    for n, d in ((40, 8), (1000, 128)):
        for got, want in zip(rope_cos_sin(n, d), j_rope_cos_sin(n, d)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normrope_plain_matches_jax_kernel(dtype):
    arrays = _inputs(0, 2, 3, 40, 8)
    jargs, targs = _both(arrays, dtype)
    want = jnr.flash_attention_normrope(*jargs)
    got = tnr.flash_attention_normrope(*targs)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)
    _close(tnr.reference_attention_normrope(*targs), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normrope_plain_matches_jax_kernel_multi_block_padded(dtype):
    """N=70 with 32-row blocks: three q and key blocks, the last padded."""
    arrays = _inputs(1, 2, 2, 70, 16)
    jargs, targs = _both(arrays, dtype)
    want = jnr._nr_forward(*jargs, 16 ** -0.5, block_q=32, block_k=32)
    got = tnr.flash_attention_normrope(*targs, scale=16 ** -0.5)
    _close(got, want, dtype)


def test_normrope_plain_is_the_pre_transform_then_attention():
    q, k, v, qs, ks, cos, sin = (torch.from_numpy(a) for a in _inputs(2, 1, 2, 30, 12))
    q_t, k_t = (torch.from_numpy(np.asarray(t)) for t in jnr._pre_transform(
        *(jnp.asarray(a.numpy()) for a in (q, k, qs, ks, cos, sin))))
    got = tnr.reference_attention_normrope(q, k, v, qs, ks, cos, sin)
    torch.testing.assert_close(got, tfa.reference_attention(q_t, k_t, v), atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq,nk", [(40, 40), (40, 57)])
def test_masked_normrope_matches_jax(dtype, nq, nk):
    """A key-padding mask takes JAX's fallback (flash_normrope.py:496-498):
    the pre-transform, then flash attention with the mask. Batch rows with
    every key, with padded keys and with one key. At Nq == Nk the whole JAX
    call; at Nq != Nk (JAX's call takes one table for both sides) its parts,
    ``_pre_transform`` with the tables' first Nq and Nk rows and
    ``flash_attention`` with the mask."""
    rng = np.random.default_rng(nq * 100 + nk)
    d, h, b = 8, 3, 3
    q = rng.standard_normal((b, h, nq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, h, nk, d)).astype(np.float32) for _ in range(2))
    qs, ks = ((1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32) for _ in range(2))
    cos, sin = (np.array(t) for t in j_rope_cos_sin(max(nq, nk), d))
    mask = np.arange(nk)[None] < np.array([[nk], [nk - 9], [1]])
    jargs, targs = _both((q, k, v, qs, ks, cos, sin), dtype)
    if nq == nk:
        want = jnr.flash_attention_normrope(*jargs, mask=jnp.asarray(mask))
    else:
        jq, jk = jargs[:2]
        q_t, _ = jnr._pre_transform(jq, jq, *jargs[3:5], jargs[5][:nq], jargs[6][:nq])
        _, k_t = jnr._pre_transform(jk, jk, *jargs[3:5], jargs[5][:nk], jargs[6][:nk])
        want = jfa.flash_attention(q_t, k_t, jargs[2], mask=jnp.asarray(mask))
    got = tnr.flash_attention_normrope(*targs, mask=torch.from_numpy(mask))
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, h, nq, d)
    _close(got, want, dtype)


def test_packed_plain_matches_jax_packed_kernel():
    """H=8: the JAX packed entry runs its manual-DMA kernel (interpret mode)."""
    rng = np.random.default_rng(3)
    b, n, h, dh = 2, 48, 8, 8
    q, k, v = (rng.standard_normal((b, n, h * dh)).astype(np.float32) for _ in range(3))
    want = jfa.flash_attention_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h)
    got = tfa.flash_attention_packed(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), h)
    assert got.shape == (b, n, h * dh)
    _close(got, want, "float32")
    _close(tfa.reference_attention_packed(*(torch.from_numpy(a) for a in (q, k, v)), h),
           want, "float32")


def test_wrappers_count_nothing_on_the_cpu(monkeypatch):
    monkeypatch.setattr(tfa, "launches", 0)
    monkeypatch.setattr(tnr, "launches", 0)
    _, targs = _both(_inputs(4, 1, 2, 20, 8), "float32")
    tnr.flash_attention_normrope(*targs)
    tfa.flash_attention_packed(*(torch.zeros(1, 20, 16) for _ in range(3)), 2)
    assert tfa.launches == 0 and tnr.launches == 0
