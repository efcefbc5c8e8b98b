"""K5 and K6 on the write-once transform and the redesigned flash pair: what
of it runs on the CPU, against the JAX package.

* ``pre_transform`` (what the transform kernel computes, and the plain
  version it is held to on the card) against JAX ``_pre_transform`` on
  head-major views of a packed buffer, in bf16 and fp32.
* ``chain_backward``, the composition K6 runs (the attention backward on the
  transformed q/k, then the plain pre-transform's VJP to the raw q/k and the
  scales), with ``reference_flash_backward`` as the attention backward,
  against ``jax.vjp`` of the JAX function, its Pallas kernels in interpret
  mode.
* The route's host-side plan: the transformed q/k are contiguous head-major
  buffers that the TMA route takes beside a v view of the packed qkv.
* Calls on CPU tensors count no launch.

Inputs are made with numpy from a seed and fed to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_slide_tpu.models.latent_dit import rope_cos_sin as j_rope_cos_sin
from lam_slide_tpu.ops import flash_attention as jfa
from lam_slide_tpu.ops import flash_normrope as jnr
from lam_slide_tpu.ops.packed_attention import headmajor_rmsnorm, headmajor_rope
from lam_slide_tpu_torch.ops import flash_attention as tfa
from lam_slide_tpu_torch.ops import flash_normrope as tnr

# pre_transform against JAX's: the same rounding points, but XLA's CPU
# reduction sums the squares in another order than PyTorch's and its rsqrt
# differs from PyTorch's in the last fp32 bit (both read on this suite's
# inputs), so in fp32 the outputs differ by up to 2^-20 (the limit is
# 1e-6), and in bf16 a normed value can round one ulp apart, which the
# rotation carries into both elements of its pair. Readings over the 18
# bf16 cases below: at most 1 ulp at the pair's magnitude, on at most 4.3e-4
# of a case's elements (4 of 9,216 at dh 24, N 64; 4 of 768,000 at dh 128,
# N 1000; none in 11 of the 18 cases). The limits: 2 ulps, on at most 3x
# that share or on one pair (2 elements), whichever is more.
PRE_F32_TOL = 1e-6
PRE_BF16_PAIR_ULPS = 2
PRE_BF16_DIFF_SHARE = 1.3e-3
# The chain in fp32 against JAX: only the order of fp32 sums differs (the
# limit of the autograd tests in test_torch_port_backward.py).
CHAIN_TOL = 5e-5


def _pair_ulps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got - want| per element in bf16 ulps at the magnitude of its (even,
    odd) pair of ``want``."""
    mag = np.repeat(np.abs(want.reshape(*want.shape[:-1], -1, 2)).max(-1), 2, axis=-1)
    unit = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    return np.abs(got.astype(np.float64) - want.astype(np.float64)) / unit


def _packed_views(rng, b, n, h, dh):
    """Raw q/k/v [B, H, N, dh] as head-major views of one packed
    [B, N, 3, H, dh] buffer (numpy, fp32), the scales and the tables."""
    buf = (2 * rng.standard_normal((b, n, 3, h, dh))).astype(np.float32)
    qs, ks = ((1 + 0.2 * rng.standard_normal(dh)).astype(np.float32) for _ in range(2))
    cos, sin = (np.asarray(t) for t in j_rope_cos_sin(n, dh))
    return buf, qs, ks, cos, sin


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 130, 1000])
@pytest.mark.parametrize("dh", [24, 64, 128])
def test_pre_transform_matches_jax(dh, n, dtype):
    buf, qs, ks, cos, sin = _packed_views(np.random.default_rng(dh * 1000 + n), 2, n, 3, dh)
    jbuf = jnp.asarray(buf, dtype=dtype)
    want = jnr._pre_transform(*(jnp.swapaxes(jbuf[:, :, i], 1, 2) for i in (0, 1)),
                              *(jnp.asarray(a) for a in (qs, ks, cos, sin)))
    tbuf = torch.from_numpy(buf).to(getattr(torch, dtype))
    got = tnr.pre_transform(*(tbuf[:, :, i].transpose(1, 2) for i in (0, 1)),
                            *(torch.from_numpy(a) for a in (qs, ks, cos, sin)))
    for a, w in zip(got, want):
        assert a.dtype == getattr(torch, dtype) and tuple(a.shape) == w.shape
        a, w = a.float().numpy(), np.asarray(w.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(a, w, atol=PRE_F32_TOL, rtol=PRE_F32_TOL)
        else:
            ulps = _pair_ulps(a, w)
            assert ulps.max() <= PRE_BF16_PAIR_ULPS
            assert (ulps > 0).sum() <= max(2, PRE_BF16_DIFF_SHARE * ulps.size)


def _jax_normrope_vjp(q, k, v, qs, ks, cos, sin, g):
    """jax.vjp of JAX's QK-norm + RoPE attention at g -> (dq, dk, dv, dqs, dks).
    JAX's ``flash_attention_normrope`` (K5 and K6 in interpret mode) takes
    one [N, dh/2] table for both sides, so it needs Nq == Nk; otherwise the
    reference is the same composition built from JAX's parts (its
    head-major norm and RoPE on tables sliced per side, as the port's
    ``pre_transform`` slices them, then ``flash_attention``, K1 and K4)."""
    nq, nk = q.shape[2], k.shape[2]
    jcos, jsin = jnp.asarray(cos), jnp.asarray(sin)
    if nq == nk:
        def fn(q_, k_, v_, qs_, ks_):
            return jnr.flash_attention_normrope(q_, k_, v_, qs_, ks_, jcos, jsin)
    else:
        def fn(q_, k_, v_, qs_, ks_):
            q_t = headmajor_rope(headmajor_rmsnorm(q_, qs_, eps=tnr.EPS), jcos[:nq], jsin[:nq])
            k_t = headmajor_rope(headmajor_rmsnorm(k_, ks_, eps=tnr.EPS), jcos[:nk], jsin[:nk])
            return jfa.flash_attention(q_t, k_t, v_)
    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v, qs, ks)))
    return vjp(jnp.asarray(g))


@pytest.mark.parametrize("nq,nk", [(130, 257), (64, 64)])
def test_chain_backward_matches_jax_vjp(nq, nk):
    """K6's composition, with the plain attention backward, from the plain
    forward's out and lse, against jax.vjp at dh 128 (ragged query and key
    tiles, and one tile each): dq, dk, dv and both scales' grads."""
    rng = np.random.default_rng(nq + nk)
    b, h, dh = 1, 2, 128
    q = rng.standard_normal((b, h, nq, dh)).astype(np.float32)
    k, v = (rng.standard_normal((b, h, nk, dh)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((b, h, nq, dh)).astype(np.float32)
    qs, ks = ((1 + 0.1 * rng.standard_normal(dh)).astype(np.float32) for _ in range(2))
    cos, sin = (np.asarray(t) for t in j_rope_cos_sin(max(nq, nk), dh))
    want = _jax_normrope_vjp(q, k, v, qs, ks, cos, sin, g)
    tq, tk, tv, tqs, tks, tcos, tsin, tg = (torch.from_numpy(a)
                                            for a in (q, k, v, qs, ks, cos, sin, g))
    scale = dh ** -0.5
    q_t, k_t = tnr.pre_transform(tq, tk, tqs, tks, tcos, tsin)
    out, lse = tfa.reference_attention(q_t, k_t, tv, scale, return_lse=True)
    got = tnr.chain_backward(tfa.reference_flash_backward, tq, tk, tv, tqs, tks, tcos, tsin,
                             q_t, k_t, out, lse, tg, scale)
    for name, a, w in zip(("dq", "dk", "dv", "dq_scale", "dk_scale"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=CHAIN_TOL, rtol=CHAIN_TOL,
                                   err_msg=name)


def test_chain_backward_skips_grads_not_asked_for():
    rng = np.random.default_rng(7)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((1, 2, 20, 8)).astype(np.float32))
                  for _ in range(4))
    qs, ks = torch.ones(8), torch.ones(8)
    cos, sin = (torch.from_numpy(np.asarray(t)) for t in j_rope_cos_sin(20, 8))
    q_t, k_t = tnr.pre_transform(q, k, qs, ks, cos, sin)
    out, lse = tfa.reference_attention(q_t, k_t, v, 0.3, return_lse=True)
    got = tnr.chain_backward(tfa.reference_flash_backward, q, k, v, qs, ks, cos, sin, q_t, k_t,
                             out, lse, g, 0.3, needs=(True, False, False, False, True))
    assert [t is None for t in got] == [False, True, True, True, False]


@pytest.mark.parametrize("heads,dh", [(3, 128), (16, 24), (2, 20), (64, 6)])
def test_transformed_buffers_meet_the_tma_route(heads, dh):
    """The transform kernel's outputs are contiguous head-major q_t/k_t, and
    the redesigned kernels take the TMA route on them beside v, a head-major
    view of the packed linear1 output (row stride 3·H·dh), exactly when dh %
    8 == 0; otherwise their cp.async route."""
    b, n = 2, 1000
    qkv = torch.zeros(b, n, 3 * heads * dh, dtype=torch.bfloat16)
    q, k, v = (t.transpose(1, 2) for t in qkv.view(b, n, 3, heads, dh).unbind(2))
    q_t, k_t = tnr.empty_transformed(q, k)
    for t, like in ((q_t, q), (k_t, k)):
        assert t.is_contiguous() and t.shape == like.shape and t.dtype == like.dtype
    assert not q.is_contiguous()
    assert tfa.sm90_tma_ok(q_t, k_t, v) == (dh % 8 == 0)


COUNTERS = ("launches", "transform_launches", "sm90_launches", "sm90_cp_async_launches",
            "bwd_launches", "bwd_sm90_launches", "bwd_sm90_cp_async_launches")


def _cpu_inputs():
    rng = np.random.default_rng(3)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((1, 2, 30, 16)).astype(np.float32))
                  for _ in range(4))
    qs, ks = torch.ones(16), torch.ones(16)
    cos, sin = (torch.from_numpy(np.asarray(t)) for t in j_rope_cos_sin(30, 16))
    return q, k, v, qs, ks, cos, sin, g


def _forward(q, k, v, qs, ks, cos, sin, g):
    return tnr.flash_attention_normrope(q, k, v, qs, ks, cos, sin)


def _forward_backward(q, k, v, qs, ks, cos, sin, g):
    leaves = [t.clone().requires_grad_() for t in (q, k, v, qs, ks)]
    (tnr.flash_attention_normrope(*leaves, cos, sin) * g).sum().backward()
    return [t.grad for t in leaves]


def _backward(q, k, v, qs, ks, cos, sin, g):
    out, lse = tfa.reference_attention(*tnr.pre_transform(q, k, qs, ks, cos, sin), v,
                                       return_lse=True)
    return tnr.flash_attention_normrope_backward(q, k, v, qs, ks, cos, sin, out, lse, g,
                                                 16 ** -0.5)


def _transform(q, k, v, qs, ks, cos, sin, g):
    return tnr.qk_normrope(q, k, qs, ks, cos, sin)


@pytest.mark.parametrize("entry", [_forward, _forward_backward, _backward, _transform],
                         ids=lambda f: f.__name__.strip("_"))
def test_cpu_calls_count_no_launch(monkeypatch, entry):
    for name in COUNTERS:
        monkeypatch.setattr(tnr, name, 0)
    k1_k4 = (tfa.launches, tfa.sm90_launches, tfa.bwd_kv_launches, tfa.bwd_sm90_launches)
    out = entry(*_cpu_inputs())
    assert all(bool(torch.isfinite(t).all()) for t in out)
    assert [getattr(tnr, name) for name in COUNTERS] == [0] * len(COUNTERS)
    assert (tfa.launches, tfa.sm90_launches, tfa.bwd_kv_launches, tfa.bwd_sm90_launches) == k1_k4
