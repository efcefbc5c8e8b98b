"""K7 (residual AdaLN) and K8 (the spatial block): the port's plain versions
against the JAX Pallas kernels, on the CPU.

The JAX kernels run in interpret mode with ``FORCE_KERNEL=True``, as the JAX
package's own tests run them; the port's wrappers take their plain versions
on CPU tensors. Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_slide_tpu.models.latent_dit import rope_cos_sin as j_rope_cos_sin
from lam_slide_tpu.ops import fused_adaln as jad
from lam_slide_tpu.ops import fused_spatial_block as jsb
from lam_slide_tpu.ops.packed_attention import lane_rope_tables
from lam_slide_tpu_torch.models.latent_dit import rope_cos_sin
from lam_slide_tpu_torch.ops import fused_adaln as tad
from lam_slide_tpu_torch.ops import fused_spatial_block as tsb

DTYPES = ["float32", "bfloat16"]


@pytest.fixture(autouse=True)
def jax_kernels(monkeypatch):
    monkeypatch.setattr(jad, "FORCE_KERNEL", True)
    monkeypatch.setattr(jsb, "FORCE_KERNEL", True)


def _to(arrays, dtype):
    return ([jnp.asarray(a, dtype=dtype) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def _np(t):
    return np.asarray(t, dtype=np.float32) if not isinstance(t, torch.Tensor) else t.float().numpy()


def _assert_y_close(got, want, dtype):
    """fp32: only the order of fp32 sums differs (2e-5). bf16: two bf16 ulps
    at max |y|: a differently summed mean or variance flips the rounding of
    the normalized value, which the modulate's product and sum round again
    (measured 1.5 ulps where the product crosses a power of two)."""
    got, want = _np(got), _np(want)
    atol = 2e-5 if dtype == "float32" else 2 * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got, want, atol=atol, rtol=2e-5 if dtype == "float32" else 0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_residual_adaln_plain_matches_jax_kernel(dtype):
    rng = np.random.default_rng(0)
    x, h = ((rng.standard_normal((2, 33, 3, 64)) * 2).astype(np.float32) for _ in range(2))
    gate, shift, scale = ((rng.standard_normal((2, 1, 1, 64)) * 0.5).astype(np.float32)
                          for _ in range(3))
    jargs, targs = _to((x, h, gate, shift, scale), dtype)
    jx, jy = jad.residual_adaln_modulate(*jargs)
    tx, ty = tad.residual_adaln_modulate(*targs)
    assert ty.dtype == getattr(torch, dtype)
    # bf16 rounds x + gate*h per op on both sides, so x_new is bit-identical;
    # in fp32 XLA contracts it into one FMA, a rounding apart (1 fp32 ulp)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_np(tx), _np(jx))
    else:
        np.testing.assert_allclose(_np(tx), _np(jx), atol=1e-6, rtol=1e-6)
    _assert_y_close(ty, jy, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_adaln_plain_matches_jax_kernel(dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 17, 2, 48)) * 3 + 1).astype(np.float32)
    shift, scale = ((rng.standard_normal((3, 1, 1, 48)) * 0.5).astype(np.float32)
                    for _ in range(2))
    jargs, targs = _to((x, shift, scale), dtype)
    _assert_y_close(tad.adaln_modulate(*targs), jad.adaln_modulate(*jargs), dtype)
    _assert_y_close(tad.reference_adaln_modulate(*targs), jad.adaln_modulate(*jargs), dtype)


def _spatial_inputs(seed, n, l, heads, dh, m):
    rng = np.random.default_rng(seed)
    d = heads * dh
    x = rng.standard_normal((n, l, d)).astype(np.float32)
    w1 = (rng.standard_normal((d, 3 * d + m)) * d ** -0.5).astype(np.float32)  # JAX [in, out]
    b1 = (rng.standard_normal(3 * d + m) * 0.1).astype(np.float32)
    qs, ks = ((np.abs(rng.standard_normal(dh)) + 0.5).astype(np.float32) for _ in range(2))
    w2 = (rng.standard_normal((d + m, d)) * (d + m) ** -0.5).astype(np.float32)
    b2 = (rng.standard_normal(d) * 0.1).astype(np.float32)
    return x, w1, b1, qs, ks, w2, b2


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("heads,dh", [(4, 8), (1, 32)])
@pytest.mark.parametrize("l", [2, 4])
def test_spatial_block_plain_matches_jax_kernel(dtype, heads, dh, l):
    x, w1, b1, qs, ks, w2, b2 = _spatial_inputs(2, 37, l, heads, dh, 64)
    jcos, jsin = j_rope_cos_sin(l, dh)
    cos_l, sin_l = lane_rope_tables(jcos, jsin, heads)
    jx = jnp.asarray(x, dtype=dtype)
    want = jsb.fused_spatial_block(jx, *(jnp.asarray(a) for a in (w1, b1, qs, ks, w2, b2)),
                                   cos_l, sin_l, heads)
    cos, sin = rope_cos_sin(l, dh)
    t = torch.from_numpy
    got = tsb.fused_spatial_block(t(x).to(getattr(torch, dtype)), t(w1.T.copy()), t(b1), t(qs),
                                  t(ks), t(w2.T.copy()), t(b2), cos, sin, heads, dh ** -0.5)
    assert got.shape == x.shape and got.dtype == getattr(torch, dtype)
    # fp32: the order of fp32 sums (and the JAX kernel's polynomial erf,
    # 1.5e-7). bf16: per-op bf16 roundings of linear1, the norm, the softmax
    # weights and linear2 that land one ulp apart (the JAX package holds its
    # kernel to its own composition at 2e-2 in bf16, tests/test_fused_spatial.py)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
