"""K11 (the grouped whole-attention backward for short sequences): the
port's plain version against the JAX kernel ``_flash_backward_short``, on
the CPU.

Inputs are made with numpy from a seed; the forward's out and lse come from
the JAX flash forward and go to both sides. The JAX kernel runs in interpret
mode, as ``tests/test_flash_attention.py::TestShortGroupedBackward`` runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_slide_tpu.ops.ablations.short_backward import _flash_backward_short
from lam_slide_tpu.ops.attention import xla_attention
from lam_slide_tpu.ops.flash_attention import _flash_forward
from lam_slide_tpu_torch.ops import flash_attention as tfa
from lam_slide_tpu_torch.ops.ablations import short_backward as tsb

# JAX's own three shapes (bh, n, dh, group): bh not a multiple of the group,
# the MD17 spatial length with an odd head count, an odd sequence length
SHAPES = [(6, 64, 16, 8), (16, 192, 24, 8), (4, 33, 16, 4)]
# fp32: the limits JAX holds its kernel to against jax.grad (rtol 1e-4, atol
# 1e-5). bf16: P and dS round to bf16 at the same points on both sides, but
# a value summed in another order can land one bf16 ulp apart, which moves a
# grad of size ~1 by ~1e-2.
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (3e-2, 3e-2)}


def _case(bh, n, d, dtype, seed=7):
    rng = np.random.default_rng(seed)
    b, h = 2, bh // 2
    q, k, v, g = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(4))
    jq, jk, jv, jg = (jnp.asarray(a, dtype) for a in (q, k, v, g))
    scale = float(d ** -0.5)
    out, lse = _flash_forward(jq, jk, jv, None, scale, with_lse=True)
    tdtype = getattr(torch, dtype)
    targs = [torch.from_numpy(np.array(a, np.float32)).to(tdtype) for a in (jq, jk, jv, out)]
    targs += [torch.from_numpy(np.array(lse)), torch.from_numpy(np.array(jg, np.float32))
              .to(tdtype)]
    return (jq, jk, jv, out, lse, jg), targs, scale


def _close(got, want, dtype):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,n,d,group", SHAPES)
def test_plain_version_matches_jax_kernel(bh, n, d, group, dtype):
    jargs, targs, scale = _case(bh, n, d, dtype)
    want = _flash_backward_short(*jargs, scale, group=group)
    got = tsb.flash_backward_short(*targs, scale, group=group)
    for a, w, t in zip(got, want, targs[:3]):
        assert a.dtype == t.dtype and a.shape == t.shape
        _close(a, w, dtype)


def test_plain_version_matches_xla_grads():
    """In fp32 the grads are those of the attention itself (jax.grad of the
    XLA attention), JAX's own check, at the MD17 spatial length."""
    jargs, targs, scale = _case(4, 192, 16, "float32", seed=8)
    jq, jk, jv, _, _, jg = jargs
    want = jax.grad(lambda q, k, v: jnp.sum(xla_attention(q, k, v) * jg),
                    argnums=(0, 1, 2))(jq, jk, jv)
    for a, w in zip(tsb.reference_flash_backward_short(*targs, scale), want):
        _close(a, w, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_does_not_change_the_result(dtype):
    _, targs, scale = _case(6, 33, 24, dtype, seed=9)
    first = tsb.flash_backward_short(*targs, scale, group=1)
    for group in (2, 4, 8, 64):
        for a, b in zip(tsb.flash_backward_short(*targs, scale, group=group), first):
            torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_plain_version_is_k4s_plain_backward():
    """Without a bias, K11's formulas are K4's: the plain versions agree bit
    for bit (the chip check holds K11 to K4's grads on the same out/lse)."""
    _, targs, scale = _case(6, 64, 16, "bfloat16", seed=10)
    for a, b in zip(tsb.reference_flash_backward_short(*targs, scale),
                    tfa.reference_flash_backward(*targs, scale)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
