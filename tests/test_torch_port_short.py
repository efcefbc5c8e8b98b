"""K9's plain versions against the JAX short-axis attention, on the CPU.

The JAX ``short_attention`` runs its Pallas kernels in interpret mode here
(forward, and its custom VJP's grouped backward under ``jax.grad``); the
port's ``short_attention`` takes its plain version on CPU tensors, and
``reference_short_backward`` is the plain backward the K9 backward kernel is
held to on the card. Inputs come from numpy seeds, in bf16 and fp32, at the
MD17 temporal length and two ragged ones.

Tolerances: fp32 on both sides differs only in the order of fp32 sums
(2e-5 of the largest value). In bf16 both round the softmax weights, dS and
the outputs to bf16 at the same points; a weight or dS summed in another
order can land one bf16 ulp apart, which moves an output by a few ulps of
its own size, so the limit is 2e-2 of the largest value (~5 bf16 ulps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_slide_tpu.ops.short_attention import short_attention as j_short
from lam_slide_tpu_torch.ops import flash_attention as tfa
from lam_slide_tpu_torch.ops import short_attention as tsa
from lam_slide_tpu_torch.ops.attention import attention_packed

REL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
CASES = [(n, dtype) for n in (9, 30, 127) for dtype in ("float32", "bfloat16")]


def _inputs(n, dtype, b=2, heads=2, dh=16, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((b, n, heads * dh)).astype(np.float32) for _ in range(4)]
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return [jnp.asarray(a).astype(jd) for a in arrays], [torch.from_numpy(a).to(td)
                                                         for a in arrays]


def _assert_close(got, want, dtype):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= REL_TOL[dtype] * np.abs(want).max(), f"max err {err} of {np.abs(want).max()}"


@pytest.mark.parametrize("n,dtype", CASES)
def test_short_attention_plain_matches_jax_kernel(n, dtype):
    (q, k, v, _), tq = _inputs(n, dtype)
    want = j_short(q, k, v, 2)
    before = tsa.launches
    got = tsa.short_attention(*tq[:3], 2)
    assert tsa.launches == before and got.dtype == tq[0].dtype
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("n,dtype", CASES)
def test_short_backward_plain_matches_jax_grad(n, dtype):
    """The plain backward (K9's oracle) against jax.grad through the JAX
    kernel's custom VJP, and autograd of the plain forward against both."""
    (q, k, v, g), tq = _inputs(n, dtype, seed=1)

    def loss(q_, k_, v_):
        return jnp.sum(j_short(q_, k_, v_, 2).astype(jnp.float32) * g.astype(jnp.float32))

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    scale = 16 ** -0.5
    got = tsa.reference_short_backward(*tq, 2, scale)
    for a, w in zip(got, want):
        assert a.dtype == tq[0].dtype
        _assert_close(a, w, dtype)
    if dtype == "float32":
        leaves = [t.clone().requires_grad_() for t in tq[:3]]
        tsa.short_attention(*leaves, 2).backward(tq[3])
        for leaf, w in zip(leaves, want):
            _assert_close(leaf.grad, w, dtype)


def test_packed_dispatch_on_cpu_is_plain():
    """On the CPU every length takes the plain packed attention; no kernel
    counter moves."""
    _, (q, k, v, _) = _inputs(30, "float32")
    before = (tsa.launches, tfa.launches)
    for backend in ("auto", "plain"):
        torch.testing.assert_close(attention_packed(q, k, v, 2, backend=backend),
                                   tfa.reference_attention_packed(q, k, v, 2), atol=0, rtol=0)
    assert (tsa.launches, tfa.launches) == before
