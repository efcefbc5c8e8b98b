"""dh 128 in fp32: the port's plain versions against the JAX package at the
head width of the 2 x dh 128 (MD17) and 3 x dh 128 (4AA) splits, on the CPU.

The fp32 sampling DiTs of the MD17 ``--test`` pass and of the 4AA eval run
K5 in fp32 at dh 128 on the card (the fp32 QK-norm + RoPE transform, then
K1's fp32 kernel over 64 < dh <= 128). Their plain versions, which the CPU
takes, are held to JAX here on inputs made with numpy from a seed; the JAX
kernels run in interpret mode, as the JAX package's own tests run them:

* ``reference_attention`` in fp32 at dh 96 and 128 over N = 30 (MD17's
  temporal axis) and 192 (its spatial axis), plain, with the lse and with a
  ragged key-padding bias (an all-masked row included), against JAX
  ``_flash_forward``;
* ``pre_transform`` and ``reference_attention_normrope`` (with its lse) in
  fp32 at dh 128 against JAX ``_pre_transform`` and ``_nr_forward``;
* a ``LatentDiT`` forward in fp32 at 2 x 128 (hidden 256, depth 2, T = 30,
  L = 16, so both axes take the K5 branch) on weights converted from JAX,
  against the JAX model on its default CPU route and on its K5 route.

The MD17 fp32 protocol at ``num_heads=2`` and a 4AA Euler window at a dh-128
width are width cases of the existing tests
(``tests/test_torch_port_cli.py::test_fp32_protocol_matches_jax`` and the
``world`` fixture of ``tests/test_torch_port_eval.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_slide_tpu.models import LatentDiT as JLatentDiT
from lam_slide_tpu.models.latent_dit import rope_cos_sin as j_rope_cos_sin
from lam_slide_tpu.ops import flash_attention as jfa
from lam_slide_tpu.ops import flash_normrope as jnr
from lam_slide_tpu_torch.convert import latent_dit_state_dict_from_jax
from lam_slide_tpu_torch.models import LatentDiT
from lam_slide_tpu_torch.ops import flash_attention as tfa
from lam_slide_tpu_torch.ops import flash_normrope as tnr

# fp32 on both sides: only the order of the sums differs (dot products over
# dh 128, softmax sums over N <= 192), outputs and lse of size ~1 to ~6.
ATTN_TOL = 2e-5
# the pre-transform: the same elementwise ops; the mean of squares summed in
# another order moves a normed value by an fp32 ulp or two
TRANSFORM_TOL = 1e-6
# the DiT's output through two fp32 layers with non-zero gates (the limit of
# tests/test_torch_port_dit.py)
DIT_TOL = 5e-5


def _qkv(seed, b, h, nq, nk, dh, scale=1.0):
    rng = np.random.default_rng(seed)
    q = (scale * rng.standard_normal((b, h, nq, dh))).astype(np.float32)
    k, v = ((scale * rng.standard_normal((b, h, nk, dh))).astype(np.float32) for _ in range(2))
    return rng, q, k, v


@pytest.mark.parametrize("variant", ["plain", "lse", "bias"])
@pytest.mark.parametrize("n", [30, 192])
@pytest.mark.parametrize("dh", [96, 128])
def test_fp32_attention_matches_jax_at_wide_heads(dh, n, variant):
    rng, q, k, v = _qkv(dh + n, 2, 2, n, n, dh)
    scale = dh ** -0.5
    mask = None
    if variant == "bias":
        mask = np.arange(n)[None, :] < rng.integers(1, n + 1, size=(2, 1))
        mask[0] = False  # an all-masked row: uniform weights over its keys on both sides
    bias = None if mask is None else jfa._mask_to_bias(jnp.asarray(mask), 2, n)
    want = jfa._flash_forward(*(jnp.asarray(a) for a in (q, k, v)), bias, scale,
                              with_lse=variant == "lse")
    targs = [torch.from_numpy(a) for a in (q, k, v)]
    tmask = None if mask is None else torch.from_numpy(mask)
    got = tfa.reference_attention(*targs, scale, return_lse=variant == "lse", mask=tmask)
    if variant == "lse":
        (got, got_lse), (want, want_lse) = got, want
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=ATTN_TOL,
                                   rtol=ATTN_TOL)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL, rtol=ATTN_TOL)
    # the wrapper takes the same plain version on CPU tensors
    np.testing.assert_allclose(tfa.flash_attention(*targs, mask=tmask, scale=scale).numpy(),
                               np.asarray(want), atol=ATTN_TOL, rtol=ATTN_TOL)


@pytest.mark.parametrize("n", [30, 192])
def test_fp32_normrope_matches_jax_at_dh128(n):
    dh = 128
    rng, q, k, v = _qkv(n, 2, 3, n, n, dh, scale=2.0)
    qs, ks = ((1.0 + 0.2 * rng.standard_normal(dh)).astype(np.float32) for _ in range(2))
    cos, sin = (np.array(t) for t in j_rope_cos_sin(n, dh))
    arrays = (q, k, v, qs, ks, cos, sin)
    jargs = [jnp.asarray(a) for a in arrays]
    targs = [torch.from_numpy(a) for a in arrays]
    want_t = jnr._pre_transform(jargs[0], jargs[1], *jargs[3:])
    got_t = tnr.pre_transform(targs[0], targs[1], *targs[3:])
    for got, want in zip(got_t, want_t):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TRANSFORM_TOL,
                                   rtol=TRANSFORM_TOL)
    want, want_lse = jnr._nr_forward(*jargs, dh ** -0.5, with_lse=True)
    got = tnr.reference_attention_normrope(*targs)
    _, got_lse = tfa.reference_attention(*got_t, targs[2], dh ** -0.5, return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL, rtol=ATTN_TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=ATTN_TOL,
                               rtol=ATTN_TOL)
    np.testing.assert_allclose(tnr.flash_attention_normrope(*targs).numpy(), np.asarray(want),
                               atol=ATTN_TOL, rtol=ATTN_TOL)


DIT = dict(depth=2, in_dim=8, hidden_size=256, num_heads=2, mlp_ratio=2)
B, T, L = 2, 30, 16


@pytest.mark.parametrize("jax_route", ["default", "kernel_normrope"])
def test_dit_forward_at_2x128_matches_jax(monkeypatch, jax_route):
    """Both axes exceed the packed threshold (8), so the port's temporal and
    spatial blocks take the K5 branch (dh % 128 == 0). The JAX model on the
    CPU takes its packed route by default, and its K5 (``_nr_flash_kernel``
    in interpret mode) with LAM_SLIDE_KERNEL_NORMROPE=1."""
    if jax_route == "kernel_normrope":
        monkeypatch.setenv("LAM_SLIDE_KERNEL_NORMROPE", "1")
    rng = np.random.default_rng(128)
    x = rng.standard_normal((B, T, L, DIT["in_dim"])).astype(np.float32)
    t = rng.uniform(0.05, 0.95, size=(B,)).astype(np.float32)
    x_cond = rng.standard_normal(x.shape).astype(np.float32)
    mask = np.zeros((B, T, L), np.int32)
    mask[:, :3] = 1
    jmodel = JLatentDiT(**DIT, reference_init=False)
    args = [jnp.asarray(a) for a in (x, t, x_cond, mask)]
    variables = jmodel.init(jax.random.PRNGKey(0), *args)
    want = np.asarray(jmodel.apply(variables, *args))
    port = LatentDiT(**DIT, reference_init=False, device="cpu")
    port.load_state_dict(latent_dit_state_dict_from_jax(
        jax.tree.map(np.asarray, variables["params"])), strict=True)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in (x, t, x_cond, mask)))
    assert np.abs(want).max() > 0.1  # non-zero output: not a vacuous match
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=DIT_TOL, rtol=DIT_TOL)
