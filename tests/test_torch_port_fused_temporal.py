"""K10 (packed QK RMS-norm + RoPE + flash attention in one kernel), the lane
forms of the packed ops and ``ParallelMLPAttention(fused_temporal=True)``:
the port's plain versions against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both sides; the JAX
kernel runs in interpret mode, as ``tests/test_fused_temporal.py`` runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_slide_tpu.models.latent_dit import ParallelMLPAttention as JPMA
from lam_slide_tpu.models.latent_dit import rope_cos_sin as j_rope_cos_sin
from lam_slide_tpu.ops import packed_attention as jpa
from lam_slide_tpu.ops.ablations import fused_temporal_attention as jft
from lam_slide_tpu_torch.convert import _pma
from lam_slide_tpu_torch.models.latent_dit import ParallelMLPAttention, rope_cos_sin
from lam_slide_tpu_torch.ops import flash_normrope as tnr
from lam_slide_tpu_torch.ops import packed_attention as tpa
from lam_slide_tpu_torch.ops.ablations import fused_temporal_attention as tft

N, T, H, DH = 3, 64, 4, 16
D = H * DH
# fp32: only the order of fp32 sums differs (JAX's own fused-vs-reference
# limit). bf16: q/k round once to bf16 on both sides, but a one-ulp flip of
# that rounding or of the bf16 weights moves outputs of size ~1 by ~1e-2.
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# gradients in fp32, the tolerance tests/test_fused_temporal.py holds the
# JAX op's gradient to
GRAD_TOL = 1e-4


def _inputs(seed, tiled=True):
    """q/k/v [N, T, D], lane tables [T, D] and lane scales [1, D]; with
    ``tiled=False`` the scales differ per head (the JAX op takes any)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((N, T, D)).astype(np.float32) for _ in range(3))
    cos, sin = j_rope_cos_sin(T, DH)
    cos_l, sin_l = (np.asarray(t) for t in jpa.lane_rope_tables(cos, sin, H))
    if tiled:
        qs, ks = (np.tile(rng.uniform(0.5, 1.5, (1, DH)), (1, H)).astype(np.float32)
                  for _ in range(2))
    else:
        qs, ks = (rng.uniform(0.5, 1.5, (1, D)).astype(np.float32) for _ in range(2))
    return q, k, v, cos_l, sin_l, qs, ks


def _both(arrays, dtype):
    """(jax args, torch args): q/k/v in ``dtype``, tables and scales fp32."""
    jargs = [jnp.asarray(a, dtype=dtype if i < 3 else jnp.float32) for i, a in enumerate(arrays)]
    targs = [torch.from_numpy(a).to(getattr(torch, dtype) if i < 3 else torch.float32)
             for i, a in enumerate(arrays)]
    return jargs, targs


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_lane_forms_match_jax():
    """lane_rope_tables, packed_rope, packed_rmsnorm ([dh] and tiled [D]
    scales) and packed_small_attention against the JAX lane forms."""
    rng = np.random.default_rng(0)
    cos, sin = j_rope_cos_sin(T, DH)
    want_tables = jpa.lane_rope_tables(cos, sin, H)
    got_tables = tpa.lane_rope_tables(torch.from_numpy(np.array(cos)),
                                      torch.from_numpy(np.array(sin)), H)
    for got, want in zip(got_tables, want_tables):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = rng.standard_normal((N, T, D)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, DH).astype(np.float32)
    for dtype in ("float32", "bfloat16"):
        jx, tx = jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))
        tol = TOL[dtype]
        _close(tpa.packed_rope(tx, *got_tables), jpa.packed_rope(jx, *want_tables), tol)
        for s in (scale, np.tile(scale, H)):
            _close(tpa.packed_rmsnorm(tx, H, torch.from_numpy(s)),
                   jpa.packed_rmsnorm(jx, H, jnp.asarray(s)), tol)
    q, k, v = (rng.standard_normal((7, 2, D)).astype(np.float32) for _ in range(3))
    _close(tpa.packed_small_attention(*(torch.from_numpy(a) for a in (q, k, v)), H),
           jpa.packed_small_attention(*(jnp.asarray(a) for a in (q, k, v)), H), 2e-6)


@pytest.mark.parametrize("tiled", [True, False], ids=["tiled_scales", "per_lane_scales"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax_kernel(dtype, tiled):
    jargs, targs = _both(_inputs(1, tiled), dtype)
    want = jft.fused_temporal_attention(*jargs, H, DH ** -0.5)
    got = tft.fused_temporal_attention(*targs, H, DH ** -0.5)
    assert got.dtype == getattr(torch, dtype) and got.shape == (N, T, D)
    _close(got, want, TOL[dtype])
    _close(tft.reference_fused_temporal(*targs, H, DH ** -0.5), want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_packed_matches_jax(dtype):
    jargs, targs = _both(_inputs(2), dtype)
    want = jft._reference_packed(*jargs, H, DH ** -0.5, 1e-6)
    _close(tft.reference_packed(*targs, H, DH ** -0.5), want, TOL[dtype])


def test_plain_rounds_once_after_norm_and_rope():
    """In bf16 the kernel's plain version rounds q/k once; ``reference_packed``
    rounds after the norm and again after the RoPE, as the JAX backward's
    recompute does. The two differ, and the plain version is the closer of
    the two to the JAX kernel."""
    jargs, targs = _both(_inputs(3), "bfloat16")
    want = np.asarray(jft.fused_temporal_attention(*jargs, H, DH ** -0.5), np.float32)
    once = tft.reference_fused_temporal(*targs, H, DH ** -0.5).float().numpy()
    twice = tft.reference_packed(*targs, H, DH ** -0.5).float().numpy()
    assert np.abs(once - twice).max() > 0
    assert np.abs(once - want).mean() < np.abs(twice - want).mean()


def _jax_grads(jargs, g):
    def loss(q, k, v, qs, ks):
        out = jft.fused_temporal_attention(q, k, v, jargs[3], jargs[4], qs, ks, H, DH ** -0.5)
        return jnp.sum(out * g)

    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*jargs[:3], *jargs[5:])


def test_backward_matches_jax_grad():
    """The autograd Function's backward (the VJP of ``reference_packed``) and
    autograd of the CPU wrapper against jax.grad of the JAX op: dq, dk, dv
    and both lane scales."""
    arrays = _inputs(4, tiled=False)
    jargs, targs = _both(arrays, "float32")
    g = np.random.default_rng(5).standard_normal((N, T, D)).astype(np.float32)
    want = _jax_grads(jargs, jnp.asarray(g))
    got = tft.fused_temporal_backward(*targs, H, DH ** -0.5, 1e-6, torch.from_numpy(g))
    for a, w in zip(got, want):
        _close(a, w, GRAD_TOL)
    leaves = [t.clone().requires_grad_() if i in (0, 1, 2, 5, 6) else t
              for i, t in enumerate(targs)]
    out = tft.fused_temporal_attention(*leaves, H, DH ** -0.5)
    (out * torch.from_numpy(g)).sum().backward()
    for i, w in zip((0, 1, 2, 5, 6), want):
        _close(leaves[i].grad, w, GRAD_TOL)


def _pma_pair(hidden, heads, seed):
    """A JAX ParallelMLPAttention(fused_temporal=True) and the port's on the
    same weights (QK-norm scales moved off 1), with inputs [N, T, hidden]."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, T, hidden)).astype(np.float32)
    cos, sin = j_rope_cos_sin(T, hidden // heads)
    jmod = JPMA(hidden_size=hidden, num_heads=heads, mlp_ratio=2.0, fused_temporal=True,
                reference_init=False)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x), cos,
                                                sin)["params"])
    for name in ("q_norm_scale", "k_norm_scale"):
        params[name] = rng.uniform(0.5, 1.5, params[name].shape).astype(np.float32)
    want = jmod.apply({"params": params}, jnp.asarray(x), cos, sin)
    port = ParallelMLPAttention(hidden, heads, 2.0, False, 8, torch.float32,
                                torch.Generator().manual_seed(0), fused_temporal=True)
    sd = {}
    _pma(sd, "m", params)
    port.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    return port, torch.from_numpy(x), rope_cos_sin(T, hidden // heads), want


@pytest.mark.parametrize("hidden,heads", [(64, 4), (256, 2)], ids=["4x16", "2x128"])
def test_fused_temporal_block_matches_jax(monkeypatch, hidden, heads):
    """The block on the long axis takes K10's route, before the dh % 128 K5
    route (at 2 x 128 the K5 plain version is never reached), and matches
    the JAX block on converted weights."""
    def no_k5(*a, **k):
        raise AssertionError("the K5 route was taken")

    monkeypatch.setattr(tnr, "reference_attention_normrope", no_k5)
    calls = []
    real = tft.reference_fused_temporal
    monkeypatch.setattr(tft, "reference_fused_temporal",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    port, x, (cos, sin), want = _pma_pair(hidden, heads, seed=6)
    with torch.no_grad():
        got = port(x, cos, sin)
    assert calls == [1]
    assert np.abs(np.asarray(want)).max() > 0.1
    _close(got, want, 5e-5)
