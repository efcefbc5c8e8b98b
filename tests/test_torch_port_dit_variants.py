"""The rest of the port's LatentDiT against the JAX package (CPU, fp32):
``attention_mode="linear"``, ``share_weights=True`` (with the
``block_shared`` conversion), ``ModulationTriple`` and ``linear_attention``.

The JAX models are built with ``reference_init=False`` so that no gate or
output layer is zero; their params go through
``lam_slide_tpu_torch.convert`` into the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_slide_tpu.models import LatentDiT as JLatentDiT
from lam_slide_tpu.models.latent_dit import ModulationTriple as JModulationTriple
from lam_slide_tpu.models.latent_dit import ParallelMLPAttention as JPMA
from lam_slide_tpu.models.latent_dit import rope_cos_sin as j_rope_cos_sin
from lam_slide_tpu.ops.attention import linear_attention as j_linear_attention
from lam_slide_tpu_torch.convert import _pma, latent_dit_state_dict_from_jax
from lam_slide_tpu_torch.models import LatentDiT
from lam_slide_tpu_torch.models.latent_dit import (
    ModulationTriple,
    ParallelMLPAttention,
    rope_cos_sin,
)
from lam_slide_tpu_torch.ops import attention as tattn
from lam_slide_tpu_torch.ops import fused_spatial_block as tfsb
from lam_slide_tpu_torch.ops.attention import linear_attention

CFG = dict(depth=3, in_dim=6, hidden_size=48, num_heads=4, mlp_ratio=2)
B, T, L = 2, 20, 2
# fp32 on both sides; only the order of fp32 sums differs (the limit of the
# port's other LatentDiT parity tests)
ATOL = RTOL = 5e-5


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, L, CFG["in_dim"])).astype(np.float32)
    t = rng.uniform(0.05, 0.95, size=(B,)).astype(np.float32)
    x_cond = rng.standard_normal(x.shape).astype(np.float32)
    mask = np.zeros((B, T, L), np.int32)
    mask[:, :3] = 1
    return x, t, x_cond, mask


def _jax_and_port(seed, **kw):
    """(JAX output, port output) of one LatentDiT on the same weights."""
    x, t, x_cond, mask = _inputs(seed)
    args = [jnp.asarray(a) for a in (x, t, x_cond, mask)]
    jmodel = JLatentDiT(**CFG, reference_init=False, **kw)
    variables = jmodel.init(jax.random.PRNGKey(seed), *args)
    want = jmodel.apply(variables, *args)
    sd = latent_dit_state_dict_from_jax(jax.tree.map(np.asarray, variables["params"]))
    port = LatentDiT(**CFG, reference_init=False, device="cpu", **kw)
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in (x, t, x_cond, mask)))
    assert np.abs(np.asarray(want)).max() > 0.1  # not a vacuous match
    return want, got, sd


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_attention_matches_jax(dtype):
    """fp32 math on both sides, one rounding to v's dtype (bf16: a one-ulp
    flip of that rounding, outputs of size ~0.1)."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, 3, 40, 16)).astype(np.float32) for _ in range(3))
    want = j_linear_attention(*(jnp.asarray(a, dtype) for a in (q, k, v)))
    got = linear_attention(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)))
    assert got.dtype == getattr(torch, dtype)
    tol = 2e-6 if dtype == "float32" else 4e-3
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("n", [2, 20], ids=["spatial", "temporal"])
def test_linear_mode_block_matches_jax(monkeypatch, n):
    """ParallelMLPAttention(attention_mode="linear") on both axes; on the
    small axis it does not take the spatial-block kernel's route (K8), on
    the long one not the flash route."""
    def no_kernel_route(*a, **k):
        raise AssertionError("a softmax-attention route was taken in linear mode")

    monkeypatch.setattr(tfsb, "reference_spatial_block", no_kernel_route)
    monkeypatch.setattr(tattn, "reference_attention_packed", no_kernel_route)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, n, 48)).astype(np.float32)
    cos, sin = j_rope_cos_sin(n, 12)
    jmod = JPMA(hidden_size=48, num_heads=4, mlp_ratio=2.0, attention_mode="linear",
                reference_init=False)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), cos,
                                                sin)["params"])
    for name in ("q_norm_scale", "k_norm_scale"):
        params[name] = rng.uniform(0.5, 1.5, params[name].shape).astype(np.float32)
    want = jmod.apply({"params": params}, jnp.asarray(x), cos, sin)
    port = ParallelMLPAttention(48, 4, 2.0, False, 8, torch.float32,
                                torch.Generator().manual_seed(0), attention_mode="linear")
    sd = {}
    _pma(sd, "m", params)
    port.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), *rope_cos_sin(n, 12))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_linear_mode_dit_matches_jax():
    want, got, _ = _jax_and_port(2, attention_mode="linear")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_unknown_attention_mode_raises():
    with pytest.raises(ValueError, match="attention_mode"):
        LatentDiT(**CFG, attention_mode="sparse", device="cpu")


def test_share_weights_dit_matches_jax():
    """share_weights=True: one layer applied depth times; the JAX
    ``block_shared`` params convert to the port's ``blocks.0``."""
    want, got, sd = _jax_and_port(3, share_weights=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    blocks = {k.split(".")[1] for k in sd if k.startswith("blocks.")}
    assert blocks == {"0"}
    # the shared layer really runs depth times: a depth-1 model on the same
    # weights gives another output
    one = LatentDiT(**dict(CFG, depth=1), reference_init=False, device="cpu")
    one.load_state_dict(sd, strict=True)
    x, t, x_cond, mask = (torch.from_numpy(a) for a in _inputs(3))
    with torch.no_grad():
        assert not torch.allclose(one(x, t, x_cond, mask), got, atol=1e-3)


def test_share_weights_with_linear_mode_matches_jax():
    want, got, _ = _jax_and_port(4, share_weights=True, attention_mode="linear")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_modulation_triple_matches_jax():
    rng = np.random.default_rng(5)
    vec = rng.standard_normal((3, 16)).astype(np.float32)
    jmod = JModulationTriple(dim=16, zero_init=False)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(5), jnp.asarray(vec))["params"])
    want = jmod.apply({"params": params}, jnp.asarray(vec))
    port = ModulationTriple(16, zero_init=False, gen=torch.Generator().manual_seed(0))
    port.lin.weight.data = torch.from_numpy(params["lin"]["kernel"].T.copy())
    port.lin.bias.data = torch.from_numpy(params["lin"]["bias"].copy())
    got = port(torch.from_numpy(vec), torch.float32)
    assert len(got) == 3
    for triple, jtriple in zip(got, want):
        for a, w in zip(triple, (jtriple.shift, jtriple.scale, jtriple.gate)):
            assert a.shape == (3, 1, 1, 16)
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)
    zero = ModulationTriple(16, zero_init=True, gen=torch.Generator().manual_seed(0))
    with torch.no_grad():
        triples = zero(torch.from_numpy(vec), torch.float32)
    assert all(float(p.abs().max()) == 0 for t in triples for p in t)
