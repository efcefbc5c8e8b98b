"""The port's LatentDiT vs the reference golden and the JAX LatentDiT (CPU, fp32).

The JAX model is built with ``reference_init=False`` so that no gate or
output layer is zero and the comparison is not vacuous; its params go
through ``lam_slide_tpu_torch.convert`` into the port.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lam_slide_tpu.ops.attention as jattn
from lam_slide_tpu.models import LatentDiT as JLatentDiT
from lam_slide_tpu.models.latent_dit import stack_layer_params
from lam_slide_tpu.ops import fused_mlp as jfm
from lam_slide_tpu_torch.convert import latent_dit_state_dict_from_jax
from lam_slide_tpu_torch.models import LatentDiT

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "latent_dit_golden.npz")

# Small config: T must exceed packed_threshold=8 so the temporal axis takes
# the flash/fused-MLP path, and num_heads must not be a multiple of 8 so the
# JAX side runs the head-major flash kernel, not the packed one.
CFG = dict(depth=2, in_dim=6, hidden_size=48, num_heads=4, mlp_ratio=2)
B, T, L = 2, 20, 2
# fp32 on both sides through two layers with non-zero gates; only the order
# of fp32 sums differs (outputs are O(1)).
ATOL = RTOL = 5e-5


@pytest.mark.parametrize("packed_threshold", [0, 8])
def test_golden_loads_and_matches(packed_threshold):
    g = np.load(GOLDEN)
    sd = {k[len("dit."):]: torch.from_numpy(g[k]) for k in g.files if k.startswith("dit.")}
    model = LatentDiT(depth=2, in_dim=6, hidden_size=16, num_heads=4, mlp_ratio=2,
                      packed_threshold=packed_threshold, device="cpu")
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(g["x"]), torch.from_numpy(g["t"]),
                    torch.from_numpy(g["x_cond"]), torch.from_numpy(g["cmask"]))
    # the tolerance tests/test_torch_parity.py holds the JAX model to
    np.testing.assert_allclose(out.numpy(), g["out"], atol=3e-5, rtol=3e-5)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, L, CFG["in_dim"])).astype(np.float32)
    t = rng.uniform(0.05, 0.95, size=(B,)).astype(np.float32)
    x_cond = rng.standard_normal(x.shape).astype(np.float32)
    mask = np.zeros((B, T, L), np.int32)
    mask[:, :3] = 1
    return x, t, x_cond, mask


@pytest.fixture(scope="module")
def jax_model():
    model = JLatentDiT(**CFG, reference_init=False)
    x, t, x_cond, mask = _inputs()
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                           jnp.asarray(x_cond), jnp.asarray(mask))
    params = jax.tree.map(np.asarray, variables["params"])
    return model, variables, params


def _port_from(params):
    model = LatentDiT(**CFG, reference_init=False, device="cpu")
    model.load_state_dict(latent_dit_state_dict_from_jax(params), strict=True)
    return model


@pytest.mark.parametrize("jax_kernels", [False, True])
def test_converted_jax_model_matches(monkeypatch, jax_model, jax_kernels):
    """Default JAX CPU path, then with the JAX flash and fused-MLP kernels
    engaged (interpret mode) on the temporal axis."""
    if jax_kernels:
        monkeypatch.setattr(jattn, "FORCE_BACKEND", "pallas")
        monkeypatch.setattr(jfm, "FORCE_KERNEL", True)
    jmodel, variables, params = jax_model
    x, t, x_cond, mask = _inputs(seed=1)
    want = jmodel.apply(variables, *(jnp.asarray(a) for a in (x, t, x_cond, mask)))
    port = _port_from(params)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in (x, t, x_cond, mask)))
    assert np.abs(np.asarray(want)).max() > 0.1  # non-zero output: not a vacuous match
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_normalize_option_matches(jax_model):
    """normalize=True adds a parameter-free LayerNorm (eps 1e-5) on the input
    embedding; the same params serve both settings."""
    _, variables, params = jax_model
    x, t, x_cond, mask = _inputs(seed=3)
    jmodel = JLatentDiT(**CFG, reference_init=False, normalize=True)
    want = jmodel.apply(variables, *(jnp.asarray(a) for a in (x, t, x_cond, mask)))
    port = LatentDiT(**CFG, reference_init=False, normalize=True, device="cpu")
    port.load_state_dict(latent_dit_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in (x, t, x_cond, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_vector_conditioning_matches():
    """The optional ``y`` input through ``vec_in`` (vec_in_dim set)."""
    x, t, x_cond, mask = _inputs(seed=4)
    y = np.random.default_rng(5).standard_normal((B, 5)).astype(np.float32)
    jmodel = JLatentDiT(**CFG, vec_in_dim=5, reference_init=False)
    args = [jnp.asarray(a) for a in (x, t, x_cond, mask)]
    variables = jmodel.init(jax.random.PRNGKey(1), *args, y=jnp.asarray(y))
    want = jmodel.apply(variables, *args, y=jnp.asarray(y))
    port = LatentDiT(**CFG, vec_in_dim=5, reference_init=False, device="cpu")
    port.load_state_dict(latent_dit_state_dict_from_jax(
        jax.tree.map(np.asarray, variables["params"])), strict=True)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in (x, t, x_cond, mask)), y=torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_scan_layout_converts_to_the_same_state_dict(jax_model):
    _, _, params = jax_model
    unrolled = latent_dit_state_dict_from_jax(params)
    stacked = jax.tree.map(np.asarray, stack_layer_params(params, CFG["depth"]))
    scanned = latent_dit_state_dict_from_jax({"params": stacked})
    assert unrolled.keys() == scanned.keys()
    for key in unrolled:
        torch.testing.assert_close(scanned[key], unrolled[key], atol=0, rtol=0)


def test_bf16_port_runs_close_to_fp32(jax_model):
    """The bf16 compute dtype on the CPU plain path stays near the fp32 forward."""
    _, _, params = jax_model
    sd = latent_dit_state_dict_from_jax(params)
    fp32 = LatentDiT(**CFG, reference_init=False, device="cpu")
    bf16 = LatentDiT(**CFG, reference_init=False, dtype=torch.bfloat16, device="cpu")
    fp32.load_state_dict(sd)
    bf16.load_state_dict(sd)
    x, t, x_cond, mask = (torch.from_numpy(a) for a in _inputs(seed=2))
    with torch.no_grad():
        ref, low = fp32(x, t, x_cond, mask), bf16(x, t, x_cond, mask)
    assert low.dtype == torch.float32 and torch.isfinite(low).all()
    # bf16 keeps ~3 significant digits; two layers of rounded activations
    assert (low - ref).abs().max() <= 5e-2 * ref.abs().max()
