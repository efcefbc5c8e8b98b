"""dopri5 and the whole sampling slice: the port against the JAX package on
the CPU.

Both sides get the same numpy inputs and, for the DiT solves, the same
weights (JAX params converted with ``lam_slide_tpu_torch.convert``). The JAX
kernels of the slice run in interpret mode: the QKNorm + RoPE flash kernel
through ``LAM_SLIDE_KERNEL_NORMROPE=1``, the AdaLN, spatial-block and MLP
kernels through their ``FORCE_KERNEL`` flags.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_slide_tpu.models import LatentDiT as JLatentDiT
from lam_slide_tpu.ops import fused_adaln as jad
from lam_slide_tpu.ops import fused_mlp as jfm
from lam_slide_tpu.ops import fused_spatial_block as jsb
from lam_slide_tpu.transport import Sampler as JSampler
from lam_slide_tpu.transport import create_transport as j_create_transport
from lam_slide_tpu.transport import integrators as jint
from lam_slide_tpu_torch.convert import latent_dit_state_dict_from_jax
from lam_slide_tpu_torch.models import LatentDiT
from lam_slide_tpu_torch.transport import Sampler, create_transport
from lam_slide_tpu_torch.transport import integrators as tint

# x within LINEAR_REL of max |x| on the linear ODE: fp32 on both sides, the
# stage sums taken in another order and XLA contracting t + dt*c into one
# FMA move each step's end by a few fp32 ulps.
LINEAR_REL = 1e-4
# The DiT's GVP data drift divides by sigma_t^2 (~2.5e-6 at t1 = 0.999), so
# those ulps grow along the solve, and the controller's accept/reject where
# the error ratio is near 1 flips on them. Measured on the small DiT below:
# the port against JAX ends 8.8e-5 of max |x| apart with 26 against 25
# attempted steps (16 accepted on both); the port against itself with only
# its stage times rounded once instead of twice ends 8.3e-4 apart with 25
# attempted (16 accepted). Limits: the end within 1e-3 of max |x|, the
# accepted steps within 1 and the attempted steps within 10%.
DIT_REL = 1e-3


def _assert_solve_close(got, want, rel):
    got, want = got.numpy(), np.asarray(want)
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("rtol,atol", [(1e-3, 1e-6), (1e-6, 1e-9)])
def test_dopri5_matches_jax_on_a_linear_ode(rtol, atol):
    """dx/dt = A x + t, stiff enough to reject steps: the same accepted and
    rejected steps, the same end."""
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((5, 5)) - 20 * np.eye(5)).astype(np.float32)
    x0 = rng.standard_normal((3, 5)).astype(np.float32)

    def jdrift(x, t):
        return x @ jnp.asarray(a).T + t[:, None]

    def tdrift(x, t):
        return x @ torch.from_numpy(a).T + t[:, None]

    want, (jn, jacc) = jint.ode_dopri5(jdrift, jnp.asarray(x0), 0.0, 2.0, rtol=rtol, atol=atol,
                                        return_stats=True)
    got, (n, acc) = tint.ode_dopri5(tdrift, torch.from_numpy(x0), 0.0, 2.0, rtol=rtol,
                                    atol=atol, return_stats=True)
    assert (n, acc) == (int(jn), int(jacc))
    assert n > acc  # the controller rejected some steps: the comparison is not vacuous
    _assert_solve_close(got, want, LINEAR_REL)


def test_dopri5_stops_at_max_steps():
    x0 = torch.ones(2, 3)
    _, (n, acc) = tint.ode_dopri5(lambda x, t: -50.0 * x, x0, 0.0, 1.0, rtol=1e-9, atol=1e-12,
                                  max_steps=5, return_stats=True)
    assert n == 5 and acc <= 5


CFG = dict(depth=2, in_dim=6, hidden_size=48, num_heads=4, mlp_ratio=2)
B, T, L = 2, 20, 2


def _dit_inputs(seed, t_len=T):
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((B, t_len, L, CFG["in_dim"])).astype(np.float32)
    mask = np.zeros((B, t_len, L), np.int32)
    mask[:, :1] = 1
    return noise, np.zeros_like(noise), mask


def _solve_both(jmodel, variables, port, noise, x_cond, mask):
    jt = j_create_transport(path_type="GVP", prediction="data")
    jsample = JSampler(jt).sample_ode(return_stats=True)  # dopri5 by default
    want, (jn, jacc) = jsample(
        None, jnp.asarray(noise), lambda xt, t, **kw: jmodel.apply(variables, xt, t, **kw),
        x_cond=jnp.asarray(x_cond), x_cond_mask=jnp.asarray(mask))
    tsample = Sampler(create_transport(path_type="GVP", prediction="data")).sample_ode(
        return_stats=True)
    with torch.no_grad():
        got, (n, acc) = tsample(torch.from_numpy(noise), port, x_cond=torch.from_numpy(x_cond),
                                x_cond_mask=torch.from_numpy(mask))
    assert got.shape == noise.shape and torch.isfinite(got).all()
    assert abs(acc - int(jacc)) <= 1 and abs(n - int(jn)) <= 0.1 * int(jn)
    _assert_solve_close(got, want, DIT_REL)


def _jax_and_port(cfg, inputs, **port_kw):
    noise, x_cond, mask = inputs
    jmodel = JLatentDiT(**cfg, reference_init=False)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(noise), jnp.zeros((B,)),
                            jnp.asarray(x_cond), jnp.asarray(mask))
    port = LatentDiT(**cfg, reference_init=False, device="cpu", **port_kw)
    port.load_state_dict(latent_dit_state_dict_from_jax(
        jax.tree.map(np.asarray, variables["params"])))
    return jmodel, variables, port


def test_dopri5_dit_gvp_data_solve_matches_jax():
    """The 4AA protocol's sampler (dopri5, atol 1e-6, rtol 1e-3, the defaults)
    on a small DiT's GVP data drift."""
    inputs = _dit_inputs(1)
    jmodel, variables, port = _jax_and_port(CFG, inputs)
    _solve_both(jmodel, variables, port, *inputs)


def test_slice_with_jax_kernels_matches_port(monkeypatch):
    """The slice as a whole at dh 128 (1 head, hidden 128, depth 2, T=40,
    L=2): the JAX DiT with its QKNorm + RoPE flash, AdaLN, spatial-block and
    MLP kernels engaged against the port's CPU path, one forward (within
    3e-5: fp32 on both sides, sums in another order) and one dopri5 solve."""
    monkeypatch.setenv("LAM_SLIDE_KERNEL_NORMROPE", "1")
    for mod in (jad, jsb, jfm):
        monkeypatch.setattr(mod, "FORCE_KERNEL", True)
    cfg = dict(depth=2, in_dim=6, hidden_size=128, num_heads=1, mlp_ratio=2)
    noise, x_cond, mask = inputs = _dit_inputs(2, t_len=40)
    jmodel, variables, port = _jax_and_port(cfg, inputs)
    t = np.array([0.3, 0.7], np.float32)
    want = jmodel.apply(variables, *(jnp.asarray(a) for a in (noise, t, x_cond, mask)))
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in (noise, t, x_cond, mask)))
    assert np.abs(np.asarray(want)).max() > 0.1  # not a vacuous match
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=3e-5)
    _solve_both(jmodel, variables, port, *inputs)
