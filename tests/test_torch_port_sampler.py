"""The port's transport and ODE sampler vs the JAX package (CPU, fp32).

Both sides get the same noise (made with numpy) and, for the solves, the
same DiT weights (JAX params converted with ``lam_slide_tpu_torch.convert``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_slide_tpu.models import LatentDiT as JLatentDiT
from lam_slide_tpu.transport import Sampler as JSampler
from lam_slide_tpu.transport import create_transport as j_create_transport
from lam_slide_tpu_torch.convert import latent_dit_state_dict_from_jax
from lam_slide_tpu_torch.models import LatentDiT
from lam_slide_tpu_torch.transport import Sampler, create_transport

CFG = dict(depth=2, in_dim=6, hidden_size=48, num_heads=4, mlp_ratio=2)
B, T, L = 2, 20, 2
PATHS = ("Linear", "GVP", "VP")
PREDICTIONS = ("velocity", "noise", "score", "data")


@pytest.mark.parametrize("path_type", PATHS)
@pytest.mark.parametrize("prediction", PREDICTIONS)
def test_transport_interval_and_drift_match(path_type, prediction):
    jt = j_create_transport(path_type=path_type, prediction=prediction)
    tt = create_transport(path_type=path_type, prediction=prediction)
    assert (tt.train_eps, tt.sample_eps) == (jt.train_eps, jt.sample_eps)
    assert tt.model_type.name == jt.model_type.name
    for kw in (dict(eval=True), dict(eval=True, reverse=True), dict(eval=False)):
        assert tt.check_interval(tt.train_eps, tt.sample_eps, **kw) == \
            jt.check_interval(jt.train_eps, jt.sample_eps, **kw)

    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4, 5)).astype(np.float32)
    t = rng.uniform(0.05, 0.95, size=(3,)).astype(np.float32)
    want = jt.get_drift()(jnp.asarray(x), jnp.asarray(t), lambda x, t: jnp.sin(x) * t[:, None, None])
    got = tt.get_drift()(torch.from_numpy(x), torch.from_numpy(t),
                         lambda x, t: torch.sin(x) * t[:, None, None])
    # fp32 elementwise path math; VP's exp/sqrt chain differs by a few ulp
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, T, L, CFG["in_dim"])).astype(np.float32)
    mask = np.zeros((B, T, L), np.int32)
    mask[:, :1] = 1
    jmodel = JLatentDiT(**CFG, reference_init=False)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.zeros((B,)),
                            jnp.zeros_like(jnp.asarray(x)), jnp.asarray(mask))
    port = LatentDiT(**CFG, reference_init=False, device="cpu")
    port.load_state_dict(latent_dit_state_dict_from_jax(
        jax.tree.map(np.asarray, variables["params"])))
    return jmodel, variables, port, x, mask


@pytest.mark.parametrize("method,num_steps", [("euler", 10), ("heun", 5)])
def test_ode_solve_matches_jax(models, method, num_steps):
    """GVP data-prediction probability-flow solve, as bench.py's build_solver."""
    jmodel, variables, port, noise, mask = models
    x_cond = np.zeros_like(noise)
    jt = j_create_transport(path_type="GVP", prediction="data")
    jsample = JSampler(jt).sample_ode(sampling_method=method, num_steps=num_steps)
    want = jsample(None, jnp.asarray(noise), lambda xt, t, **kw: jmodel.apply(variables, xt, t, **kw),
                   x_cond=jnp.asarray(x_cond), x_cond_mask=jnp.asarray(mask))
    tsample = Sampler(create_transport(path_type="GVP", prediction="data")).sample_ode(
        sampling_method=method, num_steps=num_steps)
    with torch.no_grad():
        got = tsample(torch.from_numpy(noise), port, x_cond=torch.from_numpy(x_cond),
                      x_cond_mask=torch.from_numpy(mask))
    assert got.shape == noise.shape and torch.isfinite(got).all()
    # fp32 on both sides; Heun's last stage evaluates the data drift at
    # t1 = 1 - 1e-3, where it divides by sigma_t^2 ~ 2.5e-6, so outputs
    # reach O(40) and fp32 differences scale with them: held to 1e-5 of the
    # largest output (measured 1.4e-4 abs at max 43 for Heun, 5e-7 for Euler)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max() + 1e-6


def test_sampler_refuses_unported_methods():
    """dopri5, euler and heun are the JAX package's ODE methods; any other
    name raises, as it does there."""
    sampler = Sampler(create_transport(path_type="GVP", prediction="data"))
    with pytest.raises(NotImplementedError):
        sampler.sample_ode(sampling_method="midpoint")
