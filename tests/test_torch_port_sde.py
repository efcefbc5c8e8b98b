"""The port's SDE sampler, Hutchinson likelihood solve, score and prior
against the JAX package and the reference golden (CPU, fp32).

The port draws its noise from a ``torch.Generator``; the JAX side gets the
same numbers by replacing ``jax.random.normal`` / ``jax.random.randint``
within each test with draws from an identically seeded generator, in the
same order and shapes. ``jax.disable_jit()`` makes the JAX integrators'
``lax.scan`` run step by step, so the replacement is called once per step.
Nothing in the JAX package changes.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_slide_tpu.models import LatentDiT as JLatentDiT
from lam_slide_tpu.transport import Sampler as JSampler
from lam_slide_tpu.transport import create_transport as j_create_transport
from lam_slide_tpu.transport import integrators as jint
from lam_slide_tpu.transport.path import ICPlan as JICPlan
from lam_slide_tpu_torch.convert import latent_dit_state_dict_from_jax
from lam_slide_tpu_torch.models import LatentDiT
from lam_slide_tpu_torch.transport import Sampler, create_transport
from lam_slide_tpu_torch.transport import integrators as tint
from lam_slide_tpu_torch.transport.path import GVPCPlan, ICPlan, VPCPlan

G = np.load(os.path.join(os.path.dirname(__file__), "golden", "transport_golden.npz"))
PLANS = {"gvp": GVPCPlan(), "linear": ICPlan(), "vp": VPCPlan()}
PATHS = ("Linear", "GVP", "VP")
PREDICTIONS = ("velocity", "noise", "score", "data")
SHAPE = (3, 4, 5)
# fp32 on both sides with the same noise; the drifts divide by sigma_t^2
# near the ends of the interval, so outputs reach O(10-100) and fp32
# differences in the order of the elementwise path math scale with them:
# held to REL of the largest output.
REL = 2e-5


def _close(got, want, rel=REL):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max() + 1e-6, \
        (np.abs(got - want).max(), np.abs(want).max())


def _toy(lib):
    """A smooth, t-dependent model head: the same function on both sides."""
    if lib == "jax":
        return lambda x, t, **kw: jnp.sin(x) * t[:, None, None] + 0.1 * x
    return lambda x, t, **kw: torch.sin(x) * t[:, None, None] + 0.1 * x


def _inject(monkeypatch, seed):
    """jax.random.normal / randint draw what torch.randn / randint draw from
    a generator seeded with ``seed``; returns that generator's twin for the
    port."""
    g = torch.Generator().manual_seed(seed)

    def normal(key, shape, dtype=jnp.float32):
        return jnp.asarray(torch.randn(tuple(shape), generator=g).numpy(), dtype)

    def randint(key, shape, minval, maxval, dtype=jnp.int32):
        return jnp.asarray(torch.randint(minval, maxval, tuple(shape), generator=g).numpy(), dtype)

    monkeypatch.setattr(jax.random, "normal", normal)
    monkeypatch.setattr(jax.random, "randint", randint)
    return torch.Generator().manual_seed(seed)


def _x0(seed=0):
    return np.random.default_rng(seed).standard_normal(SHAPE).astype(np.float32)


@pytest.mark.parametrize("method", ["euler", "heun"])
@pytest.mark.parametrize("form", ["constant", "linear"])
def test_sde_fixed_matches_jax(monkeypatch, method, form):
    x0 = _x0(1)
    jplan, tplan = JICPlan(), ICPlan()
    gen = _inject(monkeypatch, 11)
    with jax.disable_jit():
        want = jint.sde_fixed(jax.random.PRNGKey(0), lambda x, t: jnp.cos(x) * t[:, None, None],
                              lambda x, t: jplan.compute_diffusion(x, t, form=form, norm=0.5),
                              jnp.asarray(x0), 0.05, 0.9, 7, method=method)
    got = tint.sde_fixed(lambda x, t: torch.cos(x) * t[:, None, None],
                         lambda x, t: tplan.compute_diffusion(x, t, form=form, norm=0.5),
                         torch.from_numpy(x0), 0.05, 0.9, 7, method=method, generator=gen)
    _close(got, want)


@pytest.mark.parametrize("path_type", PATHS)
@pytest.mark.parametrize("prediction", PREDICTIONS)
def test_sde_sample_fn_defaults_match_jax(monkeypatch, path_type, prediction):
    """get_sample_fn("SDE") with the reference's defaults (Euler–Maruyama,
    the linear diffusion, the Mean last step), fewer steps."""
    x0 = _x0(2)
    gen = _inject(monkeypatch, 12)
    kw = {"num_steps": 8}
    with jax.disable_jit():
        want = JSampler(j_create_transport(path_type=path_type, prediction=prediction)) \
            .get_sample_fn("SDE", kw)(jax.random.PRNGKey(0), jnp.asarray(x0), _toy("jax"))
    got = Sampler(create_transport(path_type=path_type, prediction=prediction)) \
        .get_sample_fn("SDE", kw)(gen, torch.from_numpy(x0), _toy("torch"))
    assert torch.isfinite(got).all()
    _close(got, want)


@pytest.mark.parametrize("method", ["Euler", "Heun"])
@pytest.mark.parametrize("last_step", ["Mean", "Tweedie", "Euler", None])
def test_sde_last_steps_and_methods_match_jax(monkeypatch, method, last_step):
    x0 = _x0(3)
    gen = _inject(monkeypatch, 13)
    kw = dict(sampling_method=method, diffusion_form="sigma", diffusion_norm=0.7,
              last_step=last_step, last_step_size=0.05, num_steps=6)
    with jax.disable_jit():
        want = JSampler(j_create_transport(path_type="GVP", prediction="data")) \
            .sample_sde(**kw)(jax.random.PRNGKey(0), jnp.asarray(x0), _toy("jax"))
    got = Sampler(create_transport(path_type="GVP", prediction="data")) \
        .sample_sde(**kw)(gen, torch.from_numpy(x0), _toy("torch"))
    _close(got, want)


def test_sde_noise_comes_from_the_generator():
    sample = Sampler(create_transport(path_type="GVP", prediction="data")).get_sample_fn(
        "SDE", {"num_steps": 5})
    x0 = torch.from_numpy(_x0(4))

    def run(seed):
        return sample(torch.Generator().manual_seed(seed), x0, _toy("torch"))

    torch.testing.assert_close(run(0), run(0), atol=0, rtol=0)
    assert not torch.allclose(run(0), run(1))
    with pytest.raises(NotImplementedError):
        Sampler(create_transport()).sample_sde(sampling_method="midpoint")


def test_hutchinson_logp_drift_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    eps = np.where(rng.random(SHAPE) < 0.5, -1.0, 1.0).astype(np.float32)
    t = np.array([0.2, 0.5, 0.8], np.float32)
    w = rng.standard_normal((5, 5)).astype(np.float32)
    want = jint.hutchinson_logp_drift(lambda y, tv: jnp.tanh(y @ w) * tv[:, None, None],
                                      jnp.asarray(x), jnp.asarray(t), jnp.asarray(eps))
    tw = torch.from_numpy(w)
    got = tint.hutchinson_logp_drift(lambda y, tv: torch.tanh(y @ tw) * tv[:, None, None],
                                     torch.from_numpy(x), torch.from_numpy(t),
                                     torch.from_numpy(eps))
    for a, b in zip(got, want):
        assert not a.requires_grad
        _close(a, b, 1e-6)


# VP with a data or noise head divides by a vanishing sigma at the end of
# the reversed interval and gives NaN in both packages; VP is held to the
# velocity and score heads
@pytest.mark.parametrize("path_type,prediction", [
    ("Linear", "velocity"), ("Linear", "data"), ("GVP", "velocity"), ("GVP", "data"),
    ("VP", "velocity"), ("VP", "score")])
def test_likelihood_matches_jax(monkeypatch, path_type, prediction):
    x = _x0(6)
    gen = _inject(monkeypatch, 14)
    with jax.disable_jit():
        jfn = JSampler(j_create_transport(path_type=path_type, prediction=prediction)) \
            .sample_ode_likelihood(num_steps=12)
        want_logp, want_z = jfn(jax.random.PRNGKey(0), jnp.asarray(x), _toy("jax"))
    got_logp, got_z = Sampler(create_transport(path_type=path_type, prediction=prediction)) \
        .sample_ode_likelihood(num_steps=12)(gen, torch.from_numpy(x), _toy("torch"))
    assert got_logp.shape == (SHAPE[0],) and got_logp.dtype == torch.float32
    _close(got_z, want_z)
    _close(got_logp, want_logp)


def test_likelihood_refuses_other_methods():
    with pytest.raises(NotImplementedError):
        Sampler(create_transport()).sample_ode_likelihood(sampling_method="heun")


@pytest.fixture(scope="module")
def dit():
    cfg = dict(depth=2, in_dim=6, hidden_size=48, num_heads=4, mlp_ratio=2)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 12, 2, 6)).astype(np.float32)
    mask = np.zeros((2, 12, 2), np.int32)
    mask[:, :1] = 1
    jmodel = JLatentDiT(**cfg, reference_init=False)
    variables = jmodel.init(jax.random.PRNGKey(7), jnp.asarray(x), jnp.zeros((2,)),
                            jnp.asarray(x), jnp.asarray(mask))
    port = LatentDiT(**cfg, reference_init=False, device="cpu")
    port.load_state_dict(latent_dit_state_dict_from_jax(
        jax.tree.map(np.asarray, variables["params"])))
    return jmodel, variables, port, x, mask


@pytest.mark.parametrize("solve", ["sde", "likelihood"])
def test_dit_solves_match_jax(monkeypatch, dit, solve):
    """The GVP data-prediction SDE solve and the likelihood solve (the DiT's
    VJP at every step) on converted DiT weights, as chip_smoke.py runs them
    at full width, with fewer steps."""
    jmodel, variables, port, x, mask = dit
    x_cond = x * mask[..., None]
    gen = _inject(monkeypatch, 15)
    jt, tt = (j_create_transport(path_type="GVP", prediction="data"),
              create_transport(path_type="GVP", prediction="data"))
    jkw = dict(x_cond=jnp.asarray(x_cond), x_cond_mask=jnp.asarray(mask))
    tkw = dict(x_cond=torch.from_numpy(x_cond), x_cond_mask=torch.from_numpy(mask))

    def jmodel_fn(xt, t, **kw):
        return jmodel.apply(variables, xt, t, **kw)

    with jax.disable_jit():
        if solve == "sde":
            want = JSampler(jt).get_sample_fn("SDE", {"num_steps": 4})(
                jax.random.PRNGKey(0), jnp.asarray(x), jmodel_fn, **jkw)
        else:
            want = JSampler(jt).sample_ode_likelihood(num_steps=4)(
                jax.random.PRNGKey(0), jnp.asarray(x), jmodel_fn, **jkw)
    if solve == "sde":
        got = Sampler(tt).get_sample_fn("SDE", {"num_steps": 4})(gen, torch.from_numpy(x), port,
                                                                  **tkw)
        _close(got, want, 1e-4)
    else:
        got = Sampler(tt).sample_ode_likelihood(num_steps=4)(gen, torch.from_numpy(x), port,
                                                             **tkw)
        for a, b in zip(got, want):
            _close(a, b, 1e-4)
    assert not any(p.grad is not None for p in port.parameters())


def test_prior_logp_matches_jax_and_the_normal_density():
    z = np.random.default_rng(8).standard_normal((4, 3, 2, 5)).astype(np.float32)
    want = j_create_transport().prior_logp(jnp.asarray(z))
    got = create_transport().prior_logp(torch.from_numpy(z))
    _close(got, want, 1e-6)
    flat = z.reshape(4, -1).astype(np.float64)
    dens = -0.5 * flat.shape[1] * math.log(2 * math.pi) - 0.5 * (flat ** 2).sum(1)
    np.testing.assert_allclose(got.numpy(), dens, rtol=1e-6)


@pytest.mark.parametrize("name,path_type,prediction,key", [
    ("gvp", "GVP", "data", "score_from_data"), ("linear", "Linear", "data", "score_from_data"),
    ("gvp", "GVP", "velocity", "score_from_velocity"),
    ("linear", "Linear", "velocity", "score_from_velocity"),
    ("vp", "VP", "velocity", "score_from_velocity"),
])
def test_score_matches_golden(name, path_type, prediction, key):
    """get_score of the DATA and VELOCITY heads against the reference's
    score conversions (the golden is float64; the path math runs fp32, the
    limit tests/test_transport_parity.py holds the JAX package to)."""
    head = G["x1"] if prediction == "data" else G[f"{name}.ut"]
    score = create_transport(path_type=path_type, prediction=prediction).get_score()
    got = score(torch.from_numpy(G[f"{name}.xt"]).float(), torch.from_numpy(G["t"]).float(),
                lambda x, t: torch.from_numpy(head).float())
    np.testing.assert_allclose(got.numpy(), G[f"{name}.{key}"], atol=1e-4)


@pytest.mark.parametrize("path_type", PATHS)
@pytest.mark.parametrize("prediction", PREDICTIONS)
def test_score_matches_jax(path_type, prediction):
    x = _x0(9)
    t = np.array([0.2, 0.5, 0.8], np.float32)
    want = j_create_transport(path_type=path_type, prediction=prediction).get_score()(
        jnp.asarray(x), jnp.asarray(t), _toy("jax"))
    got = create_transport(path_type=path_type, prediction=prediction).get_score()(
        torch.from_numpy(x), torch.from_numpy(t), _toy("torch"))
    _close(got, want)


@pytest.mark.parametrize("name", ["gvp", "linear", "vp"])
@pytest.mark.parametrize("form", ["constant", "SBDM", "sigma", "linear", "decreasing"])
def test_diffusion_forms_match_golden(name, form):
    diff = PLANS[name].compute_diffusion(torch.from_numpy(G[f"{name}.xt"]).float(),
                                         torch.from_numpy(G["t"]).float(), form=form, norm=1.7)
    np.testing.assert_allclose(np.broadcast_to(diff.numpy(), G[f"{name}.diff.{form}"].shape),
                               G[f"{name}.diff.{form}"], atol=1e-5)
