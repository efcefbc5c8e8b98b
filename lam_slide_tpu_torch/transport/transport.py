"""Stochastic-interpolant transport: training objective and samplers
(PyTorch port).

Counterpart of ``lam_slide_tpu/transport/transport.py``: the four model
parametrizations (NOISE/SCORE/VELOCITY/DATA), the three loss weightings,
the integration interval, the interpolant draw and training loss, the
probability-flow drift and the score, the prior log density, and the three
samplers: the ODE sampler (dopri5, the default, and fixed-grid
euler/heun), the SDE sampler (Euler–Maruyama or Heun with a last
deterministic step) and the Hutchinson likelihood solve. Random draws come
from an explicit ``torch.Generator``.
"""

import enum
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from lam_slide_tpu_torch.nn.losses import mean_flat
from lam_slide_tpu_torch.parallel import rows as batch_rows
from lam_slide_tpu_torch.transport import integrators
from lam_slide_tpu_torch.transport.path import GVPCPlan, ICPlan, VPCPlan, expand_t


class ModelType(enum.Enum):
    NOISE = enum.auto()
    SCORE = enum.auto()
    VELOCITY = enum.auto()
    DATA = enum.auto()


class PathType(enum.Enum):
    LINEAR = enum.auto()
    GVP = enum.auto()
    VP = enum.auto()


class WeightType(enum.Enum):
    NONE = enum.auto()
    VELOCITY = enum.auto()
    LIKELIHOOD = enum.auto()


_PATHS = {PathType.LINEAR: ICPlan, PathType.GVP: GVPCPlan, PathType.VP: VPCPlan}


@dataclass(frozen=True)
class Transport:
    """Interpolant sampling state (transport.py:39-226)."""

    model_type: ModelType
    path_type: PathType
    loss_type: WeightType
    train_eps: float
    sample_eps: float

    @property
    def path_sampler(self):
        return _PATHS[self.path_type]()

    def prior_logp(self, z: torch.Tensor) -> torch.Tensor:
        """Standard-normal log density of each batch element (transport.py:65-69)."""
        n = z[0].numel()
        flat = z.reshape(z.shape[0], -1)
        return -n / 2.0 * math.log(2 * math.pi) - (flat ** 2).sum(dim=1) / 2.0

    def check_interval(self, train_eps: float, sample_eps: float, *,
                       diffusion_form: str = "SBDM", sde: bool = False,
                       reverse: bool = False, eval: bool = False,
                       last_step_size: float = 0.0):
        """Integration interval [t0, t1] avoiding endpoint singularities (transport.py:69-101)."""
        t0, t1 = 0.0, 1.0
        eps = train_eps if not eval else sample_eps
        if self.path_type == PathType.VP:
            t1 = 1.0 - eps if (not sde or last_step_size == 0) else 1.0 - last_step_size
        elif self.path_type in (PathType.LINEAR, PathType.GVP) and (
                self.model_type != ModelType.VELOCITY or sde):
            t0 = (eps if (diffusion_form == "SBDM" and sde)
                  or self.model_type != ModelType.VELOCITY else 0.0)
            t1 = 1.0 - eps if (not sde or last_step_size == 0) else 1.0 - last_step_size
        if reverse:
            t0, t1 = 1.0 - t0, 1.0 - t1
        return t0, t1

    def sample(self, x1: torch.Tensor, generator: torch.Generator):
        """Draw x0 ~ N(0, I), then t ~ U(t0, t1) per batch element
        (transport.py:103-114) -> (t, x0, x1)."""
        x0 = batch_rows.randn(x1.shape, generator, dtype=x1.dtype, device=x1.device)
        t0, t1 = self.check_interval(self.train_eps, self.sample_eps)
        t = batch_rows.rand((x1.shape[0],), generator, dtype=torch.float32,
                       device=x1.device) * (t1 - t0) + t0
        return t, x0, x1

    def training_losses(self, model_fn: Callable, x1: torch.Tensor,
                        model_kwargs: Optional[Dict[str, Any]] = None, *,
                        generator: Optional[torch.Generator] = None,
                        t: Optional[torch.Tensor] = None,
                        x0: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Interpolant loss (transport.py:116-156) -> {'loss': [B], 'pred': ...}.

        t and x0 are drawn from ``generator`` unless both are given, which
        replays given draws (those of the JAX package, in the parity tests).
        """
        model_kwargs = model_kwargs or {}
        if t is None or x0 is None:
            t, x0, x1 = self.sample(x1, generator)
        path = self.path_sampler
        t, xt, ut = path.plan(t, x0, x1)
        model_output = model_fn(xt, t, **model_kwargs)
        if model_output.shape != xt.shape:
            raise ValueError(f"model output {tuple(model_output.shape)} != x_t "
                             f"{tuple(xt.shape)}")

        terms = {"pred": model_output}
        if self.model_type == ModelType.VELOCITY:
            terms["loss"] = mean_flat((model_output - ut) ** 2)
        elif self.model_type == ModelType.DATA:
            terms["loss"] = mean_flat((model_output - x1) ** 2)
        else:
            _, drift_var = path.compute_drift(xt, t)
            sigma_t, _ = path.compute_sigma_t(expand_t(t, xt))
            if self.loss_type == WeightType.VELOCITY:
                weight = (drift_var / sigma_t) ** 2
            elif self.loss_type == WeightType.LIKELIHOOD:
                weight = drift_var / (sigma_t ** 2)
            else:
                weight = 1.0
            if self.model_type == ModelType.NOISE:
                terms["loss"] = mean_flat(weight * (model_output - x0) ** 2)
            else:
                terms["loss"] = mean_flat(weight * (model_output * sigma_t + x0) ** 2)
        return terms

    def get_drift(self) -> Callable:
        """Probability-flow ODE drift (transport.py:158-202)."""
        path = self.path_sampler

        def score_ode(x, t, model_fn, **kw):
            drift_mean, drift_var = path.compute_drift(x, t)
            return -drift_mean + drift_var * model_fn(x, t, **kw)

        def noise_ode(x, t, model_fn, **kw):
            drift_mean, drift_var = path.compute_drift(x, t)
            sigma_t, _ = path.compute_sigma_t(expand_t(t, x))
            score = model_fn(x, t, **kw) / -sigma_t
            return -drift_mean + drift_var * score

        def velocity_ode(x, t, model_fn, **kw):
            return model_fn(x, t, **kw)

        def data_ode(x, t, model_fn, **kw):
            # The reference's DATA extension (transport.py:177-184).
            drift_mean, drift_var = path.compute_drift(x, t)
            sigma_t, _ = path.compute_sigma_t(expand_t(t, x))
            alpha_t, _ = path.compute_alpha_t(expand_t(t, x))
            score = -(1.0 / sigma_t ** 2) * (x - alpha_t * model_fn(x, t, **kw))
            return -drift_mean + drift_var * score

        return {
            ModelType.NOISE: noise_ode,
            ModelType.SCORE: score_ode,
            ModelType.VELOCITY: velocity_ode,
            ModelType.DATA: data_ode,
        }[self.model_type]

    def get_score(self) -> Callable:
        """Score of x_t = alpha_t x1 + sigma_t x0 from the model head
        (transport.py:176-187)."""
        path = self.path_sampler
        if self.model_type == ModelType.NOISE:
            return lambda x, t, m, **kw: m(x, t, **kw) / -path.compute_sigma_t(expand_t(t, x))[0]
        if self.model_type == ModelType.SCORE:
            return lambda x, t, m, **kw: m(x, t, **kw)
        if self.model_type == ModelType.VELOCITY:
            return lambda x, t, m, **kw: path.get_score_from_velocity(m(x, t, **kw), x, t)
        return lambda x, t, m, **kw: path.get_score_from_data(m(x, t, **kw), x, t)


class Sampler:
    """Sampler factory over a Transport (transport.py:190-390)."""

    def __init__(self, transport: Transport):
        self.transport = transport
        self.drift = transport.get_drift()
        self.score = transport.get_score()

    def _sde_drift_diffusion(self, diffusion_form: str, diffusion_norm: float):
        """(drift + diffusion * score, diffusion) of the reverse SDE
        (transport.py:198-209)."""
        path = self.transport.path_sampler

        def diffusion_fn(x, t):
            return path.compute_diffusion(x, t, form=diffusion_form, norm=diffusion_norm)

        def sde_drift(x, t, model_fn, **kw):
            return (self.drift(x, t, model_fn, **kw)
                    + diffusion_fn(x, t) * self.score(x, t, model_fn, **kw))

        return sde_drift, diffusion_fn

    def _last_step_fn(self, sde_drift, last_step: Optional[str], last_step_size: float):
        """The SDE solve's last deterministic step (transport.py:211-227)."""
        path = self.transport.path_sampler
        if last_step is None:
            return lambda x, t, m, **kw: x
        if last_step == "Mean":
            return lambda x, t, m, **kw: x + sde_drift(x, t, m, **kw) * last_step_size
        if last_step == "Tweedie":
            def tweedie(x, t, m, **kw):
                alpha = path.compute_alpha_t(t)[0][0]
                sigma = path.compute_sigma_t(t)[0][0]
                return x / alpha + (sigma ** 2) / alpha * self.score(x, t, m, **kw)

            return tweedie
        if last_step == "Euler":
            return lambda x, t, m, **kw: x + self.drift(x, t, m, **kw) * last_step_size
        raise NotImplementedError(f"last step {last_step!r}")

    def sample_sde(self, *, sampling_method: str = "Euler", diffusion_form: str = "SBDM",
                   diffusion_norm: float = 1.0, last_step: Optional[str] = "Mean",
                   last_step_size: float = 0.04, num_steps: int = 250) -> Callable:
        """SDE sample fn: (generator, init, model_fn, **kwargs) -> final x
        (transport.py:229-268): num_steps - 1 Euler–Maruyama or Heun steps
        over [t0, t1] with noise from ``generator``, then ``last_step`` at
        t1 (Mean, Tweedie, Euler or None)."""
        method = sampling_method.lower()
        if method not in ("euler", "heun"):
            raise NotImplementedError(f"SDE sampler {sampling_method!r}")
        if last_step is None:
            last_step_size = 0.0
        sde_drift, sde_diffusion = self._sde_drift_diffusion(diffusion_form, diffusion_norm)
        t0, t1 = self.transport.check_interval(
            self.transport.train_eps, self.transport.sample_eps, diffusion_form=diffusion_form,
            sde=True, eval=True, reverse=False, last_step_size=last_step_size)
        last_step_fn = self._last_step_fn(sde_drift, last_step, last_step_size)

        @torch.no_grad()  # the eval protocol never differentiates a solve
        def _sample(generator, init, model_fn, **kw):
            x = integrators.sde_fixed(lambda x, t: sde_drift(x, t, model_fn, **kw),
                                      sde_diffusion, init, t0, t1, num_steps, method=method,
                                      generator=generator)
            ts = torch.full((init.shape[0],), t1, dtype=torch.float32, device=init.device)
            return last_step_fn(x, ts, model_fn, **kw)

        return _sample

    def sample_ode(self, *, sampling_method: str = "dopri5", num_steps: int = 50,
                   atol: float = 1e-6, rtol: float = 1e-3, reverse: bool = False,
                   return_stats: bool = False) -> Callable:
        """ODE sample fn: (init, model_fn, **kwargs) -> final x (transport.py:270-312).

        The flow is deterministic given the init noise, so unlike the JAX
        version the returned function takes no RNG argument.
        ``return_stats=True`` (dopri5 only) returns ``(x, (n_iters,
        n_accepted))``: attempted and accepted steps, NFE = 1 + 6 * n_iters.
        """
        method = sampling_method.lower()
        if method not in ("dopri5", "euler", "heun"):
            raise NotImplementedError(f"ODE sampler {sampling_method!r}")
        if reverse:
            def drift(x, t, m, **kw):
                return self.drift(x, torch.ones_like(t) * (1 - t), m, **kw)
        else:
            drift = self.drift
        t0, t1 = self.transport.check_interval(
            self.transport.train_eps, self.transport.sample_eps, sde=False, eval=True,
            reverse=reverse, last_step_size=0.0)

        @torch.no_grad()  # the eval protocol never differentiates a solve
        def _sample(init, model_fn, **kw):
            def f(x, t):
                return drift(x, t, model_fn, **kw)

            if method == "dopri5":
                return integrators.ode_dopri5(f, init, t0, t1, rtol=rtol, atol=atol,
                                              return_stats=return_stats)
            return integrators.ode_fixed(f, init, t0, t1, num_steps, method=method)

        return _sample

    def sample_ode_likelihood(self, *, sampling_method: str = "euler", num_steps: int = 50,
                              atol: float = 1e-6, rtol: float = 1e-3) -> Callable:
        """Likelihood fn: (generator, x, model_fn, **kwargs) -> (logp,
        drift_final) (transport.py:314-361).

        Integrates the data back through the drift at time 1 - t with
        num_steps - 1 fixed-grid Euler steps, together with the Hutchinson
        estimate of the divergence (one drift VJP per step) at one Rademacher
        eps from ``generator``; logp is the prior log density of the end
        state less the integrated divergence. Like the JAX version, only
        Euler is implemented (atol and rtol are accepted and unused); any
        other method raises.
        """
        del atol, rtol
        if sampling_method.lower() != "euler":
            raise NotImplementedError(f"likelihood sampler {sampling_method!r}")
        t0, t1 = self.transport.check_interval(
            self.transport.train_eps, self.transport.sample_eps, sde=False, eval=True,
            reverse=False, last_step_size=0.0)

        def _sample(generator, x, model_fn, **kw):
            eps = (batch_rows.randint(0, 2, x.shape, generator, device=x.device)
                   .to(x.dtype) * 2.0 - 1.0)

            def drift_fn(y, t):
                return self.drift(y, torch.ones_like(t) * (1 - t), model_fn, **kw)

            ts = torch.linspace(t0, t1, num_steps, dtype=torch.float32)
            dts = ts[1:] - ts[:-1]
            y = x
            delta_logp = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
            for i in range(num_steps - 1):
                tv = torch.full((x.shape[0],), ts[i].item(), dtype=torch.float32,
                                device=x.device)
                dy, dlogp = integrators.hutchinson_logp_drift(drift_fn, y, tv, eps)
                dt = dts[i].item()
                y, delta_logp = y + dt * dy, delta_logp + dt * dlogp
            return self.transport.prior_logp(y) - delta_logp, y

        return _sample

    def get_sample_fn(self, sampling_method: str = "ODE",
                      sampling_kwargs: Optional[Dict[str, Any]] = None) -> Callable:
        """Dispatch with the reference's default kwargs (transport.py:363-390):
        "SDE" (Euler–Maruyama, the linear diffusion, the Mean last step of
        0.04, 250 steps) or "ODE" (dopri5, atol 1e-6, rtol 1e-3)."""
        if sampling_method == "SDE":
            kw = {"sampling_method": "Euler", "diffusion_form": "linear", "diffusion_norm": 1.0,
                  "last_step": "Mean", "last_step_size": 0.04, "num_steps": 250}
            kw.update(sampling_kwargs or {})
            return self.sample_sde(**kw)
        if sampling_method != "ODE":
            raise NotImplementedError(f"sampler {sampling_method!r}")
        kw = {"sampling_method": "dopri5", "num_steps": 50, "atol": 1e-6, "rtol": 1e-3,
              "reverse": False}
        kw.update(sampling_kwargs or {})
        return self.sample_ode(**kw)


def create_transport(path_type: str = "Linear", prediction: str = "velocity",
                     loss_weight: Optional[str] = None, train_eps: Optional[float] = None,
                     sample_eps: Optional[float] = None) -> Transport:
    """String-config factory with eps defaults (transport.py:392-426)."""
    model_type = {
        "noise": ModelType.NOISE,
        "score": ModelType.SCORE,
        "data": ModelType.DATA,
    }.get(prediction, ModelType.VELOCITY)
    loss_type = {
        "velocity": WeightType.VELOCITY,
        "likelihood": WeightType.LIKELIHOOD,
    }.get(loss_weight, WeightType.NONE)
    ptype = {"Linear": PathType.LINEAR, "GVP": PathType.GVP, "VP": PathType.VP}[path_type]

    if ptype == PathType.VP:
        train_eps = 1e-5 if train_eps is None else train_eps
        sample_eps = 1e-3 if sample_eps is None else sample_eps
    elif ptype in (PathType.GVP, PathType.LINEAR) and model_type != ModelType.VELOCITY:
        train_eps = 1e-3 if train_eps is None else train_eps
        sample_eps = 1e-3 if sample_eps is None else sample_eps
    else:
        train_eps = 0.0
        sample_eps = 0.0
    return Transport(model_type=model_type, path_type=ptype, loss_type=loss_type,
                     train_eps=train_eps, sample_eps=sample_eps)
