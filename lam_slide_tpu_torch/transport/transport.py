"""Stochastic-interpolant transport: training objective and ODE sampler
(PyTorch port).

Counterpart of ``lam_slide_tpu/transport/transport.py``: the four model
parametrizations (NOISE/SCORE/VELOCITY/DATA), the three loss weightings,
the integration interval, the interpolant draw and training loss, and the
probability-flow drift with the ODE sampler (dopri5, the default, and
fixed-grid euler/heun). Random draws come from an explicit
``torch.Generator``. The SDE and likelihood samplers are not ported yet.
"""

import enum
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from lam_slide_tpu_torch.nn.losses import mean_flat
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
        x0 = torch.randn(x1.shape, generator=generator, dtype=x1.dtype, device=x1.device)
        t0, t1 = self.check_interval(self.train_eps, self.sample_eps)
        t = torch.rand((x1.shape[0],), generator=generator, dtype=torch.float32,
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


class Sampler:
    """Sampler factory over a Transport (transport.py:229-503); ODE only."""

    def __init__(self, transport: Transport):
        self.transport = transport
        self.drift = transport.get_drift()

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

    def get_sample_fn(self, sampling_method: str = "ODE",
                      sampling_kwargs: Optional[Dict[str, Any]] = None) -> Callable:
        """Dispatch with the reference's default kwargs (transport.py:475-503);
        ODE only."""
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
