"""Stochastic-interpolant transport and its ODE sampler (PyTorch port).

Counterpart of ``lam_slide_tpu/transport/transport.py``: the four model
parametrizations (NOISE/SCORE/VELOCITY/DATA), the integration interval and
the probability-flow drift, with the ODE sampler (dopri5, the default, and
fixed-grid euler/heun). Training losses, the SDE and likelihood samplers are
not ported yet.
"""

import enum
from dataclasses import dataclass
from typing import Callable, Optional

import torch

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

        def _sample(init, model_fn, **kw):
            def f(x, t):
                return drift(x, t, model_fn, **kw)

            if method == "dopri5":
                return integrators.ode_dopri5(f, init, t0, t1, rtol=rtol, atol=atol,
                                              return_stats=return_stats)
            return integrators.ode_fixed(f, init, t0, t1, num_steps, method=method)

        return _sample


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
