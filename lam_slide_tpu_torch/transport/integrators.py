"""ODE and SDE integrators (counterpart of
``lam_slide_tpu/transport/integrators.py``).

``drift_fn(x, t_vec)`` takes a [B] time vector like the reference model
closures. The JAX package scans the fixed-grid steps with ``lax.scan`` and
runs dopri5 under a bounded ``lax.while_loop``; here both are Python loops.
The SDE steps draw their noise from an explicit ``torch.Generator``, one
standard normal of x's shape per step, in step order; the Hutchinson
divergence estimate of the likelihood ODE takes the drift's VJP with
``torch.autograd.grad`` (JAX: ``jax.vjp``).
"""

from typing import Callable, Optional, Tuple

import torch

from lam_slide_tpu_torch.parallel import rows as batch_rows


def ode_fixed(drift_fn: Callable, x0: torch.Tensor, t0: float, t1: float,
              num_steps: int, method: str = "euler") -> torch.Tensor:
    """Fixed-grid ODE solve over linspace(t0, t1, num_steps): num_steps - 1
    steps, one drift evaluation each for euler and two for heun
    (integrators.py:30-54)."""
    if method not in ("euler", "heun"):
        raise ValueError(f"unknown fixed-grid method {method!r}")
    ts = torch.linspace(t0, t1, num_steps, dtype=torch.float32)
    dts = ts[1:] - ts[:-1]
    x = x0
    for i in range(num_steps - 1):
        t, dt = ts[i].item(), dts[i].item()
        tvec = torch.full((x.shape[0],), t, dtype=torch.float32, device=x.device)
        k1 = drift_fn(x, tvec)
        if method == "euler":
            x = x + dt * k1
            continue
        t_next = (ts[i] + dts[i]).item()
        k2 = drift_fn(x + dt * k1, torch.full_like(tvec, t_next))
        x = x + 0.5 * dt * (k1 + k2)
    return x


def sde_fixed(drift_fn: Callable, diffusion_fn: Callable, x0: torch.Tensor, t0: float,
              t1: float, num_steps: int, method: str = "euler",
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Fixed-grid SDE solve over linspace(t0, t1, num_steps): num_steps - 1
    steps of size ts[1] - ts[0] (integrators.py:57-99).

    Euler–Maruyama: x <- x + drift dt + sqrt(2 D) w sqrt(dt). Heun: the noise
    first, xhat = x + sqrt(2 D) w sqrt(dt), then a predictor/corrector step
    from xhat. w ~ N(0, I) of x's shape and dtype, one draw per step from
    ``generator``. Returns the state after the grid steps; the last
    deterministic step (Mean/Tweedie/Euler) is the Sampler's.
    """
    if method not in ("euler", "heun"):
        raise ValueError(f"unknown SDE method {method!r}")
    ts = torch.linspace(t0, t1, num_steps, dtype=torch.float32)
    dt = (ts[1] - ts[0]).item()
    sqrt_dt = torch.sqrt(ts[1] - ts[0]).item()
    x = x0
    for i in range(num_steps - 1):
        t = ts[i].item()
        w = batch_rows.randn(x.shape, generator, dtype=x.dtype, device=x.device)
        tvec = torch.full((x.shape[0],), t, dtype=torch.float32, device=x.device)
        diffusion = diffusion_fn(x, tvec)
        if method == "euler":
            x = x + drift_fn(x, tvec) * dt + torch.sqrt(2.0 * diffusion) * (w * sqrt_dt)
            continue
        xhat = x + torch.sqrt(2.0 * diffusion) * (w * sqrt_dt)
        k1 = drift_fn(xhat, tvec)
        k2 = drift_fn(xhat + dt * k1, torch.full_like(tvec, (ts[i] + (ts[1] - ts[0])).item()))
        x = xhat + 0.5 * dt * (k1 + k2)
    return x


def hutchinson_logp_drift(drift_fn: Callable, x: torch.Tensor, t: torch.Tensor,
                          eps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(-drift, eps^T (d drift / d x) eps per batch element) for likelihood
    ODEs (integrators.py:209-217): one forward of the drift and one VJP
    (``torch.autograd.grad``) at ``eps``; neither output keeps a graph."""
    with torch.enable_grad():
        y = x.detach().requires_grad_()
        drift = drift_fn(y, t)
        (g,) = torch.autograd.grad(drift, y, eps)
    logp_grad = (g * eps).reshape(x.shape[0], -1).sum(dim=1)
    return -drift.detach(), logp_grad


# Dormand–Prince 5(4) Butcher tableau (integrators.py:103-121).
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)
# the error weights as the JAX package forms them: B5 - B4 in fp32
_DP_E = tuple((torch.tensor(_DP_B5) - torch.tensor(_DP_B4)).tolist())


def _combine(coeffs, ks):
    """sum_j coeffs[j] * ks[j] over the non-zero coefficients."""
    out = None
    for c, k in zip(coeffs, ks):
        if c != 0.0:
            out = c * k if out is None else out + c * k
    return out


def ode_dopri5(drift_fn: Callable, x0: torch.Tensor, t0: float, t1: float,
               rtol: float = 1e-3, atol: float = 1e-6, max_steps: int = 1000,
               safety: float = 0.9, min_factor: float = 0.2, max_factor: float = 10.0,
               return_stats: bool = False):
    """Adaptive Dormand–Prince 5(4) with FSAL (integrators.py:124-206).

    The step controller is the JAX one: the RMS error norm of
    err / (atol + rtol * max(|y0|, |y1|)) over the whole state (over the
    global batch under ``parallel.rows.use_rows``), a step factor
    safety * ratio^-0.2 clipped to [min_factor, max_factor], dt0 = 0.02 (t1 - t0),
    at most ``max_steps`` attempted steps. Accept and reject stay on the
    device (``torch.where``); the one host read per attempted step is the
    loop condition.

    ``return_stats=True`` -> ``(x, (n_iters, n_accepted))``: attempted and
    accepted steps as ints; NFE = 1 + 6 * n_iters by FSAL.
    """
    dev = x0.device
    t0 = torch.tensor(t0, dtype=torch.float32, device=dev)
    t1 = torch.tensor(t1, dtype=torch.float32, device=dev)
    batch = x0.shape[0]

    def tvec(t):
        return t.expand(batch)

    x, t = x0, t0
    k1 = drift_fn(x0, tvec(t0))
    dt = (t1 - t0) * 0.02
    n = 0
    n_acc = torch.zeros((), dtype=torch.int32, device=dev)
    t_end = t1 - 1e-9
    while n < max_steps and bool(t < t_end):
        dt = torch.minimum(dt, t1 - t)
        ks = [k1]
        for a_row, c in zip(_DP_A[1:], _DP_C[1:]):
            ks.append(drift_fn(x + dt * _combine(a_row, ks), tvec(t + dt * c)))
        x5 = x + dt * _combine(_DP_B5, ks)
        err = dt * _combine(_DP_E, ks)
        scale = atol + rtol * torch.maximum(x.abs(), x5.abs())
        ratio = batch_rows.batch_mean((err / scale).float().square()).sqrt()
        accept = ratio <= 1.0
        factor = torch.clamp(safety * torch.clamp(ratio, min=1e-10) ** -0.2,
                             min_factor, max_factor)
        x = torch.where(accept, x5, x)
        t = torch.where(accept, t + dt, t)
        k1 = torch.where(accept, ks[6], k1)  # FSAL: k7 = f(t + dt, x5)
        dt = dt * factor
        n += 1
        n_acc = n_acc + accept.int()
    if return_stats:
        return x, (n, int(n_acc.item()))
    return x
