"""Fixed-grid ODE integrators (counterpart of ``lam_slide_tpu/transport/integrators.py``).

``drift_fn(x, t_vec)`` takes a [B] time vector like the reference model
closures. The JAX package scans the steps with ``lax.scan``; here they are
a Python loop. dopri5 and the SDE integrators are not ported yet.
"""

from typing import Callable

import torch


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
