"""Blocks (counterpart of ``lam_slide_tpu/nn/blocks.py``; main-path subset)."""

import torch


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU — the activation the reference configs select
    (torch_modules.py:36-50). Computed in fp32 with a real erf, rounded once
    to x.dtype."""
    x32 = x.float()
    return (0.5 * x32 * (1.0 + torch.erf(x32 * (2.0 ** -0.5)))).to(x.dtype)
