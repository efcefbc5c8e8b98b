"""Residual + LayerNorm + AdaLN modulate, as plain compositions.

Counterpart of ``lam_slide_tpu/ops/fused_adaln.py``. Its Pallas kernels
(``_adaln_kernel``, ``_residual_adaln_kernel``) are opt-in on the TPU, so
the main path runs these compositions (fused_adaln.py:74-80); the kernels
are still to be ported.
"""

from typing import Tuple

import torch

from lam_slide_tpu_torch.nn.norms import layer_norm


def modulate(xn: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """AdaLN modulation xn * (1 + scale) + shift (reference mmdit.py:21-22)."""
    return xn * (1.0 + scale.to(xn.dtype)) + shift.to(xn.dtype)


def adaln_modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """modulate(layer_norm(x), shift, scale)."""
    return modulate(layer_norm(x, eps=eps), shift, scale)


def residual_adaln_modulate(x: torch.Tensor, h: torch.Tensor, gate: torch.Tensor,
                            shift: torch.Tensor, scale: torch.Tensor,
                            eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + gate·h, modulate(layer_norm(x + gate·h)))."""
    x_new = x + gate.to(x.dtype) * h
    return x_new, modulate(layer_norm(x_new, eps=eps), shift, scale)
