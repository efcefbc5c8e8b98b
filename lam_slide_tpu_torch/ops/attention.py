"""Attention dispatch (counterpart of ``lam_slide_tpu/ops/attention.py``).

``attention(q, k, v, scale)`` takes head-major ``[B, H, N, dh]`` operands.
With ``backend="auto"`` a CUDA tensor with N >= 128 goes to the flash
kernel (mirroring ``_pick_backend``, attention.py:157-172) and everything
else to the plain version; ``backend="plain"`` always takes the plain
version.
"""

from typing import Optional

import torch

from lam_slide_tpu_torch.ops.flash_attention import flash_attention, reference_attention

BACKENDS = ("auto", "plain")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: Optional[float] = None, backend: str = "auto") -> torch.Tensor:
    if backend not in BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}; expected one of {BACKENDS}")
    if backend == "auto" and q.is_cuda and q.shape[-2] >= 128:
        return flash_attention(q, k, v, scale=scale)
    return reference_attention(q, k, v, scale)
