"""Attention dispatch (counterpart of ``lam_slide_tpu/ops/attention.py``).

``attention(q, k, v, scale)`` takes head-major ``[B, H, N, dh]`` operands,
``attention_packed(q, k, v, num_heads, scale)`` packed ``[B, N, H*dh]`` ones
(``dot_product_attention_packed``). With ``backend="auto"`` a CUDA tensor
with N >= 128 goes to the flash kernel (mirroring ``_pick_backend``,
attention.py:157-172) and everything else to the plain version;
``backend="plain"`` always takes the plain version.
"""

from typing import Optional

import torch

from lam_slide_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_packed,
    reference_attention,
    reference_attention_packed,
)

BACKENDS = ("auto", "plain")


def _use_flash(q: torch.Tensor, n: int, backend: str) -> bool:
    if backend not in BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}; expected one of {BACKENDS}")
    return backend == "auto" and q.is_cuda and n >= 128


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: Optional[float] = None, backend: str = "auto") -> torch.Tensor:
    if _use_flash(q, q.shape[-2], backend):
        return flash_attention(q, k, v, scale=scale)
    return reference_attention(q, k, v, scale)


def attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                     scale: Optional[float] = None, backend: str = "auto") -> torch.Tensor:
    if _use_flash(q, q.shape[1], backend):
        return flash_attention_packed(q, k, v, num_heads, scale=scale)
    return reference_attention_packed(q, k, v, num_heads, scale)
