"""Attention dispatch (counterpart of ``lam_slide_tpu/ops/attention.py``).

``attention(q, k, v, mask, scale)`` takes head-major ``[B, H, N, dh]``
operands and an optional ``[B, Nk]`` boolean key-padding mask;
``attention_packed(q, k, v, num_heads, scale)`` takes packed ``[B, N, H*dh]``
ones (``dot_product_attention_packed``, unmasked). With ``backend="auto"``:

* a CUDA tensor with a query length >= 128 goes to the flash kernel K1,
  masked or not, bf16 or fp32 (mirroring ``_pick_backend``,
  attention.py:157-172), and a packed one to K1's packed entry K3;
* a packed CUDA self-attention with 8 < N < 128 goes to the short-axis
  kernel K9. JAX takes that kernel only on request
  (``LAM_SLIDE_SHORT_ATTN=1``, ``_pick_backend_packed``) because Mosaic pads
  such axes to 128 lanes; the card has no such padding, and both routes
  compute the same function to the same rounding points;
* everything else takes the plain version.

``backend="plain"`` always takes the plain version.

``linear_attention`` is the O(N) mode (``attention_mode="linear"``); it has
no kernel in either package.
"""

from typing import Optional

import torch

from lam_slide_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_packed,
    reference_attention,
    reference_attention_packed,
)
from lam_slide_tpu_torch.ops.short_attention import short_attention

BACKENDS = ("auto", "plain")


def _auto(q: torch.Tensor, backend: str) -> bool:
    if backend not in BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}; expected one of {BACKENDS}")
    return backend == "auto" and q.is_cuda


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None, scale: Optional[float] = None,
              backend: str = "auto") -> torch.Tensor:
    if _auto(q, backend) and q.shape[-2] >= 128:
        return flash_attention(q, k, v, mask=mask, scale=scale)
    return reference_attention(q, k, v, scale, mask=mask)


def attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                     scale: Optional[float] = None, backend: str = "auto") -> torch.Tensor:
    if _auto(q, backend):
        n = q.shape[1]
        if n >= 128:
            return flash_attention_packed(q, k, v, num_heads, scale=scale)
        if 8 < n and q.shape == k.shape:
            return short_attention(q, k, v, num_heads, scale=scale)
    return reference_attention_packed(q, k, v, num_heads, scale)


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """O(N) linear attention over head-major ``[B, H, N, dh]`` operands
    (reference mmdit.py:58-72; attention.py:62-73): softmax of q over the
    features and of k over the sequence, both in fp32, q scaled by dh^-0.5,
    then kᵀv and q(kᵀv) in fp32, rounded once to v's dtype."""
    q = torch.softmax(q.float(), dim=-1) * q.shape[-1] ** -0.5
    k = torch.softmax(k.float(), dim=-2)
    context = torch.matmul(k.transpose(-1, -2), v.float())
    return torch.matmul(q, context).to(v.dtype)
