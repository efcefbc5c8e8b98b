"""Per-head QK RMS-norm, RoPE and tiny-axis attention, head-major.

Counterparts of ``lam_slide_tpu/ops/packed_attention.py``. The JAX versions
keep heads packed in lanes and express per-head work as segment-matrix and
pair-swap matmuls, a TPU lane-layout device; the math here is the same,
written per head.
"""

from typing import Optional

import torch


def headmajor_rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMSNorm over the last axis (dh) with a learned ``[dh]`` scale
    shared across heads; fp32 statistics, one rounding to x.dtype.

    JAX counterpart: ``packed_rmsnorm`` (packed_attention.py:76-92).
    """
    x32 = x.float()
    rr = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * rr * scale.float()).to(x.dtype)


def headmajor_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate adjacent (even, odd) feature pairs of x ``[..., dh]``; cos/sin
    broadcast against ``x[..., 0::2]`` (fp32 math, one rounding to x.dtype).

    JAX counterpart: ``packed_rope`` (packed_attention.py:67-73).
    """
    x32 = x.float()
    x_even, x_odd = x32[..., 0::2], x32[..., 1::2]
    out = torch.stack([cos * x_even - sin * x_odd, sin * x_even + cos * x_odd], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def small_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention over a tiny axis (L <= ~8), head-major ``[B, H, L, dh]``.

    As in the JAX version, q·k products are taken in the input dtype and
    summed in fp32, the softmax runs in fp32, and the weights are cast to
    ``v.dtype`` before an fp32-accumulated AV product rounded once.

    JAX counterpart: ``packed_small_attention`` (packed_attention.py:95-138).
    """
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = (q.unsqueeze(-2) * k.unsqueeze(-3)).float().sum(dim=-1) * scale
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(weights.float(), v.float()).to(v.dtype)
