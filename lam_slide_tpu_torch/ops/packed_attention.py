"""Per-head QK RMS-norm, RoPE and tiny-axis attention, head-major and packed.

Counterparts of ``lam_slide_tpu/ops/packed_attention.py``. The JAX versions
keep heads packed in lanes and express per-head work as segment-matrix and
pair-swap matmuls, a TPU lane-layout device; the math here is the same,
written per head. The head-major forms take ``[..., dh]`` rows and
``[n, dh/2]`` RoPE tables; the lane forms (``lane_rope_tables``,
``packed_rope``, ``packed_rmsnorm``, ``packed_small_attention``) take packed
``[..., D]`` rows with heads as contiguous ``dh`` segments and ``[n, D]``
lane tables, as the JAX functions do, and give the same values to the same
rounding points.
"""

from typing import Optional, Tuple

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


def lane_rope_tables(cos: torch.Tensor, sin: torch.Tensor,
                     n_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-position ``[n, dh/2]`` RoPE tables -> packed lane tables ``[n, D]``:
    each angle repeated for both lanes of its (even, odd) pair, tiled over
    the heads (packed_attention.py:52-64)."""
    return tuple(t.repeat_interleave(2, dim=-1).repeat(1, n_heads) for t in (cos, sin))


def packed_rope_fp32(x32: torch.Tensor, cos_l: torch.Tensor, sin_l: torch.Tensor) -> torch.Tensor:
    """``packed_rope`` on fp32 rows, unrounded: x * cos + partner(x) * sin,
    the partner of lane pair (even, odd) being (-x_odd, x_even)."""
    pairs = x32.unflatten(-1, (-1, 2))
    partner = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)
    return x32 * cos_l + partner * sin_l


def packed_rope(x: torch.Tensor, cos_l: torch.Tensor, sin_l: torch.Tensor) -> torch.Tensor:
    """RoPE in packed lanes: x ``[..., n, D]``, lane tables ``[n, D]``; fp32
    math, one rounding to x.dtype (packed_attention.py:67-73)."""
    return packed_rope_fp32(x.float(), cos_l, sin_l).to(x.dtype)


def packed_rmsnorm_fp32(x: torch.Tensor, n_heads: int, scale: torch.Tensor,
                        eps: float = 1e-6) -> torch.Tensor:
    """``packed_rmsnorm`` in fp32, unrounded: per-head statistics sum(x²)/dh,
    x * rsqrt(ms + eps) * the lane scale."""
    d = x.shape[-1]
    heads = x.float().unflatten(-1, (n_heads, d // n_heads))
    rr = torch.rsqrt((heads * heads).sum(dim=-1, keepdim=True) / (d // n_heads) + eps)
    scale = scale.float()
    scale_l = scale if scale.shape[-1] == d else scale.repeat(n_heads)
    return (heads * rr).flatten(-2) * scale_l


def packed_rmsnorm(x: torch.Tensor, n_heads: int, scale: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMSNorm in packed lanes (QKNorm semantics, fp32 statistics,
    one rounding to x.dtype): x ``[..., D]``; ``scale`` a ``[dh]`` scale
    shared across heads or an already tiled ``[D]`` lane scale
    (packed_attention.py:76-92)."""
    return packed_rmsnorm_fp32(x, n_heads, scale, eps).to(x.dtype)


def packed_small_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int,
                           scale: Optional[float] = None) -> torch.Tensor:
    """``small_attention`` on packed ``[N, L, D]`` operands -> packed
    ``[N, L, D]`` (packed_attention.py:95-138); ``scale`` defaults to
    dh^-0.5."""
    def heads(t):
        return t.unflatten(-1, (n_heads, t.shape[-1] // n_heads)).transpose(1, 2)

    out = small_attention(heads(q), heads(k), heads(v), scale)
    return out.transpose(1, 2).flatten(-2)
