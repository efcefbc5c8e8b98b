"""The DiT's small-L spatial block as a plain head-major composition.

Counterpart of ``_reference_spatial_block`` in
``lam_slide_tpu/ops/fused_spatial_block.py`` (:65-84). The Pallas kernel
there (``_kernel``) is opt-in on the TPU, so this composition is what the
main path runs at n <= 8 (latent_dit.py:220-231); the kernel is still to be
ported.

Weights are in torch ``nn.Linear`` layout: ``w1 [3D+M, D]``, ``w2 [D, D+M]``.
"""

import torch

from lam_slide_tpu_torch.nn.blocks import gelu_exact
from lam_slide_tpu_torch.ops.packed_attention import (
    headmajor_rmsnorm,
    headmajor_rope,
    small_attention,
)


def reference_spatial_block(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                            q_scale: torch.Tensor, k_scale: torch.Tensor,
                            w2: torch.Tensor, b2: torch.Tensor, cos: torch.Tensor,
                            sin: torch.Tensor, n_heads: int, scale: float,
                            eps: float = 1e-6) -> torch.Tensor:
    """linear1 → QKNorm → RoPE → L×L attention ∥ gelu MLP → linear2.

    x: ``[N, L, D]`` in the compute dtype; cos/sin: ``[L, dh/2]`` fp32.
    """
    n, l, d = x.shape
    dh = d // n_heads
    dtype = x.dtype
    xw = torch.matmul(x, w1.to(dtype).t()) + b1.to(dtype)
    q, k, v, mlp = xw[..., :d], xw[..., d:2 * d], xw[..., 2 * d:3 * d], xw[..., 3 * d:]

    def heads(t):  # [N, L, D] -> [N, H, L, dh]
        return t.reshape(n, l, n_heads, dh).transpose(1, 2)

    qh = headmajor_rope(headmajor_rmsnorm(heads(q), q_scale, eps), cos, sin)
    kh = headmajor_rope(headmajor_rmsnorm(heads(k), k_scale, eps), cos, sin)
    attn = small_attention(qh, kh, heads(v), scale=scale).transpose(1, 2).reshape(n, l, d)
    out = torch.cat([attn, gelu_exact(mlp)], dim=-1)
    return torch.matmul(out, w2.to(dtype).t()) + b2.to(dtype)
