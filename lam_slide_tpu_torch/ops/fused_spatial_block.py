"""The DiT's small-L spatial block: CUDA kernel K8 and its plain PyTorch version.

Counterpart of ``lam_slide_tpu/ops/fused_spatial_block.py`` (``_kernel``
through ``fused_spatial_block``; plain version ``_reference_spatial_block``,
:65-84). The kernel (``csrc/fused_spatial_block.cu``) runs the whole
ParallelMLPAttention over L <= 8 positions for a block of frames with the
``[rows, 3D+M]`` linear1 output kept in shared memory: linear1, per-head QK
RMS-norm and RoPE, L×L softmax attention, exact GELU of the MLP slice, and
``concat(attn, gelu) @ w2 + b2``. Any head split whose even dh divides D
(16×24 and 3×128 at the 4AA width).

Weights are in torch ``nn.Linear`` layout: ``w1 [3D+M, D]``, ``w2 [D, D+M]``.

Gradients: on CUDA tensors that need one, the kernel runs inside
``_SpatialBlock``, whose backward is autograd of ``reference_spatial_block``
on the saved inputs (``_fused_bwd``, fused_spatial_block.py:225-230); no
backward kernel.

``launches`` counts kernel launches; nothing else touches it.
"""

import torch

from lam_slide_tpu_torch.nn.blocks import gelu_exact
from lam_slide_tpu_torch.ops import _build
from lam_slide_tpu_torch.ops._grad import needs_grad, plain_vjp
from lam_slide_tpu_torch.ops.packed_attention import (
    headmajor_rmsnorm,
    headmajor_rope,
    small_attention,
)

launches = 0


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


def _check(x, w1, b1, q_scale, k_scale, w2, b2, cos, sin, n_heads) -> None:
    for name, t, dtype in (("x", x, torch.bfloat16), ("w1", w1, torch.bfloat16),
                           ("b1", b1, torch.bfloat16), ("w2", w2, torch.bfloat16),
                           ("b2", b2, torch.bfloat16), ("q_scale", q_scale, torch.float32),
                           ("k_scale", k_scale, torch.float32), ("cos", cos, torch.float32),
                           ("sin", sin, torch.float32)):
        if not t.is_cuda or t.device != x.device or t.dtype != dtype:
            raise ValueError(f"fused_spatial_block: {name} must be {dtype} on x's CUDA device, "
                             f"got {t.dtype} on {t.device}")
        if name != "w1" and name != "w2" and not t.is_contiguous():
            raise ValueError(f"fused_spatial_block: {name} must be contiguous")
    if x.dim() != 3 or not 1 <= x.shape[1] <= 8:
        raise ValueError(f"fused_spatial_block: x must be [N, L <= 8, D], got {tuple(x.shape)}")
    _, l, d = x.shape
    width = w1.shape[0]
    dh = d // n_heads if d % n_heads == 0 else 0
    if d % 16 or (width - 3 * d) % 16 or width <= 3 * d or dh % 2 or dh == 0:
        raise ValueError(f"fused_spatial_block: needs D and M multiples of 16 and an even "
                         f"head dim, got D={d}, w1 rows {width}, {n_heads} heads")
    m = width - 3 * d
    if (w1.shape != (width, d) or b1.shape != (width,) or w2.shape != (d, d + m)
            or b2.shape != (d,) or q_scale.shape != (dh,) or k_scale.shape != (dh,)
            or cos.shape != (l, dh // 2) or sin.shape != (l, dh // 2)):
        raise ValueError("fused_spatial_block: parameter shapes do not match x and the heads")
    for name, w in (("w1", w1), ("w2", w2)):
        if w.stride(1) != 1 or w.stride(0) % 8 or w.data_ptr() % 32:
            raise ValueError(f"fused_spatial_block: {name} must be in nn.Linear layout "
                             f"(unit column stride, row stride % 8 == 0, 32-byte aligned), "
                             f"got strides {w.stride()}")


def fused_spatial_block(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                        q_scale: torch.Tensor, k_scale: torch.Tensor,
                        w2: torch.Tensor, b2: torch.Tensor, cos: torch.Tensor,
                        sin: torch.Tensor, n_heads: int, scale: float) -> torch.Tensor:
    """The spatial block over x ``[N, L, D]`` -> ``[N, L, D]``.

    CPU tensors take ``reference_spatial_block``. CUDA tensors launch the
    kernel (bf16 x and weights, fp32 norm scales and ``[L, dh/2]`` tables) or
    raise, through ``_SpatialBlock`` when they need a gradient.
    """
    args = (x, w1, b1, q_scale, k_scale, w2, b2, cos, sin, n_heads, scale)
    if x.device.type == "cpu":
        return reference_spatial_block(*args)
    if needs_grad(*args):
        return _SpatialBlock.apply(*args)
    return _launch(*args)


class _SpatialBlock(torch.autograd.Function):
    """K8 forward, autograd of ``reference_spatial_block`` backward."""

    @staticmethod
    def forward(ctx, x, w1, b1, q_scale, k_scale, w2, b2, cos, sin, n_heads, scale):
        ctx.save_for_backward(x, w1, b1, q_scale, k_scale, w2, b2, cos, sin)
        ctx.n_heads, ctx.scale = n_heads, scale
        return _launch(x, w1, b1, q_scale, k_scale, w2, b2, cos, sin, n_heads, scale)

    @staticmethod
    def backward(ctx, g):
        grads = plain_vjp(
            lambda *a: reference_spatial_block(*a, ctx.n_heads, ctx.scale),
            ctx.saved_tensors, ctx.needs_input_grad[:9], (g,))
        return (*grads, None, None)


def _launch(x, w1, b1, q_scale, k_scale, w2, b2, cos, sin, n_heads, scale) -> torch.Tensor:
    """Launch K8 on CUDA tensors (checked here) -> ``[N, L, D]``."""
    _check(x, w1, b1, q_scale, k_scale, w2, b2, cos, sin, n_heads)
    n, l, d = x.shape
    m = w1.shape[0] - 3 * d
    out = torch.empty_like(x)
    global launches
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.launch("lam_spatial_block_fwd", x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                      q_scale.data_ptr(), k_scale.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                      cos.data_ptr(), sin.data_ptr(), out.data_ptr(), n, l, d, m, n_heads,
                      w1.stride(0), w2.stride(0), float(scale), stream)
    launches += 1
    return out
