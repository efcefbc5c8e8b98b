"""Packed-layout QK RMS-norm + RoPE + flash attention in one kernel: CUDA
kernel K10 and its plain PyTorch versions.

Counterpart of ``lam_slide_tpu/ops/ablations/fused_temporal_attention.py``
(``_kernel`` through ``fused_temporal_attention``). q/k/v come as linear1
produces them, packed ``[N, T, D]`` with heads as contiguous ``dh`` lane
segments; the RoPE tables are ``[T, D]`` lane tables and the norm scales
``[1, D]`` lane scales (``lane_rope_tables`` and the tiled ``[dh]`` scales,
latent_dit.py:309-311). The kernel is the ``XF_LANE`` configuration of K1's
template in ``csrc/flash_attention.cu`` (C entry ``lam_fused_temporal_fwd``):
K3's packed strides, so no head transpose is copied in or out, and the QK
RMS-norm + RoPE of each q and k tile in shared memory, in the JAX op's lane
form, with one rounding to the operand dtype after norm and RoPE together.

Gradients, as in JAX (``_bwd``, :185-191): no backward kernel; on CUDA
tensors that need one, the forward runs inside ``_FusedTemporal``, whose
backward recomputes ``reference_packed`` under autograd and returns dq, dk,
dv and the grads of both lane scales.

Counter (a plain integer, touched only where the kernel launches):
``launches``.
"""

from typing import Tuple

import torch

from lam_slide_tpu_torch.ops import _build
from lam_slide_tpu_torch.ops._grad import needs_grad, plain_vjp
from lam_slide_tpu_torch.ops.flash_attention import (
    _heads,
    _packed_like,
    _stream,
    reference_attention,
)
from lam_slide_tpu_torch.ops.packed_attention import (
    packed_rmsnorm,
    packed_rmsnorm_fp32,
    packed_rope,
    packed_rope_fp32,
)

EPS = 1e-6
MAX_DH = 128
launches = 0


def reference_fused_temporal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             cos_l: torch.Tensor, sin_l: torch.Tensor, q_scale_l: torch.Tensor,
                             k_scale_l: torch.Tensor, n_heads: int, scale: float,
                             eps: float = EPS) -> torch.Tensor:
    """The kernel's math on whole tensors (``_kernel``, :75-117): q/k normed
    and rotated with one rounding to v's dtype; fp32 logits times ``scale``;
    the unnormalised weights exp(s - max) cast to v's dtype for an
    fp32-accumulated AV product; division by max(l, 1e-30); output in q's
    dtype. q/k/v packed ``[N, T, D]``, tables ``[T, D]``, scales ``[1, D]``."""
    dtype = v.dtype
    qn, kn = (packed_rope_fp32(packed_rmsnorm_fp32(x, n_heads, s[0], eps), cos_l, sin_l).to(dtype)
              for x, s in ((q, q_scale_l), (k, k_scale_l)))
    qh, kh, vh = (_heads(t, n_heads) for t in (qn, kn, v))
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(dtype).float(), vh.float()) / l.clamp(min=1e-30)
    return out.to(q.dtype).transpose(1, 2).flatten(-2)


def reference_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cos_l: torch.Tensor,
                     sin_l: torch.Tensor, q_scale_l: torch.Tensor, k_scale_l: torch.Tensor,
                     n_heads: int, scale: float, eps: float = EPS) -> torch.Tensor:
    """``_reference_packed`` (:146-160): ``packed_rmsnorm`` then
    ``packed_rope`` (a rounding after each), then the plain attention on
    head-major views; the JAX op's backward differentiates this."""
    qn = packed_rope(packed_rmsnorm(q, n_heads, q_scale_l[0], eps), cos_l, sin_l)
    kn = packed_rope(packed_rmsnorm(k, n_heads, k_scale_l[0], eps), cos_l, sin_l)
    out = reference_attention(*(_heads(t, n_heads) for t in (qn, kn, v)), scale)
    return out.transpose(1, 2).flatten(-2)


def fused_temporal_backward(q, k, v, cos_l, sin_l, q_scale_l, k_scale_l, n_heads: int,
                            scale: float, eps: float, g: torch.Tensor,
                            needs=(True, True, True, True, True)) -> Tuple:
    """(dq, dk, dv, dq_scale_l, dk_scale_l): the VJP of ``reference_packed``
    at the output gradient g (JAX ``_bwd``); None where ``needs`` is False."""
    def f(q_, k_, v_, qs_, ks_):
        return reference_packed(q_, k_, v_, cos_l, sin_l, qs_, ks_, n_heads, scale, eps)

    return plain_vjp(f, (q, k, v, q_scale_l, k_scale_l), needs, (g,))


def _check(q, k, v, cos_l, sin_l, q_scale_l, k_scale_l, n_heads: int) -> None:
    if q.dtype != torch.bfloat16:
        raise ValueError(f"fused_temporal_attention: the kernel takes bf16 q/k/v, got {q.dtype} "
                         f"(fp32 operands are not ported yet)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"fused_temporal_attention: {name} must be bf16 on q's CUDA "
                             f"device, got {t.dtype} on {t.device}")
        if t.dim() != 3 or t.shape != q.shape or t.stride(-1) != 1:
            raise ValueError(f"fused_temporal_attention: {name} must be [N, T, D] like q with "
                             f"unit stride on D, got {tuple(t.shape)} {t.stride()}")
    n, t_len, d = q.shape
    if d % n_heads or (d // n_heads) % 2 or not 0 < d // n_heads <= MAX_DH:
        raise ValueError(f"fused_temporal_attention: D={d} must split into {n_heads} heads of "
                         f"an even dh <= {MAX_DH}")
    for name, t, rows in (("cos_l", cos_l, t_len), ("sin_l", sin_l, t_len),
                          ("q_scale_l", q_scale_l, 1), ("k_scale_l", k_scale_l, 1)):
        if (t.device != q.device or t.dtype != torch.float32 or not t.is_contiguous()
                or t.dim() != 2 or t.shape[1] != d or t.shape[0] < rows):
            raise ValueError(f"fused_temporal_attention: {name} must be contiguous fp32 "
                             f"[{'>= ' if rows > 1 else ''}{rows}, {d}] on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _forward(q, k, v, cos_l, sin_l, q_scale_l, k_scale_l, n_heads: int, scale: float,
             eps: float) -> torch.Tensor:
    """Launch K10 on checked CUDA tensors -> packed ``[N, T, D]`` (a view of
    head-major-strided packed memory, contiguous)."""
    _check(q, k, v, cos_l, sin_l, q_scale_l, k_scale_l, n_heads)
    qh, kh, vh = (_heads(t, n_heads) for t in (q, k, v))
    n, h, t_len, dh = qh.shape
    out = _packed_like(qh, t_len)
    strides = [s for t in (qh, kh, vh, out) for s in t.stride()[:3]]
    global launches
    with torch.cuda.device(q.device):
        _build.launch("lam_fused_temporal_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), q_scale_l.data_ptr(), k_scale_l.data_ptr(),
                      cos_l.data_ptr(), sin_l.data_ptr(), n, h, t_len, dh, *strides,
                      float(scale), float(eps), _stream(q))
    launches += 1
    return out.transpose(1, 2).flatten(-2)


class _FusedTemporal(torch.autograd.Function):
    """K10 forward; backward by autograd of ``reference_packed`` (JAX's
    ``custom_vjp`` with ``_fwd`` / ``_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, cos_l, sin_l, q_scale_l, k_scale_l, n_heads, scale, eps):
        ctx.save_for_backward(q, k, v, cos_l, sin_l, q_scale_l, k_scale_l)
        ctx.args = (n_heads, scale, eps)
        return _forward(q, k, v, cos_l, sin_l, q_scale_l, k_scale_l, n_heads, scale, eps)

    @staticmethod
    def backward(ctx, g):
        q, k, v, cos_l, sin_l, q_scale_l, k_scale_l = ctx.saved_tensors
        need = ctx.needs_input_grad
        dq, dk, dv, dqs, dks = fused_temporal_backward(
            q, k, v, cos_l, sin_l, q_scale_l, k_scale_l, *ctx.args, g,
            (need[0], need[1], need[2], need[5], need[6]))
        return dq, dk, dv, None, None, dqs, dks, None, None, None


def fused_temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             cos_l: torch.Tensor, sin_l: torch.Tensor, q_scale_l: torch.Tensor,
                             k_scale_l: torch.Tensor, n_heads: int, scale: float,
                             eps: float = EPS) -> torch.Tensor:
    """Per-head QK RMS-norm + RoPE + attention over packed ``[N, T, D]``
    q/k/v -> packed ``[N, T, D]``; cos_l/sin_l ``[T, D]`` lane tables,
    q_scale_l/k_scale_l ``[1, D]`` lane scales (the JAX op's signature).

    CPU tensors take ``reference_fused_temporal``. CUDA tensors launch K10
    (bf16 q/k/v with unit stride on D, an even dh <= 128, fp32 tables and
    scales) or raise; when they need a gradient, through ``_FusedTemporal``.
    """
    if q.device.type == "cpu":
        return reference_fused_temporal(q, k, v, cos_l, sin_l, q_scale_l, k_scale_l, n_heads,
                                        scale, eps)
    if needs_grad(q, k, v, q_scale_l, k_scale_l):
        return _FusedTemporal.apply(q, k, v, cos_l, sin_l, q_scale_l, k_scale_l, n_heads,
                                    float(scale), eps)
    return _forward(q, k, v, cos_l, sin_l, q_scale_l, k_scale_l, n_heads, scale, eps)
