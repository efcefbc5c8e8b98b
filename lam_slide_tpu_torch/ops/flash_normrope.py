"""Flash attention with QK RMS-norm + RoPE inside the kernel: CUDA kernels
K5 (forward) and K6 (backward) and their plain PyTorch versions.

Counterpart of ``lam_slide_tpu/ops/flash_normrope.py`` (``_nr_flash_kernel``
through ``flash_attention_normrope``; ``_nr_bwd_kv_kernel`` and
``_nr_bwd_q_kernel`` through ``_nr_backward``). The forward is the ``NR``
variant of K1's template in ``csrc/flash_attention.cu`` (C entry
``lam_flash_attention_normrope_fwd``): it takes RAW head-major q/k, applies
the per-head RMS-norm (eps 1e-6, learned fp32 ``[dh]`` scale) and the
rotation of adjacent (even, odd) pairs to the Q tile and to each K tile in
shared memory, and then runs K1's recurrence. The rounding points are those
of ``headmajor_rope(headmajor_rmsnorm(x))``. The backward is the ``NR``
variant of K4's template in ``csrc/flash_attention_bwd.cu``: it transforms
the tiles the same way and returns dq/dk with respect to the TRANSFORMED
q/k; ``_FlashNormRope`` chains them to the raw q/k and the two scales by
autograd of the plain pre-transform, as ``_nr_core_bwd`` does with
``jax.vjp`` of ``_pre_transform``.

Counters (plain integers, touched only where a kernel launches):
``launches`` counts K5, ``bwd_kv_launches`` and ``bwd_q_launches`` K6's
dK/dV and dQ kernels.
"""

import sys
from typing import Optional, Tuple

import torch

from lam_slide_tpu_torch.ops import _build
from lam_slide_tpu_torch.ops._grad import needs_grad, plain_vjp
from lam_slide_tpu_torch.ops.flash_attention import (
    _check,
    _check_backward,
    _launch_backward,
    _packed_like,
    _stream,
    reference_attention,
    reference_flash_backward,
)
from lam_slide_tpu_torch.ops.packed_attention import headmajor_rmsnorm, headmajor_rope

EPS = 1e-6
launches = 0
bwd_kv_launches = 0
bwd_q_launches = 0


def pre_transform(q: torch.Tensor, k: torch.Tensor, q_scale: torch.Tensor,
                  k_scale: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """(q_t, k_t): the elementwise stage the kernels absorb
    (``_pre_transform``, flash_normrope.py:433-437); the first Nq rows of
    cos/sin rotate q, the first Nk rotate k."""
    nq, nk = q.shape[2], k.shape[2]
    q_t = headmajor_rope(headmajor_rmsnorm(q, q_scale, EPS), cos[:nq], sin[:nq])
    k_t = headmajor_rope(headmajor_rmsnorm(k, k_scale, EPS), cos[:nk], sin[:nk])
    return q_t, k_t


def reference_attention_normrope(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 q_scale: torch.Tensor, k_scale: torch.Tensor,
                                 cos: torch.Tensor, sin: torch.Tensor,
                                 scale: Optional[float] = None) -> torch.Tensor:
    """The pre-transform then ``reference_attention``.

    q/k/v: head-major ``[B, H, N, dh]``; q_scale/k_scale: ``[dh]``;
    cos/sin: ``[N, dh/2]`` fp32 (the first Nq rows rotate q, the first Nk k).
    """
    return reference_attention(*pre_transform(q, k, q_scale, k_scale, cos, sin), v, scale)


def reference_normrope_backward(q, k, v, q_scale, k_scale, cos, sin, out, lse, g,
                                scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq_t, dk_t, dv): K6's result, K4's formulas on the pre-transformed q/k
    (gradients with respect to the TRANSFORMED q/k, as ``_nr_backward``)."""
    q_t, k_t = pre_transform(q, k, q_scale, k_scale, cos, sin)
    return reference_flash_backward(q_t, k_t, v, out, lse, g, scale)


def _check_normrope(q, q_scale, k_scale, cos, sin, nk) -> None:
    b, h, nq, dh = q.shape
    if dh % 2:
        raise ValueError(f"flash_attention_normrope: head dim {dh} must be even")
    for name, t in (("q_scale", q_scale), ("k_scale", k_scale), ("cos", cos), ("sin", sin)):
        if t.device != q.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"flash_attention_normrope: {name} must be contiguous fp32 on "
                             f"{q.device}, got {t.dtype} on {t.device}")
    if q_scale.shape != (dh,) or k_scale.shape != (dh,):
        raise ValueError(f"flash_attention_normrope: scales must be [{dh}], got "
                         f"{tuple(q_scale.shape)} and {tuple(k_scale.shape)}")
    for name, t in (("cos", cos), ("sin", sin)):
        if t.dim() != 2 or t.shape[0] < max(nq, nk) or t.shape[1] != dh // 2:
            raise ValueError(f"flash_attention_normrope: {name} must be [>= {max(nq, nk)}, "
                             f"{dh // 2}], got {tuple(t.shape)}")


def _forward(q, k, v, q_scale, k_scale, cos, sin, scale: float, with_lse: bool):
    """Launch K5 on checked CUDA tensors -> (out, lse or None)."""
    _check(q, k, v)
    _check_normrope(q, q_scale, k_scale, cos, sin, k.shape[2])
    b, h, nq, dh = q.shape
    out = _packed_like(q, nq)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device) if with_lse else None
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    global launches
    with torch.cuda.device(q.device):
        _build.launch("lam_flash_attention_normrope_fwd", q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
                      q_scale.data_ptr(), k_scale.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                      b, h, nq, k.shape[2], dh, *strides, float(scale), _stream(q))
    launches += 1
    return out, lse


class _FlashNormRope(torch.autograd.Function):
    """K5 forward (with lse) and K6 backward chained through the plain
    pre-transform: ``_nr_core``'s VJP."""

    @staticmethod
    def forward(ctx, q, k, v, q_scale, k_scale, cos, sin, scale):
        out, lse = _forward(q, k, v, q_scale, k_scale, cos, sin, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, q_scale, k_scale, cos, sin, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, q_scale, k_scale, cos, sin, out, lse = ctx.saved_tensors
        dq_t, dk_t, dv = flash_attention_normrope_backward(q, k, v, q_scale, k_scale, cos,
                                                           sin, out, lse, g, ctx.scale)
        need = ctx.needs_input_grad
        dq, dk, dqs, dks, _, _ = plain_vjp(pre_transform, (q, k, q_scale, k_scale, cos, sin),
                                           (need[0], need[1], need[3], need[4], False, False),
                                           (dq_t, dk_t))
        return dq, dk, dv, dqs, dks, None, None, None


def flash_attention_normrope(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             q_scale: torch.Tensor, k_scale: torch.Tensor,
                             cos: torch.Tensor, sin: torch.Tensor,
                             mask: Optional[torch.Tensor] = None,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Attention over RAW head-major q/k with QKNorm + RoPE in the kernel.

    CPU tensors take ``reference_attention_normrope``. CUDA tensors launch
    K5 (bf16 q/k/v with unit stride on an even dh <= 128, fp32 scales and
    tables) or raise; when they need a gradient, through ``_FlashNormRope``,
    whose backward is K6. Key-padding masks are not ported yet and raise on
    every device.
    """
    if mask is not None:
        raise NotImplementedError("flash_attention_normrope: key-padding masks are not ported yet")
    if q.device.type == "cpu":
        return reference_attention_normrope(q, k, v, q_scale, k_scale, cos, sin, scale)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if needs_grad(q, k, v, q_scale, k_scale):
        return _FlashNormRope.apply(q, k, v, q_scale, k_scale, cos, sin, scale)
    return _forward(q, k, v, q_scale, k_scale, cos, sin, scale, with_lse=False)[0]


def flash_attention_normrope_backward(q, k, v, q_scale, k_scale, cos, sin, out, lse, g,
                                      scale: float):
    """(dq_t, dk_t, dv): gradients with respect to the TRANSFORMED q/k and to
    v, from RAW head-major q/k, the forward's output, its lse and the output
    gradient g.

    CPU tensors take ``reference_normrope_backward``. CUDA tensors launch
    K6's dK/dV kernel and then its dQ kernel or raise; the grads come back
    in packed ``[B, N, H, dh]`` memory.
    """
    if q.device.type == "cpu":
        return reference_normrope_backward(q, k, v, q_scale, k_scale, cos, sin, out, lse, g,
                                           scale)
    _check_backward(q, k, v, out, lse, g)
    _check_normrope(q, q_scale, k_scale, cos, sin, k.shape[2])
    return _launch_backward(q, k, v, out, lse, g, scale, sys.modules[__name__],
                            (q_scale, k_scale, cos, sin))
