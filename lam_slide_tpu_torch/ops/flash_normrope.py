"""Flash attention with QK RMS-norm + RoPE: CUDA kernels K5 (forward) and K6
(backward) and their plain PyTorch versions.

Counterpart of ``lam_slide_tpu/ops/flash_normrope.py`` (``_nr_flash_kernel``
through ``flash_attention_normrope``; ``_nr_bwd_kv_kernel`` and
``_nr_bwd_q_kernel`` through ``_nr_backward``). The function is the TPU
kernels': the per-head RMS-norm (eps 1e-6, learned fp32 ``[dh]`` scale) and
the rotation of adjacent (even, odd) pairs of RAW head-major q/k, with the
rounding points of ``headmajor_rope(headmajor_rmsnorm(x))``, then
attention. On the card the transform runs once, in a kernel of its own
(``csrc/qk_normrope.cu``, C entries ``lam_qk_normrope`` in bf16 and
``lam_qk_normrope_f32``), which writes contiguous head-major ``q_t``/``k_t``.
In bf16 the attention is the redesigned flash forward of
``csrc/flash_fwd_sm90.cu`` on ``(q_t, k_t, v)``, and its backward that of
``csrc/flash_bwd_sm90.cu``. In fp32 (the fp32 DiTs at dh 128, sampling
and training) it is K1's fp32 kernel of ``csrc/flash_attention.cu``, and
its backward K4's fp32 kernels of ``csrc/flash_attention_bwd.cu`` (the
wide one at 64 < dh <= 128). ``_FlashNormRope`` keeps the
forward's ``q_t``/``k_t`` for the backward, whose grads with respect to
the TRANSFORMED q/k are chained to the raw q/k and the two scales by
autograd of the plain pre-transform (``chain_backward``), as
``_nr_core_bwd`` does with ``jax.vjp`` of ``_pre_transform``.

Counters (plain integers, touched only where a kernel launches):
``launches`` counts K5 calls of both dtypes and ``fp32_launches`` those in
fp32 (the transform's fp32 kernel, then K1's fp32 kernel) and
``fp32_wide_launches`` those of K1's wide fp32 kernel among them
(64 < dh <= 128), ``fp32_narrow_launches`` those of its narrow one (dh <= 64);
``transform_launches`` counts the transform kernel's launches in both dtypes
(one a K5 call, one a ``flash_attention_normrope_backward`` call, one a
``qk_normrope`` call); ``sm90_launches`` the bf16 K5 calls on the
redesigned forward and ``sm90_cp_async_launches`` those of them on its
cp.async route; ``bwd_launches`` counts K6 calls of both dtypes, ``bwd_sm90_launches`` the
redesigned backward's kernels (three a call) and
``bwd_sm90_cp_async_launches`` its main kernels on the cp.async route,
``bwd_fp32_launches`` K4's fp32 kernels (one or two a call,
``flash_attention.f32_dq_tiles``) and ``bwd_fp32_wide_launches`` those of
them at 64 < dh <= 128.
"""

import sys
from typing import Callable, Optional, Tuple

import torch

from lam_slide_tpu_torch.ops import _build
from lam_slide_tpu_torch.ops._grad import needs_grad, plain_vjp
from lam_slide_tpu_torch.ops.flash_attention import (
    _check,
    _check_backward,
    _check_fp32_grad,
    _launch_sm90_backward,
    _launch_sm90_forward,
    _launch_template_backward,
    _launch_template_forward,
    _stream,
    flash_attention,
    reference_attention,
    reference_flash_backward,
)
from lam_slide_tpu_torch.ops.packed_attention import headmajor_rmsnorm, headmajor_rope

EPS = 1e-6
DTYPES = (torch.bfloat16, torch.float32)
launches = 0
fp32_launches = 0
fp32_wide_launches = 0
fp32_narrow_launches = 0
transform_launches = 0
sm90_launches = 0
sm90_cp_async_launches = 0
bwd_launches = 0
bwd_sm90_launches = 0
bwd_sm90_cp_async_launches = 0
bwd_fp32_launches = 0
bwd_fp32_wide_launches = 0
_COUNTS = sys.modules[__name__]  # the counters the shared launchers move


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


def chain_backward(attn_backward: Callable, q, k, v, q_scale, k_scale, cos, sin, q_t, k_t,
                   out, lse, g, scale: float, needs=(True, True, True, True, True)):
    """(dq, dk, dv, dq_scale, dk_scale), None where ``needs`` (for q, k, v,
    q_scale, k_scale) asks for no grad: ``attn_backward(q_t, k_t, v, out,
    lse, g, scale) -> (dq_t, dk_t, dv)`` on the transformed q/k, then the
    plain pre-transform's VJP to the raw q/k and the scales (``_nr_core_bwd``,
    flash_normrope.py:452-466)."""
    dq_t, dk_t, dv = attn_backward(q_t, k_t, v, out, lse, g, scale)
    dq, dk, dqs, dks, _, _ = plain_vjp(pre_transform, (q, k, q_scale, k_scale, cos, sin),
                                       (needs[0], needs[1], needs[3], needs[4], False, False),
                                       (dq_t, dk_t))
    return dq, dk, dv if needs[2] else None, dqs, dks


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


def empty_transformed(q: torch.Tensor, k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Empty contiguous head-major buffers for q_t and k_t, in q's and k's
    shapes, dtype and device: the layout every TMA map of the attention
    kernels accepts when dh % 8 == 0."""
    return tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k))


def _launch_transform(q, k, q_scale, k_scale, cos, sin):
    """The transform kernel on checked CUDA tensors (bf16 or fp32) ->
    contiguous (q_t, k_t) in q's dtype."""
    global transform_launches
    b, h, nq, dh = q.shape
    q_t, k_t = empty_transformed(q, k)
    entry = "lam_qk_normrope_f32" if q.dtype == torch.float32 else "lam_qk_normrope"
    with torch.cuda.device(q.device):
        _build.launch(entry, q.data_ptr(), k.data_ptr(), q_t.data_ptr(),
                      k_t.data_ptr(), q_scale.data_ptr(), k_scale.data_ptr(), cos.data_ptr(),
                      sin.data_ptr(), b, h, nq, k.shape[2], dh, *q.stride()[:3],
                      *k.stride()[:3], EPS, _stream(q))
    transform_launches += 1
    return q_t, k_t


def qk_normrope(q: torch.Tensor, k: torch.Tensor, q_scale: torch.Tensor,
                k_scale: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """(q_t, k_t): the QK RMS-norm + RoPE of raw head-major q/k, written
    once into contiguous head-major memory in q's dtype.

    CPU tensors take ``pre_transform``. CUDA tensors launch the transform
    kernel (bf16 or fp32 q/k with unit stride on an even dh <= 128, fp32
    scales and tables) or raise; CUDA inputs that need a gradient raise too
    (the kernel paths differentiate through ``chain_backward``).
    """
    if q.device.type == "cpu":
        return pre_transform(q, k, q_scale, k_scale, cos, sin)
    if needs_grad(q, k, q_scale, k_scale):
        raise ValueError("qk_normrope: the transform kernel has no autograd; differentiate "
                         "through flash_attention_normrope")
    _check(q, k, k, DTYPES)
    _check_normrope(q, q_scale, k_scale, cos, sin, k.shape[2])
    return _launch_transform(q, k, q_scale, k_scale, cos, sin)


def _forward_kernels(q, k, v, q_scale, k_scale, cos, sin, scale: float, with_lse: bool):
    """Launch K5 on checked CUDA tensors: the transform kernel, then on (q_t,
    k_t, v) the redesigned forward (bf16) or K1's fp32 kernel (fp32) ->
    (out, lse or None, q_t, k_t)."""
    global launches, fp32_launches
    _check(q, k, v, DTYPES)
    _check_normrope(q, q_scale, k_scale, cos, sin, k.shape[2])
    q_t, k_t = _launch_transform(q, k, q_scale, k_scale, cos, sin)
    if q.dtype == torch.float32:
        out, lse = _launch_template_forward(q_t, k_t, v, scale, with_lse, None, _COUNTS)
        fp32_launches += 1
    else:
        out, lse = _launch_sm90_forward(q_t, k_t, v, scale, with_lse, _COUNTS)
    launches += 1
    return out, lse, q_t, k_t


def _forward(q, k, v, q_scale, k_scale, cos, sin, scale: float, with_lse: bool):
    """K5 on checked CUDA tensors -> (out, lse or None)."""
    return _forward_kernels(q, k, v, q_scale, k_scale, cos, sin, scale, with_lse)[:2]


def _attention_backward(q_t, k_t, v, out, lse, g, scale: float):
    """K6's attention part on the transformed q/k -> (dq_t, dk_t, dv) in
    packed memory: on CUDA tensors the redesigned backward in bf16, K4's
    fp32 kernels in fp32; its plain version (``reference_flash_backward``)
    on CPU ones."""
    global bwd_launches
    if q_t.device.type == "cpu":
        return reference_flash_backward(q_t, k_t, v, out, lse, g, scale)
    g = g if g.stride(-1) == 1 else g.contiguous()
    if q_t.dtype == torch.float32:
        grads, _ = _launch_template_backward(q_t, k_t, v, out, lse, g, scale, None, _COUNTS)
    else:
        grads = _launch_sm90_backward(q_t, k_t, v, out, lse, g, scale, _COUNTS)
    bwd_launches += 1
    return grads


class _FlashNormRope(torch.autograd.Function):
    """K5 forward (with lse) and K6 backward chained through the plain
    pre-transform: ``_nr_core``'s VJP. The forward's q_t/k_t are kept for
    the backward, so it does not transform again."""

    @staticmethod
    def forward(ctx, q, k, v, q_scale, k_scale, cos, sin, scale):
        out, lse, q_t, k_t = _forward_kernels(q, k, v, q_scale, k_scale, cos, sin, scale,
                                              with_lse=True)
        ctx.save_for_backward(q, k, v, q_scale, k_scale, cos, sin, q_t, k_t, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad
        grads = chain_backward(_attention_backward, *ctx.saved_tensors, g, ctx.scale, need[:5])
        return (*grads, None, None, None)


def flash_attention_normrope(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             q_scale: torch.Tensor, k_scale: torch.Tensor,
                             cos: torch.Tensor, sin: torch.Tensor,
                             mask: Optional[torch.Tensor] = None,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Attention over RAW head-major q/k with QKNorm + RoPE.

    CPU tensors take ``reference_attention_normrope``. CUDA tensors launch
    K5 (bf16 or fp32 q/k/v with unit stride on an even dh <= 128, fp32
    scales and tables: the transform kernel, then the redesigned flash
    forward in bf16 or K1's fp32 kernel in fp32) or raise; tensors that need
    a gradient go through ``_FlashNormRope``, whose backward is K6 (in fp32
    on K4's fp32 kernels). With a ``[B, Nk]`` key-padding mask, JAX's fallback
    (flash_normrope.py:496-498): the plain ``pre_transform``, then
    ``flash_attention(..., mask=mask)``, which is K1 with the bias on CUDA
    tensors and ``reference_attention`` on CPU ones.
    """
    if mask is not None:
        if q.device.type != "cpu":
            _check_normrope(q, q_scale, k_scale, cos, sin, k.shape[2])
        q_t, k_t = pre_transform(q, k, q_scale, k_scale, cos, sin)
        return flash_attention(q_t, k_t, v, mask=mask, scale=scale)
    if q.device.type == "cpu":
        return reference_attention_normrope(q, k, v, q_scale, k_scale, cos, sin, scale)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if needs_grad(q, k, v, q_scale, k_scale):
        _check_fp32_grad("flash_attention_normrope", q)
        return _FlashNormRope.apply(q, k, v, q_scale, k_scale, cos, sin, scale)
    return _forward(q, k, v, q_scale, k_scale, cos, sin, scale, with_lse=False)[0]


def flash_attention_normrope_backward(q, k, v, q_scale, k_scale, cos, sin, out, lse, g,
                                      scale: float):
    """(dq_t, dk_t, dv): gradients with respect to the TRANSFORMED q/k and to
    v, from RAW head-major q/k, the forward's output, its lse and the output
    gradient g.

    CPU tensors take ``reference_normrope_backward``. CUDA tensors launch
    the transform kernel and then K6 (on q_t/k_t the redesigned backward in
    bf16, K4's fp32 kernels in fp32) or raise; the grads come back in packed
    ``[B, N, H, dh]`` memory.
    """
    if q.device.type == "cpu":
        return reference_normrope_backward(q, k, v, q_scale, k_scale, cos, sin, out, lse, g,
                                           scale)
    _check_backward(q, k, v, out, lse, g, DTYPES)
    _check_normrope(q, q_scale, k_scale, cos, sin, k.shape[2])
    q_t, k_t = _launch_transform(q, k, q_scale, k_scale, cos, sin)
    return _attention_backward(q_t, k_t, v, out, lse, g, scale)
