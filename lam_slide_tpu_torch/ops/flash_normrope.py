"""Flash attention with QK RMS-norm + RoPE inside the kernel: CUDA kernel K5
and its plain PyTorch version.

Counterpart of ``lam_slide_tpu/ops/flash_normrope.py`` (``_nr_flash_kernel``
through ``flash_attention_normrope``). The kernel is the ``NR`` variant of
K1's template in ``csrc/flash_attention.cu`` (C entry
``lam_flash_attention_normrope_fwd``): it takes RAW head-major q/k, applies
the per-head RMS-norm (eps 1e-6, learned fp32 ``[dh]`` scale) and the
rotation of adjacent (even, odd) pairs to the Q tile and to each K tile in
shared memory, and then runs K1's recurrence. The rounding points are those
of ``headmajor_rope(headmajor_rmsnorm(x))``.

``launches`` counts kernel launches; nothing else touches it.
"""

from typing import Optional

import torch

from lam_slide_tpu_torch.ops import _build
from lam_slide_tpu_torch.ops.flash_attention import _check, reference_attention
from lam_slide_tpu_torch.ops.packed_attention import headmajor_rmsnorm, headmajor_rope

EPS = 1e-6
launches = 0


def reference_attention_normrope(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 q_scale: torch.Tensor, k_scale: torch.Tensor,
                                 cos: torch.Tensor, sin: torch.Tensor,
                                 scale: Optional[float] = None) -> torch.Tensor:
    """The pre-transform (flash_normrope.py:433-437) then ``reference_attention``.

    q/k/v: head-major ``[B, H, N, dh]``; q_scale/k_scale: ``[dh]``;
    cos/sin: ``[N, dh/2]`` fp32 (the first Nq rows rotate q, the first Nk k).
    """
    q_t = headmajor_rope(headmajor_rmsnorm(q, q_scale, EPS), cos[:q.shape[2]], sin[:q.shape[2]])
    k_t = headmajor_rope(headmajor_rmsnorm(k, k_scale, EPS), cos[:k.shape[2]], sin[:k.shape[2]])
    return reference_attention(q_t, k_t, v, scale)


def flash_attention_normrope(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             q_scale: torch.Tensor, k_scale: torch.Tensor,
                             cos: torch.Tensor, sin: torch.Tensor,
                             mask: Optional[torch.Tensor] = None,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Attention over RAW head-major q/k with QKNorm + RoPE in the kernel.

    CPU tensors take ``reference_attention_normrope``. CUDA tensors launch
    the kernel (bf16 q/k/v with unit stride on an even dh <= 128, fp32
    scales and tables) or raise. Key-padding masks are not ported yet and
    raise on every device.
    """
    if mask is not None:
        raise NotImplementedError("flash_attention_normrope: key-padding masks are not ported yet")
    if q.device.type == "cpu":
        return reference_attention_normrope(q, k, v, q_scale, k_scale, cos, sin, scale)
    _check(q, k, v)
    b, h, nq, dh = q.shape
    nk = k.shape[2]
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
    scale = dh ** -0.5 if scale is None else scale
    out = torch.empty((b, nq, h, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    global launches
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _build.launch("lam_flash_attention_normrope_fwd", q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), q_scale.data_ptr(), k_scale.data_ptr(),
                      cos.data_ptr(), sin.data_ptr(), b, h, nq, nk, dh, *strides,
                      float(scale), stream)
    launches += 1
    return out
