"""Flash-attention forward: CUDA kernel K1, its packed entry K3, and their
plain PyTorch versions.

Counterpart of ``lam_slide_tpu/ops/flash_attention.py``: ``_flash_kernel``
through ``flash_attention`` (K1) and ``_packed_manual_kernel`` through
``flash_attention_packed`` (K3). The kernel lives in
``csrc/flash_attention.cu``; it reads q/k/v through (batch, head, seq)
strides, so head-major views of a packed ``[B, N, H*dh]`` buffer go in
without a copy, and it writes its output into packed memory, so
``out.transpose(1, 2).reshape(B, N, H*dh)`` is a view. K3 is that same
binary called on packed views: no copy in and none out.

``launches`` counts kernel launches of both entries (one binary); nothing
else touches it.
"""

from typing import Optional

import torch

from lam_slide_tpu_torch.ops import _build

launches = 0


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention, head-major ``[B, H, N, dh]`` (ops/attention.py:44-59).

    fp32 logits (bf16 products are exact in fp32) and fp32 softmax; the
    weights are cast to ``v.dtype`` for the AV product.
    """
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(weights, v)


def reference_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               num_heads: int, scale: Optional[float] = None) -> torch.Tensor:
    """``reference_attention`` on packed ``[B, N, H*dh]`` operands -> packed output."""
    out = reference_attention(*(_heads(t, num_heads) for t in (q, k, v)), scale)
    return out.transpose(1, 2).reshape(q.shape)


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Packed ``[B, N, H*dh]`` -> head-major ``[B, H, N, dh]`` view."""
    return t.unflatten(-1, (num_heads, t.shape[-1] // num_heads)).transpose(1, 2)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be on q's CUDA device, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention: {name} must be bfloat16, got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be [B, H, N, dh], got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} needs unit stride on dh, got {t.stride()}")
    b, h, _, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != h or k.shape[3] != dh:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not match")
    if not 0 < dh <= 128:
        raise ValueError(f"flash_attention: head dim {dh} is not in (0, 128]")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q kᵀ · scale) v over head-major ``[B, H, N, dh]`` operands.

    CPU tensors take ``reference_attention``. CUDA tensors launch the kernel
    (bf16 only, dh <= 128, unit stride on dh) or raise. Key-padding masks
    are not ported yet and raise on every device.
    """
    if mask is not None:
        raise NotImplementedError("flash_attention: key-padding masks are not ported yet")
    if q.device.type == "cpu":
        return reference_attention(q, k, v, scale)
    _check(q, k, v)
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    scale = dh ** -0.5 if scale is None else scale
    out = torch.empty((b, nq, h, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    global launches
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _build.launch("lam_flash_attention_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), b, h, nq, nk, dh, *strides, float(scale), stream)
    launches += 1
    return out


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           num_heads: int, scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q kᵀ · scale) v per head over packed ``[B, N, H*dh]`` operands
    (views with unit stride on the last axis) -> packed ``[B, N, H*dh]``.

    CPU tensors take ``reference_attention_packed``. CUDA tensors launch K1
    on head-major strided views of the same memory (no copy) or raise.
    """
    if q.device.type == "cpu":
        return reference_attention_packed(q, k, v, num_heads, scale)
    if q.dim() != 3 or q.shape[-1] % num_heads:
        raise ValueError(f"flash_attention_packed: q must be [B, N, H*dh] with H={num_heads}, "
                         f"got {tuple(q.shape)}")
    out = flash_attention(*(_heads(t, num_heads) for t in (q, k, v)), scale=scale)
    return out.transpose(1, 2).reshape(q.shape)
