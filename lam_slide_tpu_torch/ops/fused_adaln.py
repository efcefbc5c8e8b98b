"""Residual + LayerNorm + AdaLN modulate: CUDA kernel K7 and its plain
PyTorch versions.

Counterpart of ``lam_slide_tpu/ops/fused_adaln.py`` (``_adaln_kernel`` and
``_residual_adaln_kernel``, public ``adaln_modulate`` and
``residual_adaln_modulate``). One kernel with a compile-time residual flag
(``csrc/fused_adaln.cu``) does each chain in one pass over the rows: x and h
read once, x_new and y written once, in 16- or 8-byte accesses, two rows in
flight a warp, the batch index's gate/shift/scale loaded once a warp. h may
be a strided view (the DiT's transposed temporal output) and the
modulation rows chunks of one tensor: neither is copied.

Numerics (fused_adaln.py:83-105): the residual rounds per op in bf16, so
``x_new`` is bit-identical to the plain version; LayerNorm statistics in
fp32; the normalized value rounds to bf16 before the modulate.

fp32 operands (the MD17 test pass's fp32 DiT) take ``lam_adaln_fwd_f32``
(``csrc/fused_adaln_f32.cu``): a warp a row, 16-byte accesses where the
pointers and strides allow them, the same formulas in fp32 (x_new again
bit-identical). All of x, h and the modulation rows share one dtype.

Gradients: on CUDA tensors that need one, the kernel runs inside
``_AdaLN`` / ``_ResidualAdaLN``, whose backward is autograd of the plain
version on the saved inputs (``_adaln_bwd`` and ``_residual_adaln_bwd``,
fused_adaln.py:160-206); no backward kernel.

The DiT calls K7 135 times an Euler-10 solve with a handful of argument
signatures, so the wrapper checks a signature (shapes, strides, dtypes,
devices and 16-byte alignment of every tensor) once and keeps its launch
arguments: at the 4AA widths the kernel takes a few microseconds of device
time, less than the checks took on the host.

``launches`` counts kernel launches of both entries in both dtypes,
``fp32_launches`` those in fp32; nothing else touches them.
"""

import ctypes
from contextlib import nullcontext
from functools import reduce
from operator import or_
from typing import Tuple

import torch

from lam_slide_tpu_torch.nn.norms import layer_norm
from lam_slide_tpu_torch.ops import _build
from lam_slide_tpu_torch.ops._grad import needs_grad, plain_vjp

launches = 0
fp32_launches = 0


def modulate(xn: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """AdaLN modulation xn * (1 + scale) + shift (reference mmdit.py:21-22)."""
    return xn * (1.0 + scale.to(xn.dtype)) + shift.to(xn.dtype)


def reference_adaln_modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
                             eps: float = 1e-6) -> torch.Tensor:
    """modulate(layer_norm(x), shift, scale)."""
    return modulate(layer_norm(x, eps=eps), shift, scale)


def reference_residual_adaln_modulate(x: torch.Tensor, h: torch.Tensor, gate: torch.Tensor,
                                      shift: torch.Tensor, scale: torch.Tensor,
                                      eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + gate·h, modulate(layer_norm(x + gate·h)))."""
    x_new = x + gate.to(x.dtype) * h
    return x_new, modulate(layer_norm(x_new, eps=eps), shift, scale)


def _mod_batch_stride(name: str, m: torch.Tensor, x: torch.Tensor) -> int:
    """Batch stride of a ``[B, 1.., D]`` modulation row set; raise on what the
    kernel cannot take."""
    b, d = x.shape[0], x.shape[-1]
    if m.device != x.device or m.dtype != x.dtype:
        raise ValueError(f"adaln: {name} must be {x.dtype} on {x.device}, got {m.dtype} "
                         f"on {m.device}")
    if m.dim() != x.dim() or m.shape[0] != b or m.shape[-1] != d or m.numel() != b * d:
        raise ValueError(f"adaln: {name} must be [B, 1.., D] for x {tuple(x.shape)}, "
                         f"got {tuple(m.shape)}")
    bf16 = x.dtype == torch.bfloat16
    if m.stride(-1) != 1 or (bf16 and ((b > 1 and m.stride(0) % 2) or m.data_ptr() % 4)):
        raise ValueError(f"adaln: {name} needs unit stride on D (in bf16 also an even batch "
                         f"stride and 4-byte alignment), got strides {m.stride()}")
    return m.stride(0)


def _as_4d(t: torch.Tensor) -> torch.Tensor:
    """``[B, ..., D]`` with 2 to 4 axes -> a ``[B, R1, R2, D]`` view."""
    while t.dim() < 4:
        t = t.unsqueeze(1)
    return t


def _launch_dims(x, h, gate, shift, scale) -> tuple:
    """Check K7's operands; return the launch's integer arguments: rows, R1,
    R2, D, h's three strides and the gate/shift/scale batch strides."""
    residual = h is not None
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"adaln: x must be bfloat16 or float32, got {x.dtype}")
    for name, t in (("x", x), ("h", h)) if residual else (("x", x),):
        if not t.is_cuda or t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"adaln: {name} must be {x.dtype} on one CUDA device, got "
                             f"{t.dtype} on {t.device}")
    even = 2 if x.dtype == torch.bfloat16 else 1  # bf16 accesses take pairs
    if not 2 <= x.dim() <= 4 or x.shape[-1] % even or x.shape[-1] > 1024 or not x.is_contiguous():
        raise ValueError(f"adaln: x must be a contiguous [B, ..., D] with 2 to 4 axes and D "
                         f"<= 1024 (even in bf16), got {tuple(x.shape)} strides {x.stride()}")
    x4 = _as_4d(x)
    h4 = _as_4d(h) if residual else x4
    if h4.shape != x4.shape or h4.stride(-1) != 1 or any(s % even for s in h4.stride()[:3]):
        raise ValueError(f"adaln: h must be {tuple(x.shape)} with unit stride on D (and even "
                         f"strides in bf16), got {tuple(h.shape)} strides {h.stride()}")
    sb = {name: _mod_batch_stride(name, m, x)
          for name, m in (("shift", shift), ("scale", scale), ("gate", gate)) if m is not None}
    return (x.numel() // x.shape[-1], x4.shape[1], x4.shape[2], x.shape[-1], *h4.stride()[:3],
            sb.get("gate", 0), sb["shift"], sb["scale"])


# signature -> the checked launch's integer arguments as one int64 array,
# for the signatures seen (cleared past _DIMS_MAX)
_DIMS = {}
_DIMS_MAX = 256


def _launch(x, h, gate, shift, scale, eps):
    """Launch K7; residual when h is given. Returns (x_new or x, y)."""
    residual = h is not None
    ops = (x, h, gate, shift, scale) if residual else (x, shift, scale)
    ptrs = [t.data_ptr() for t in ops]
    key = (*[(t.shape, t.stride(), t.dtype, t.device) for t in ops], reduce(or_, ptrs) % 4)
    dims = _DIMS.get(key)
    if dims is None:
        dims = _launch_dims(x, h, gate, shift, scale)
        if len(_DIMS) >= _DIMS_MAX:
            _DIMS.clear()
        dims = _DIMS[key] = (ctypes.c_longlong * len(dims))(*dims)
    y = torch.empty_like(x)
    x_new = torch.empty_like(x) if residual else x
    if not residual:  # the kernel reads neither h nor gate
        ptrs = [ptrs[0], ptrs[0], ptrs[1], *ptrs[1:]]
    global launches, fp32_launches
    fp32 = x.dtype == torch.float32
    # entering the device context costs host time; only another device needs it
    same = x.device.index == torch.cuda.current_device()
    with nullcontext() if same else torch.cuda.device(x.device):
        _build.launch("lam_adaln_fwd_f32" if fp32 else "lam_adaln_fwd", *ptrs, x_new.data_ptr(),
                      y.data_ptr(), dims, float(eps), residual,
                      torch.cuda.current_stream().cuda_stream)
    launches += 1
    fp32_launches += fp32
    return x_new, y


class _AdaLN(torch.autograd.Function):
    """K7 without residual forward, autograd of the plain version backward."""

    @staticmethod
    def forward(ctx, x, shift, scale, eps):
        ctx.save_for_backward(x, shift, scale)
        ctx.eps = eps
        return _launch(x, None, None, shift, scale, eps)[1]

    @staticmethod
    def backward(ctx, g):
        return (*plain_vjp(lambda *a: reference_adaln_modulate(*a, ctx.eps), ctx.saved_tensors,
                           ctx.needs_input_grad[:3], (g,)), None)


class _ResidualAdaLN(torch.autograd.Function):
    """K7 forward (two outputs), autograd of the plain version backward."""

    @staticmethod
    def forward(ctx, x, h, gate, shift, scale, eps):
        ctx.save_for_backward(x, h, gate, shift, scale)
        ctx.eps = eps
        return _launch(x, h, gate, shift, scale, eps)

    @staticmethod
    def backward(ctx, g_x, g_y):
        return (*plain_vjp(lambda *a: reference_residual_adaln_modulate(*a, ctx.eps),
                           ctx.saved_tensors, ctx.needs_input_grad[:5], (g_x, g_y)), None)


def adaln_modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """modulate(layer_norm(x), shift, scale); x ``[B, ..., D]``, shift/scale
    ``[B, 1.., D]``.

    CPU tensors take ``reference_adaln_modulate``; CUDA tensors launch the
    kernel (bf16 or fp32, one dtype, contiguous x) or raise, through
    ``_AdaLN`` when they need a gradient.
    """
    if x.device.type == "cpu":
        return reference_adaln_modulate(x, shift, scale, eps)
    if needs_grad(x, shift, scale):
        return _AdaLN.apply(x, shift, scale, eps)
    return _launch(x, None, None, shift, scale, eps)[1]


def residual_adaln_modulate(x: torch.Tensor, h: torch.Tensor, gate: torch.Tensor,
                            shift: torch.Tensor, scale: torch.Tensor,
                            eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + gate·h, modulate(layer_norm(x + gate·h))); x/h ``[B, ..., D]``,
    gate/shift/scale ``[B, 1.., D]``.

    CPU tensors take ``reference_residual_adaln_modulate``; CUDA tensors
    launch the kernel (bf16 or fp32, one dtype, contiguous x, h with unit
    stride on D) or raise, through ``_ResidualAdaLN`` when they need a
    gradient.
    """
    if x.device.type == "cpu":
        return reference_residual_adaln_modulate(x, h, gate, shift, scale, eps)
    if needs_grad(x, h, gate, shift, scale):
        return _ResidualAdaLN.apply(x, h, gate, shift, scale, eps)
    return _launch(x, h, gate, shift, scale, eps)
