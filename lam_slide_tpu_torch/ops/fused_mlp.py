"""Fused MLP branch: CUDA kernel K2 and its plain PyTorch version.

Counterpart of ``lam_slide_tpu/ops/fused_mlp.py`` (``_mlp_kernel`` through
``fused_mlp``): ``gelu(x @ w1 + b1) @ w2`` with fp32 output, the mid rounded
once to the activation dtype, exact GELU, and the gelu intermediate kept in
shared memory (``csrc/fused_mlp.cu``).

Weights use the JAX layout ``w1 [d_in, d_mid]``, ``w2 [d_mid, d_out]``. On
CUDA the kernel takes them as transposed views of torch ``nn.Linear``
weights (``weight[rows].t()``, so ``stride(0) == 1``), which is how the DiT
holds them.

Gradients: on CUDA tensors that need one, the kernel runs inside
``_FusedMLP``, whose backward is autograd of ``reference_mlp`` on the saved
inputs (``_fused_mlp_bwd``, fused_mlp.py:125-128); no backward kernel.

``launches`` counts kernel launches; nothing else touches it.
"""

import torch

from lam_slide_tpu_torch.nn.blocks import gelu_exact
from lam_slide_tpu_torch.ops import _build
from lam_slide_tpu_torch.ops._grad import needs_grad, plain_vjp

launches = 0


def reference_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor) -> torch.Tensor:
    """Plain version: bf16 mid (one rounding after the fp32 dot + bias),
    exact GELU rounded to the activation dtype, fp32 output. The fp32
    matmuls of bf16 values keep every product exact, as a bf16 GEMM with
    fp32 accumulation does."""
    mid = (torch.matmul(x.float(), w1.float()) + b1.float()).to(x.dtype)
    return torch.matmul(gelu_exact(mid).float(), w2.float())


def _check(x, w1, b1, w2) -> None:
    for name, t in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"fused_mlp: {name} must be on x's CUDA device, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"fused_mlp: {name} must be bfloat16, got {t.dtype}")
    d_in, d_mid = w1.shape
    if x.shape[-1] != d_in or b1.shape != (d_mid,) or w2.shape[0] != d_mid:
        raise ValueError(f"fused_mlp: shapes x {tuple(x.shape)} w1 {tuple(w1.shape)} "
                         f"b1 {tuple(b1.shape)} w2 {tuple(w2.shape)} do not match")
    if d_in % 16 or d_mid % 16 or w2.shape[1] % 16:
        raise ValueError("fused_mlp: d_in, d_mid and d_out must be multiples of 16")
    for name, w in (("w1", w1), ("w2", w2)):
        if w.stride(0) != 1 or w.stride(1) % 8 or w.data_ptr() % 32:
            raise ValueError(f"fused_mlp: {name} must be a transposed nn.Linear weight view "
                             f"(stride(0) == 1, stride(1) % 8 == 0, 32-byte aligned), "
                             f"got strides {w.stride()}")
    if b1.stride(0) != 1:
        raise ValueError("fused_mlp: b1 must be contiguous")


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor) -> torch.Tensor:
    """gelu(x @ w1 + b1) @ w2 -> fp32 ``[..., d_out]``.

    CPU tensors take ``reference_mlp``; CUDA tensors launch the kernel or
    raise, through ``_FusedMLP`` when they need a gradient.
    """
    if x.device.type == "cpu":
        return reference_mlp(x, w1, b1, w2)
    if needs_grad(x, w1, b1, w2):
        return _FusedMLP.apply(x, w1, b1, w2)
    return _launch(x, w1, b1, w2)


class _FusedMLP(torch.autograd.Function):
    """K2 forward, autograd of ``reference_mlp`` backward."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2):
        ctx.save_for_backward(x, w1, b1, w2)
        return _launch(x, w1, b1, w2)

    @staticmethod
    def backward(ctx, g):
        return plain_vjp(reference_mlp, ctx.saved_tensors, ctx.needs_input_grad, (g,))


def _launch(x, w1, b1, w2) -> torch.Tensor:
    """Launch K2 on CUDA tensors (checked here) -> fp32 ``[..., d_out]``."""
    _check(x, w1, b1, w2)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.stride(1) != 1:
        raise ValueError(f"fused_mlp: x needs unit stride on its last axis, got {x.stride()}")
    rows, d_in = x2.shape
    d_mid, d_out = w2.shape
    out = torch.empty((rows, d_out), dtype=torch.float32, device=x.device)
    global launches
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.launch("lam_fused_mlp_fwd", x2.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                      w2.data_ptr(), out.data_ptr(), rows, d_in, d_mid, d_out,
                      x2.stride(0), w1.stride(1), w2.stride(1), out.stride(0), stream)
    launches += 1
    return out.reshape(*lead, d_out)
