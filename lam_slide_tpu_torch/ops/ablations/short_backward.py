"""Grouped whole-attention backward for short sequences: CUDA kernel K11 and
its plain PyTorch version.

Counterpart of ``lam_slide_tpu/ops/ablations/short_backward.py``
(``_flash_bwd_short_kernel`` through ``_flash_backward_short``): the
backward of unmasked attention over head-major ``[B, H, N, dh]`` operands
from the forward's output and per-row log-sum-exp, each (batch, head) item
held whole on chip. Its target is the MD17 stage-2 spatial axis
([64·30, 16, 192, 16]). The kernel lives in ``csrc/short_backward.cu``: in
bf16 a persistent block that loads each item whole (TMA, or cp.async where
``sm90_tma_ok`` refuses the views) and runs its five products on wgmma, a
warpgroup per 64 keys, dQ from a shared dS slab, no atomics; in fp32 an
FFMA kernel.

``group`` sets how many items one TPU program takes, so only how the TPU
grid pads; it is kept for the signature and changes nothing here.

Counter (a plain integer, touched only where the kernel launches):
``launches``, one a call (in bf16 the call runs two kernels: delta =
rowsum(g ⊙ out), outside the main kernel as JAX computes it outside its
pallas_call, then the main kernel).
"""

import ctypes
from typing import Tuple

import torch

from lam_slide_tpu_torch.ops import _build
from lam_slide_tpu_torch.ops.flash_attention import _stream, sm90_tma_ok

MAX_N = 256  # the item's q/k/v/dO stay whole in shared memory
MAX_DH = {torch.bfloat16: 64, torch.float32: 32}
launches = 0


def reference_flash_backward_short(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                                   scale: float, group: int = 8
                                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's formulas on whole head-major tensors -> (dq, dk, dv) in
    the dtypes of q, k and v (short_backward.py:41-58, 73): delta =
    rowsum(g ⊙ out) in fp32; dO = g in q's dtype; P = exp(q kᵀ · scale −
    lse) in fp32; dV = P rounded to v's dtype, transposed, times dO; dS = (P ⊙
    (dO vᵀ − delta) · scale) rounded to the operand dtype; dQ = dS k; dK = dSᵀ
    q; fp32 accumulation throughout. ``group`` does not enter."""
    del group
    dtype = v.dtype
    do = g.to(q.dtype).float()
    delta = (g.float() * out.float()).sum(dim=-1, keepdim=True)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse.unsqueeze(-1))
    dv = torch.matmul(p.to(dtype).float().transpose(-1, -2), do)
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    ds = (p * (dp - delta) * scale).to(dtype).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, out, lse, g, group: int) -> None:
    if not isinstance(group, int) or group < 1:
        raise ValueError(f"flash_backward_short: group must be a positive int, got {group!r}")
    if q.dtype not in MAX_DH:
        raise ValueError(f"flash_backward_short: q must be bf16 or fp32, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out), ("g", g)):
        if not t.is_cuda or t.device != q.device or t.dtype != q.dtype or t.dim() != 4:
            raise ValueError(f"flash_backward_short: {name} must be a [B, H, N, dh] "
                             f"{q.dtype} tensor on q's CUDA device, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    if (k.shape != (b, h, nk, dh) or v.shape != k.shape or out.shape != q.shape
            or g.shape != q.shape):
        raise ValueError(f"flash_backward_short: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} out {tuple(out.shape)} g {tuple(g.shape)} do "
                         f"not match")
    if not (0 < nq <= MAX_N and 0 < nk <= MAX_N and 0 < dh <= MAX_DH[q.dtype]):
        raise ValueError(f"flash_backward_short: lengths {nq}, {nk} must be in (0, {MAX_N}] "
                         f"and dh {dh} in (0, {MAX_DH[q.dtype]}] for {q.dtype}")
    if (lse.shape != (b, h, nq) or lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f"flash_backward_short: lse must be contiguous fp32 [{b}, {h}, {nq}] "
                         f"on {q.device}, got {lse.dtype} {tuple(lse.shape)}")


def flash_backward_short(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                         lse: torch.Tensor, g: torch.Tensor, scale: float, group: int = 8
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of unmasked attention over head-major ``[B, H, N, dh]``
    q/k/v, from its output, its fp32 lse ``[B, H, Nq]`` and the output
    gradient g (the JAX op's signature).

    CPU tensors take ``reference_flash_backward_short``. CUDA tensors launch
    K11 (bf16 with dh <= 64 or fp32 with dh <= 32, lengths <= 256) or raise;
    the grads come back as contiguous ``[B, H, N, dh]`` tensors.
    """
    if q.device.type == "cpu":
        return reference_flash_backward_short(q, k, v, out, lse, g, scale, group)
    _check(q, k, v, out, lse, g, group)
    do = g.to(q.dtype)
    q, k, v, out, do = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v, out, do))
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))
    b, h, nq, dh = q.shape
    sizes = (b, h, nq, k.shape[2], dh)
    global launches
    with torch.cuda.device(q.device):
        if q.dtype == torch.float32:
            delta = (g.float() * out.float()).sum(dim=-1).contiguous()
            strides = (ctypes.c_longlong * 21)(
                *(s for t in (q, k, v, do, dq, dk, dv) for s in t.stride()[:3]))
            _build.launch("lam_short_backward_f32", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                          dk.data_ptr(), dv.data_ptr(), *sizes, strides, float(scale), _stream(q))
        else:
            delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)  # the delta kernel's
            strides = (ctypes.c_longlong * 24)(
                *(s for t in (q, k, v, out, do, dq, dk, dv) for s in t.stride()[:3]))
            _build.launch("lam_short_backward", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                          dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *sizes, strides,
                          float(scale), int(sm90_tma_ok(q, k, v, do)), _stream(q))
    launches += 1
    return dq, dk, dv
