"""Flash attention: CUDA kernels K1 (forward), its packed entry K3 and K4
(the FlashAttention-2 backward), and their plain PyTorch versions.

Counterpart of ``lam_slide_tpu/ops/flash_attention.py``: ``_flash_kernel``
through ``flash_attention`` (K1), ``_packed_manual_kernel`` through
``flash_attention_packed`` (K3) and ``_flash_bwd_kv_kernel`` /
``_flash_bwd_q_kernel`` through ``_flash_backward`` (K4). The bf16
forward without a mask lives in ``csrc/flash_fwd_sm90.cu`` (TMA-fed wgmma
tiles, the softmax in registers), its backward in ``csrc/flash_bwd_sm90.cu``
(dK, dV and dQ in one pass over the scores); the masked and fp32 variants
keep ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``. All
read q/k/v through (batch, head, seq) strides, so head-major views of a
packed ``[B, N, H*dh]`` buffer go in without a copy, and write packed
memory, so ``out.transpose(1, 2).reshape(B, N, H*dh)`` is a view. K3 is
the same binary called on packed views: no copy in and none out.

The redesigned kernels load tiles with TMA when every operand allows it
(``sm90_tma_ok``: dh % 8 == 0, 16-byte aligned bases and strides) and
otherwise with cp.async, a second route of the same kernels.

K1 also takes a ``[B, Nk]`` boolean key-padding mask (True = attend), which
becomes the fp32 bias row of ``_mask_to_bias`` (0 or -0.7·finfo(fp32).max,
flash_attention.py:624-629) added to the scaled logits in the kernel, and
fp32 operands (stage 1 and the fp32 DiTs), through register-tiled kernels
with fp32 in and out: up to dh 64 the narrow kernel (a thread a 4 x 4 block
of the scores and, over a quarter of each key tile, a 4 x dh/4 block of the
output; dh padded to a multiple of 8) in ``f32_narrow_fwd_plan``'s
geometry, above it up to dh 128 the wide kernel (a thread a 4 x 4 block of
the scores and a 4 x 8 block of the output) in ``f32_wide_plan``'s.
K4 takes both too: the bias row in both of its kernels (JAX
``_bwd_probs``), and fp32 operands through register-tiled kernels (a
thread a 4 x 4 block of S and dP and a register tile of each grad): up to
dh 64 the narrow kernel in ``f32_narrow_plan``'s geometry (dh padded to a
multiple of 8, two blocks an SM), above it up to dh 128
(``F32_GRAD_MAX_DH``) the wide kernel in ``f32_wide_plan``'s; each makes
one pass over the key tiles, forms S and dP once and writes dK, dV and
each tile's share of dQ, which a second kernel sums where there is more
than one.
The packed entry K3 stays unmasked, as in JAX.

Gradients: on CUDA tensors that need one, the forward runs inside
``_FlashAttention`` (the JAX ``custom_vjp``), which asks K1 for the per-row
log-sum-exp, keeps the mask, and whose backward launches K4's two kernels.
The packed entry differentiates through the same Function on its head-major
views.

Counters (plain integers, touched only where a kernel launches):
``launches`` counts K1 calls of both entries and both dtypes,
``bias_launches`` those with a key-padding bias, ``fp32_launches`` those
with fp32 operands, ``fp32_narrow_launches`` those of them at dh <= 64
(the narrow kernel), ``fp32_wide_launches`` those at 64 < dh <= 128
(the wide kernel), ``sm90_launches`` the redesigned forward's
launches and
``sm90_cp_async_launches`` those of them on the cp.async route.
``bwd_kv_launches`` and ``bwd_q_launches`` each count K4 calls,
``bwd_bias_launches`` the bf16 or fp32 kernels with the bias (two a bf16
call), ``bwd_fp32_launches`` the fp32 kernels (one or two a call,
``f32_dq_tiles``),
``bwd_fp32_wide_launches`` those of them at 64 < dh <= 128,
``bwd_sm90_launches`` the redesigned backward's kernels (its
preprocess, main and dQ kernels: three per call) and
``bwd_sm90_cp_async_launches`` its main kernels on the cp.async route.
"""

import ctypes
import sys
from typing import NamedTuple, Optional, Tuple

import torch

from lam_slide_tpu_torch.ops import _build
from lam_slide_tpu_torch.ops._grad import needs_grad

launches = 0
bias_launches = 0
fp32_launches = 0
fp32_narrow_launches = 0
fp32_wide_launches = 0
bwd_kv_launches = 0
bwd_q_launches = 0
bwd_bias_launches = 0
bwd_fp32_launches = 0
bwd_fp32_wide_launches = 0
sm90_launches = 0
sm90_cp_async_launches = 0
bwd_sm90_launches = 0
bwd_sm90_cp_async_launches = 0

NEG_INF = -0.7 * torch.finfo(torch.float32).max  # the JAX kernels' mask fill
MAX_DH = 128  # every forward kernel, bf16 and fp32 (register-tiled above 64 in fp32)
# K4's fp32 kernels: the narrow one up to dh 64, the wide one above it
# up to this; an fp32 call that needs a gradient stays within it.
F32_GRAD_MAX_DH = 128
# The register-tiled fp32 kernels at 64 < dh <= 128 (csrc/flash_attention.cu
# WideLayout<64>, csrc/flash_attention_bwd.cu WideBwdLayout): 64-row blocks
# of 256 threads over tiles of 64, dh padded to 128; the forward two blocks
# an SM, the backward one.
F32_WIDE_MIN_DH = 65
F32_WIDE_SHORT = 32  # Nq and Nk at most this: two sequences share a 64-row block


def f32_wide_smem_bytes() -> int:
    """Shared memory of a register-tiled fp32 block (``WideLayout<64>`` in
    csrc/flash_attention.cu): Q and K [64, 132] (P^T over K), V [64, 128],
    the bias slice [64], alpha and l [64]."""
    return 4 * (64 * 132 + 64 * 132 + 64 * 128 + 64 + 2 * 64)


def f32_wide_plan(nq: int, nk: int) -> int:
    """Sequences a 64-row block of the register-tiled fp32 kernels (K1's
    forward, K4's wide kernel) for nq queries over nk keys: two where both
    axes are at most 32 (MD17's temporal axis, T = 30), so its blocks are
    not three quarters empty, else one."""
    return 2 if nq <= F32_WIDE_SHORT and nk <= F32_WIDE_SHORT else 1


# K4's fp32 kernel at dh <= 64 (csrc/flash_attention_bwd.cu NarrowLayout):
# blocks of 256 threads over 64-key tiles, dh padded to the first of these
F32_NARROW_DPS = (8, 16, 24, 32, 48, 64)
F32_NARROW_THREADS = 256
F32_NARROW_ROWS = 64
SM_SHARED_BYTES = 233472  # an H100 SM's 228 KB, 1 KB of it reserved for each block
SM_REGISTERS = 65536


class F32NarrowPlan(NamedTuple):
    """Geometry of K4's narrow fp32 kernel for one call: the padded width
    ``dp``; the columns of dK and dV a thread sums (``cols``) and the slices
    of a query tile's rows that many threads sum apart (``slices``); a
    block's dynamic shared memory; its blocks (one a 64-key tile); and the
    blocks an SM holds (shared memory and the 128 registers a thread that
    ``__launch_bounds__`` asks for)."""
    dp: int
    cols: int
    slices: int
    smem_bytes: int
    blocks: int
    blocks_per_sm: int


def f32_narrow_plan(dh: int, nq: int, nk: int, bh: int = 1) -> F32NarrowPlan:
    """The narrow fp32 kernel's plan (csrc/flash_attention_bwd.cu
    NarrowLayout and NarrowSplit) for ``bh`` sequences of nq queries over nk
    keys at head dim dh <= 64: dh padded to the next of F32_NARROW_DPS; a
    thread holds 4 keys and 4 or 6 columns of dK and of dV (48 accumulators
    at most). A block's shared memory: K and V, two stages of Q and dO (64
    rows of dp + 4 floats each), P and dS (64 x 68) and two stages of the
    query tile's lse and delta; the slices' partial sums, 64 rows of dp + 1
    floats each, overlay it at the end."""
    if not 0 < dh <= F32_NARROW_DPS[-1]:
        raise ValueError(f"f32_narrow_plan: dh {dh} is not in (0, {F32_NARROW_DPS[-1]}]")
    dp = next(p for p in F32_NARROW_DPS if dh <= p)
    cols = 6 if dp % 6 == 0 else 4
    slices = F32_NARROW_THREADS // (16 * (dp // cols))
    rows = F32_NARROW_ROWS
    smem = 4 * (6 * rows * (dp + 4) + 2 * rows * (rows + 4) + 4 * rows)
    per_sm = min(SM_SHARED_BYTES // (smem + 1024), SM_REGISTERS // (128 * F32_NARROW_THREADS))
    return F32NarrowPlan(dp, cols, slices, smem, bh * -(-nk // rows), per_sm)


class F32NarrowFwdPlan(NamedTuple):
    """Geometry of K1's narrow fp32 kernel for one call: the padded width
    ``dp``, the keys of a tile (``keys``) and a block's dynamic shared
    memory."""
    dp: int
    keys: int
    smem_bytes: int


def f32_narrow_fwd_smem_bytes(dp: int, keys: int) -> int:
    """Shared memory of a narrow fp32 forward block (``NarrowFwdLayout`` in
    csrc/flash_attention.cu): Q (64 rows) and two stages of K and V (``keys``
    rows each) of dp + 4 floats, P^T (``keys`` x 68), two stages of the bias
    slice; the four key slices' partial outputs (4 x 64 rows of dp + 1)
    overlay them at the end; then alpha and l (64 each)."""
    rows = F32_NARROW_ROWS
    tiles = (rows + 4 * keys) * (dp + 4) + keys * (rows + 4) + 2 * keys
    return 4 * (max(tiles, 4 * rows * (dp + 1)) + 2 * rows)


def f32_narrow_fwd_plan(dh: int, nk: int) -> F32NarrowFwdPlan:
    """The narrow fp32 forward's plan (csrc/flash_attention.cu
    ``flash_fwd_f32_narrow_kernel``, which takes dp and keys from it) over nk
    keys at head dim dh <= 64: dh padded to the next of F32_NARROW_DPS, as
    K4's narrow kernel pads it; key tiles of 32 where nk <= 32 (stage 1's
    32 padded atoms fill one), else 64."""
    if not 0 < dh <= F32_NARROW_DPS[-1]:
        raise ValueError(f"f32_narrow_fwd_plan: dh {dh} is not in (0, {F32_NARROW_DPS[-1]}]")
    dp = next(p for p in F32_NARROW_DPS if dh <= p)
    keys = 32 if nk <= 32 else 64
    return F32NarrowFwdPlan(dp, keys, f32_narrow_fwd_smem_bytes(dp, keys))


def f32_dq_tiles(dh: int, nq: int, nk: int) -> int:
    """Key tiles whose dQ shares K4's fp32 kernel keeps in scratch, fp32
    ``[tiles, B*H, nq, dh]``, for a second kernel to sum: 1 (no scratch,
    one kernel, which writes dQ itself) where one 64-key tile holds every
    key, or at dh > 64 one block of two short sequences does
    (``f32_wide_plan`` 2)."""
    if dh >= F32_WIDE_MIN_DH and f32_wide_plan(nq, nk) == 2:
        return 1
    return -(-nk // 64)


def sm90_tma_ok(*tensors: torch.Tensor) -> bool:
    """Whether TMA can load every one of these bf16 ``[B, H, N, dh]`` views
    (unit stride on dh): dh a multiple of 8, every base address and every
    stride of an axis longer than 1 a multiple of 16 bytes. Otherwise the
    redesigned kernels take their cp.async route."""
    for t in tensors:
        if t.shape[-1] % 8 or t.data_ptr() % 16:
            return False
        if any(size > 1 and (stride * t.element_size()) % 16
               for size, stride in zip(t.shape[:3], t.stride()[:3])):
            return False
    return True


def mask_to_bias(mask: torch.Tensor) -> torch.Tensor:
    """Boolean key-padding mask ``[B, Nk]`` (True = attend) -> the additive
    fp32 bias row of ``_mask_to_bias`` (flash_attention.py:624-629)."""
    return torch.where(mask, 0.0, NEG_INF).to(torch.float32)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None, return_lse: bool = False,
                        mask: Optional[torch.Tensor] = None):
    """Plain attention, head-major ``[B, H, N, dh]`` (ops/attention.py:44-59).

    fp32 logits (bf16 products are exact in fp32) and fp32 softmax; the
    weights are cast to ``v.dtype`` for the AV product. ``mask`` is a
    ``[B, Nk]`` boolean key-padding mask whose bias row is added to the
    scaled logits, as the kernel adds it. ``return_lse`` also returns the
    fp32 per-row log-sum-exp of the scaled logits ``[B, H, Nq]``
    (``_flash_forward(..., with_lse=True)``). The logits are scaled in place
    and dropped after the softmax, so at most two fp32 ``[B, H, Nq, Nk]``
    buffers are alive at once.
    """
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)).mul_(scale)
    if mask is not None:
        logits.add_(mask_to_bias(mask)[:, None, None, :])
    lse = torch.logsumexp(logits, dim=-1) if return_lse else None
    weights = torch.softmax(logits, dim=-1)
    del logits
    out = torch.matmul(weights.to(v.dtype), v)
    return (out, lse) if return_lse else out


def reference_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               num_heads: int, scale: Optional[float] = None) -> torch.Tensor:
    """``reference_attention`` on packed ``[B, N, H*dh]`` operands -> packed output."""
    out = reference_attention(*(_heads(t, num_heads) for t in (q, k, v)), scale)
    return out.transpose(1, 2).reshape(q.shape)


def reference_flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                             scale: float, bias: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4's formulas on whole head-major tensors -> (dq, dk, dv) in the input
    dtypes (``_flash_backward`` and ``_bwd_probs``, flash_attention.py:411-621).

    delta = rowsum(dO ⊙ O) in fp32; P = exp(q kᵀ · scale + bias − lse) in
    fp32, with ``bias`` the forward's ``[B, Nk]`` key-padding bias row (or
    none); dV = P rounded to the input dtype, transposed, times dO; dS = (P ⊙
    (dO vᵀ − delta) · scale) rounded to the input dtype; dQ = dS k; dK = dSᵀ
    q; fp32 accumulation throughout.
    """
    dtype = q.dtype
    do = g.to(dtype).float()
    delta = (g.float() * out.float()).sum(dim=-1, keepdim=True)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)).mul_(scale)
    if bias is not None:
        s.add_(bias[:, None, None, :])
    p = s.sub_(lse.unsqueeze(-1)).exp_()
    dv = torch.matmul(p.to(dtype).float().transpose(-1, -2), do)
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    ds = (p * (dp - delta) * scale).to(dtype).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(dtype), dk.to(k.dtype), dv.to(v.dtype)


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Packed ``[B, N, H*dh]`` -> head-major ``[B, H, N, dh]`` view."""
    return t.unflatten(-1, (num_heads, t.shape[-1] // num_heads)).transpose(1, 2)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           dtypes=(torch.bfloat16,)) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be on q's CUDA device, got {t.device}")
        if t.dtype not in dtypes or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} must be one of {dtypes} like q, "
                             f"got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be [B, H, N, dh], got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} needs unit stride on dh, got {t.stride()}")
    b, h, _, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != h or k.shape[3] != dh:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not match")
    if not 0 < dh <= MAX_DH:
        raise ValueError(f"flash_attention: head dim {dh} is not in (0, {MAX_DH}]")


def _packed_like(t: torch.Tensor, n: int) -> torch.Tensor:
    """An empty head-major ``[B, H, n, dh]`` tensor in packed ``[B, n, H, dh]``
    memory, like ``t``."""
    b, h, _, dh = t.shape
    return torch.empty((b, n, h, dh), dtype=t.dtype, device=t.device).transpose(1, 2)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _bias(mask: torch.Tensor, q: torch.Tensor, nk: int) -> torch.Tensor:
    if mask.dtype != torch.bool or mask.shape != (q.shape[0], nk) or mask.device != q.device:
        raise ValueError(f"flash_attention: mask must be bool [{q.shape[0]}, {nk}] on "
                         f"{q.device}, got {mask.dtype} {tuple(mask.shape)} on {mask.device}")
    return mask_to_bias(mask).contiguous()


def _forward(q, k, v, scale: float, with_lse: bool, mask: Optional[torch.Tensor] = None):
    """Launch K1 on checked head-major CUDA tensors -> (out, lse or None).
    bf16 operands without a mask take the redesigned kernel (TMA or
    cp.async route), bf16 with a mask the tensor-core template's bias
    instantiation, fp32 operands the fp32 kernel; all write the lse when
    asked."""
    _check(q, k, v, (torch.bfloat16, torch.float32))
    fp32 = q.dtype == torch.float32
    global launches, bias_launches, fp32_launches
    if not fp32 and mask is None:
        out, lse = _launch_sm90_forward(q, k, v, scale, with_lse, sys.modules[__name__])
        launches += 1
        return out, lse
    bias = None if mask is None else _bias(mask, q, k.shape[2])
    out, lse = _launch_template_forward(q, k, v, scale, with_lse, bias, sys.modules[__name__])
    launches += 1
    bias_launches += bias is not None
    fp32_launches += fp32
    return out, lse


def _launch_template_forward(q, k, v, scale: float, with_lse: bool,
                             bias: Optional[torch.Tensor], counts):
    """The older template's forward on checked CUDA tensors -> (out in packed
    memory, lse or None): its bf16 kernel with the fp32 ``[B, Nk]`` bias row
    (which it needs), or the fp32 kernels with or without one (the narrow
    one at dh <= 64 in ``f32_narrow_fwd_plan``'s geometry, the wide one at
    64 < dh <= 128 in ``f32_wide_plan``'s). ``counts`` is the module whose
    ``fp32_narrow_launches`` / ``fp32_wide_launches`` count those kernels
    (K1's, or K5's, which runs the wide one on its transformed q/k); the
    callers count the rest."""
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    out = _packed_like(q, nq)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device) if with_lse else None
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), None if bias is None else bias.data_ptr())
    with torch.cuda.device(q.device):
        if q.dtype == torch.float32:
            wide = dh >= F32_WIDE_MIN_DH
            plan = (f32_wide_plan(nq, nk), 0) if wide else f32_narrow_fwd_plan(dh, nk)[:2]
            _build.launch("lam_flash_attention_fwd_f32", *ptrs, b, h, nq, nk, dh, *strides,
                          float(scale), *plan, _stream(q))
            if wide:
                counts.fp32_wide_launches += 1
            else:
                counts.fp32_narrow_launches += 1
        else:
            _build.launch("lam_flash_attention_fwd", *ptrs, b, h, nq, nk, dh, *strides,
                          float(scale), _stream(q))
    return out, lse


def _launch_sm90_forward(q, k, v, scale: float, with_lse: bool, counts):
    """The redesigned forward on checked bf16 CUDA tensors without a bias ->
    (out in packed memory, lse or None), on the TMA route when
    ``sm90_tma_ok`` allows it, else on the cp.async route. ``counts`` is the
    module whose ``sm90_launches`` / ``sm90_cp_async_launches`` count it
    (K1's, or K5's, which runs it on its transformed q/k)."""
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    out = _packed_like(q, nq)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device) if with_lse else None
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    tma = sm90_tma_ok(q, k, v)
    with torch.cuda.device(q.device):
        _build.launch("lam_flash_attention_fwd_sm90", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), None if lse is None else lse.data_ptr(), b, h, nq, nk, dh,
                      *strides, float(scale), int(tma), _stream(q))
    counts.sm90_launches += 1
    counts.sm90_cp_async_launches += not tma
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """K1 forward (with lse) and K4 backward: ``_flash_attention_core``'s VJP.
    The key-padding mask rides along (no grad), as JAX's bias does."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale):
        out, lse = _forward(q, k, v, scale, with_lse=True, mask=mask)
        ctx.save_for_backward(q, k, v, out, lse, mask)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, mask = ctx.saved_tensors
        return (*flash_attention_backward(q, k, v, out, lse, g, ctx.scale, mask=mask),
                None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q kᵀ · scale + bias(mask)) v over head-major ``[B, H, N, dh]``
    operands; ``mask`` is a ``[B, Nk]`` boolean key-padding mask.

    CPU tensors take ``reference_attention``. CUDA tensors launch the kernel
    (bf16 or fp32 with dh <= 128, unit stride on dh) or raise; when they
    need a gradient, through ``_FlashAttention``, whose backward is K4 with
    the same bias row and dtype.
    """
    if q.device.type == "cpu":
        return reference_attention(q, k, v, scale, mask=mask)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if needs_grad(q, k, v):
        _check_fp32_grad("flash_attention", q)
        return _FlashAttention.apply(q, k, v, mask, scale)
    return _forward(q, k, v, scale, with_lse=False, mask=mask)[0]


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of ``flash_attention`` without a mask and without a
    gradient: the fp32 per-row log-sum-exp ``[B, H, Nq]`` beside the output
    (JAX ``_flash_forward(..., with_lse=True)``), the statistics ring
    attention merges. CPU tensors take ``reference_attention``; CUDA
    tensors launch K1 or raise."""
    if q.device.type == "cpu":
        return reference_attention(q, k, v, scale, return_lse=True)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return _forward(q, k, v, scale, with_lse=True)


def _check_fp32_grad(name: str, q: torch.Tensor) -> None:
    """Raise for fp32 operands wider than K4's fp32 kernels take: their
    gradient has no kernel (csrc/flash_attention_bwd.cu stops at dh 128)."""
    if q.dtype == torch.float32 and q.shape[-1] > F32_GRAD_MAX_DH:
        raise ValueError(f"{name}: fp32 operands at head dim {q.shape[-1]} have no backward "
                         f"kernel (K4-fp32 takes dh <= {F32_GRAD_MAX_DH})")


def _check_backward(q, k, v, out, lse, g, dtypes=(torch.bfloat16,)) -> None:
    _check_fp32_grad("flash_attention_backward", q)
    _check(q, k, v, dtypes)
    b, h, nq, dh = q.shape
    for name, t in (("out", out), ("g", g)):
        if t.shape != q.shape or t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention_backward: {name} must be {tuple(q.shape)} "
                             f"{q.dtype} on {q.device}, got {tuple(t.shape)} {t.dtype}")
    if (lse.shape != (b, h, nq) or lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_backward: lse must be contiguous fp32 "
                         f"[{b}, {h}, {nq}] on {q.device}, got {tuple(lse.shape)} {lse.dtype}")


def _launch_sm90_backward(q, k, v, out, lse, g, scale, counts):
    """The redesigned K4 on checked bf16 CUDA tensors without a bias ->
    (dq, dk, dv) in packed memory; its preprocess kernel forms delta =
    rowsum(dO ⊙ O) itself. Its fp32 scratch (per-row stats and the dQ
    accumulator) is allocated here, since the kernels allocate nothing, at
    the size the C side gives. ``counts`` is the module whose
    ``bwd_sm90_launches`` / ``bwd_sm90_cp_async_launches`` count its kernels
    (K4's, or K6's, which runs it on the transformed q/k)."""
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    out = out if out.stride(-1) == 1 else out.contiguous()
    floats = _build.load_library().lam_flash_attention_bwd_sm90_scratch(b, h, nq, dh)
    scratch = torch.empty(floats, dtype=torch.float32, device=q.device)
    dq, dk, dv = _packed_like(q, nq), _packed_like(k, nk), _packed_like(v, nk)
    strides = (ctypes.c_longlong * 24)(
        *(s for t in (q, k, v, out, g, dq, dk, dv) for s in t.stride()[:3]))
    tma = sm90_tma_ok(q, k, v, g)
    with torch.cuda.device(q.device):
        _build.launch("lam_flash_attention_bwd_sm90", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), g.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
                      dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, nq, nk, dh, strides,
                      float(scale), int(tma), _stream(q))
    counts.bwd_sm90_launches += 3
    counts.bwd_sm90_cp_async_launches += not tma
    return dq, dk, dv


def _launch_template_backward(q, k, v, out, lse, g, scale, bias, counts):
    """The older template's backward on checked CUDA tensors (g with unit
    stride on dh) -> ((dq, dk, dv) in packed memory, kernels launched): its
    bf16 pair (dK/dV, then dQ) with the fp32 ``[B, Nk]`` key-padding row
    ``bias`` (which it needs), or the fp32 one-pass kernels with or without
    one (the narrow kernel at dh <= 64 in ``f32_narrow_plan``'s geometry,
    the wide one above in ``f32_wide_plan``'s), then the sum of their dQ
    shares where ``f32_dq_tiles`` is above 1; delta = rowsum(dO ⊙ O) is
    formed here. ``counts`` is the module whose ``bwd_fp32_launches`` /
    ``bwd_fp32_wide_launches`` count the fp32 kernels (K4's, or K6's, which
    runs them on its transformed q/k); the callers count the rest."""
    delta = (g.float() * out.float()).sum(dim=-1).contiguous()
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    dq, dk, dv = _packed_like(q, nq), _packed_like(k, nk), _packed_like(v, nk)
    strides = (ctypes.c_longlong * 21)(
        *(s for t in (q, k, v, g, dq, dk, dv) for s in t.stride()[:3]))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), None if bias is None else bias.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr())
    dims = (b, h, nq, nk, dh, strides, float(scale))
    fp32 = q.dtype == torch.float32
    wide = fp32 and dh >= F32_WIDE_MIN_DH
    with torch.cuda.device(q.device):
        if fp32:
            tiles = f32_dq_tiles(dh, nq, nk)
            scratch = (torch.empty((tiles, b * h, nq, dh), dtype=torch.float32, device=q.device)
                       if tiles > 1 else None)
            plan = f32_wide_plan(nq, nk) if wide else f32_narrow_plan(dh, nq, nk).dp
            _build.launch("lam_flash_attention_bwd_f32", *ptrs,
                          None if scratch is None else scratch.data_ptr(), *dims, plan,
                          _stream(q))
            kernels = 1 + (tiles > 1)
            counts.bwd_fp32_launches += kernels
            counts.bwd_fp32_wide_launches += kernels * wide
        else:
            _build.launch("lam_flash_attention_bwd_kv", *ptrs, *dims, _stream(q))
            _build.launch("lam_flash_attention_bwd_q", *ptrs, *dims, _stream(q))
            kernels = 2
    return (dq, dk, dv), kernels


def _launch_backward(q, k, v, out, lse, g, scale, bias=None):
    """Launch K4 on checked CUDA tensors -> (dq, dk, dv) in packed memory.
    bf16 without a bias takes the redesigned backward; with the fp32
    ``[B, Nk]`` key-padding row ``bias`` the old pair; fp32 operands K4's
    fp32 kernels (the narrow one up to dh 64, the wide one above)."""
    global bwd_kv_launches, bwd_q_launches, bwd_bias_launches
    g = g if g.stride(-1) == 1 else g.contiguous()
    counts = sys.modules[__name__]
    if q.dtype != torch.float32 and bias is None:
        grads = _launch_sm90_backward(q, k, v, out, lse, g, scale, counts)
    else:
        grads, kernels = _launch_template_backward(q, k, v, out, lse, g, scale, bias, counts)
        bwd_bias_launches += kernels * (bias is not None)
    bwd_kv_launches += 1
    bwd_q_launches += 1
    return grads


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                             scale: float, mask: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention`` from its output, lse and the output
    gradient g, all head-major ``[B, H, N, dh]``, and the forward's
    ``[B, Nk]`` boolean key-padding mask, if any.

    CPU tensors take ``reference_flash_backward``. CUDA tensors launch K4
    (bf16 with dh <= 128: the redesigned one-pass backward without a mask,
    the dK/dV and dQ pair with one; fp32 with dh <= F32_GRAD_MAX_DH: the
    narrow fp32 kernel up to dh 64, the wide one above) or raise; the
    grads come back in packed ``[B, N, H, dh]`` memory, so their packed
    ``[B, N, H*dh]`` form is a view.
    """
    if q.device.type == "cpu":
        return reference_flash_backward(q, k, v, out, lse, g, scale,
                                        None if mask is None else mask_to_bias(mask))
    _check_backward(q, k, v, out, lse, g, (torch.bfloat16, torch.float32))
    bias = None if mask is None else _bias(mask, q, k.shape[2])
    return _launch_backward(q, k, v, out, lse, g, scale, bias=bias)


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           num_heads: int, scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q kᵀ · scale) v per head over packed ``[B, N, H*dh]`` operands
    (views with unit stride on the last axis) -> packed ``[B, N, H*dh]``.

    CPU tensors take ``reference_attention_packed``. CUDA tensors launch K1
    on head-major strided views of the same memory (no copy) or raise; the
    gradient flows through the same views into K4.
    """
    if q.device.type == "cpu":
        return reference_attention_packed(q, k, v, num_heads, scale)
    if q.dim() != 3 or q.shape[-1] % num_heads:
        raise ValueError(f"flash_attention_packed: q must be [B, N, H*dh] with H={num_heads}, "
                         f"got {tuple(q.shape)}")
    out = flash_attention(*(_heads(t, num_heads) for t in (q, k, v)), scale=scale)
    return out.transpose(1, 2).reshape(q.shape)
