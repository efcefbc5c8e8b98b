"""Attention over short self-attention axes: CUDA kernel K9 (forward and
backward) and its plain PyTorch versions.

Counterpart of ``lam_slide_tpu/ops/short_attention.py`` (``_short_fwd_kernel``
and ``_short_bwd_kernel`` through ``short_attention``): unmasked
self-attention over packed ``[B, n, H*dh]`` operands with 8 < n < 128, the
stage-2 DiT's temporal axis for MD17, pedestrian and NBA (T=20..30). The
kernels live in ``csrc/short_attention.cu``, q/k/v read through packed
strides, the n x n scores kept on chip. Both run on the tensor cores
(mma.sync): a persistent block takes a group of heads (a warp each) over
batch rows, loading whole rows double-buffered by cp.async and storing
whole rows from a shared tile. The forward keeps the scores of n <= 32 in
registers and computes them twice for longer rows (statistics, then P V);
the backward holds its item's S and dP in registers for n <= 32 and forms
all three grads in one pass. ``fwd_heads_per_block`` and
``bwd_heads_per_block`` choose the groups.

On CUDA tensors that need a gradient the forward runs inside
``_ShortAttention`` (the JAX ``custom_vjp``), whose backward is the K9
backward kernel.

fp32 operands (the MD17 test pass's fp32 DiT, and the fp32 stage-2
training of both registries) take the kernels of
``csrc/short_attention_f32.cu`` on FFMA (no TF32): persistent blocks over
items, an item one batch row's group of heads whose whole rows are copied
by cp.async into shared memory. The forward forms each query
row's logits once in registers, a thread two rows of a head
(``f32_fwd_plan`` sizes its blocks); the backward forms S and dP once a
query chunk into shared memory, takes the row statistics a thread a row,
then dV, dK and dQ as outer-product tiles (``f32_bwd_plan``).

Counters (plain integers, touched only where a kernel launches):
``launches`` the forward kernel in both dtypes, ``fp32_launches`` its fp32
launches, ``bwd_launches`` the backward kernel in both dtypes,
``bwd_fp32_launches`` its fp32 launches.
"""

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from lam_slide_tpu_torch.ops import _build
from lam_slide_tpu_torch.ops._grad import needs_grad
from lam_slide_tpu_torch.ops.flash_attention import _heads, _stream, reference_attention_packed

launches = 0
fp32_launches = 0
bwd_launches = 0
bwd_fp32_launches = 0

MAX_DH = 64  # the kernels keep a 16-row block's accumulators in registers
FWD_MAX_HEADS = 8  # warps (heads) a forward block
BWD_MAX_HEADS = 8  # warps (heads) a backward block
SMEM_MAX = 232448  # the most dynamic shared memory an H100 block takes


def _padded_dh(dh: int) -> int:
    return 16 if dh <= 16 else 32 if dh <= 32 else 64


def bwd_smem_bytes(n: int, dh: int, heads_per_block: int) -> int:
    """Shared memory of a K9 backward block (``bwd::smem_bytes`` in
    csrc/short_attention.cu): eleven bf16 tiles (two stages of q/k/v/dO, and
    dq/dk/dv) of n rounded up to 32 rows by heads_per_block · dh-padded + 8
    columns, and past 32 rows three fp32 row statistics a head."""
    rows = -(-n // 32) * 32
    row = heads_per_block * _padded_dh(dh) + 8
    stats = heads_per_block * 3 * rows * 4 if rows > 32 else 0
    return 11 * rows * row * 2 + stats


def fwd_smem_bytes(n: int, dh: int, heads_per_block: int) -> int:
    """Shared memory of a K9 forward block (``fwd::smem_bytes`` in
    csrc/short_attention.cu): seven bf16 tiles (two stages of q/k/v, and the
    output) of n rounded up to 32 rows by heads_per_block · dh-padded + 8
    columns."""
    rows = -(-n // 32) * 32
    return 7 * rows * (heads_per_block * _padded_dh(dh) + 8) * 2


def fwd_heads_per_block(n: int, num_heads: int, dh: int) -> int:
    """Heads a K9 forward block takes: the heads split into as few groups of
    at most FWD_MAX_HEADS as they go, evenly (16 heads -> 8 + 8, 11 -> 6 +
    5), then fewer while the block's shared memory exceeds SMEM_MAX."""
    groups = -(-num_heads // FWD_MAX_HEADS)
    hb = -(-num_heads // groups)
    while hb > 1 and fwd_smem_bytes(n, dh, hb) > SMEM_MAX:
        hb -= 1
    return hb


def bwd_heads_per_block(n: int, num_heads: int, dh: int) -> int:
    """Heads a K9 backward block takes: the heads split into as few groups
    of at most BWD_MAX_HEADS as they go, evenly (16 heads -> 8 + 8, 11 ->
    6 + 5), then fewer while the block's shared memory exceeds SMEM_MAX."""
    groups = -(-num_heads // BWD_MAX_HEADS)
    hb = -(-num_heads // groups)
    while hb > 1 and bwd_smem_bytes(n, dh, hb) > SMEM_MAX:
        hb -= 1
    return hb


# The fp32 kernels (csrc/short_attention_f32.cu): persistent blocks over
# items, an item one batch row's group of heads, its rows in shared memory
# on one stage, which leaves room for more blocks an SM: on an H100 at
# MD17's [12288, 30, 256] two stages lost in both kernels
# (tools/kernel_variants.py K9-fp32).
F32_BLOCK_THREADS = 64  # threads a block aims at (fewer heads an item past it)
F32_MAX_THREADS = 256
F32_KV_TILES = 2  # the backward's dK/dV tiles a thread at most (``bwd::W``)


class F32ShortPlan(NamedTuple):
    """An fp32 K9 kernel's launch for one call: ``heads`` of one batch row
    an item (a block's unit of work), ``threads`` a block, and the block's
    dynamic shared memory, which the kernel sizes alike from the same
    geometry and refuses past SMEM_MAX."""
    heads: int
    threads: int
    smem_bytes: int


def _tile_ld(heads: int, dp: int) -> int:
    """Row stride (floats) of a staged tile (``tile_ld``): heads * dp rounded
    up to 32, plus 4."""
    return -(-heads * dp // 32) * 32 + 4


def _even_heads(num_heads: int, most: int) -> int:
    """The heads split into as few groups of at most ``most`` as they go,
    evenly (16 heads at most 8 -> 8 + 8, 11 -> 6 + 5): a group's size."""
    groups = -(-num_heads // max(1, most))
    return -(-num_heads // groups)


def f32_fwd_plan(n: int, dh: int, num_heads: int) -> F32ShortPlan:
    """The fp32 forward's plan (``lam_short_attention_fwd_f32`` in
    csrc/short_attention_f32.cu takes heads and threads from it): a thread
    owns R query rows of one head (the kernel's: 2 for n <= 64, 1 past it,
    where a row's logits fill 128 registers), so a head takes G = ceil(n /
    R) threads; an item holds as many heads as keep a block at
    F32_BLOCK_THREADS (MD17's 16 x dh 16: 4 heads, 60 threads), split
    evenly; its q, k and v rows (G * R rows of ``_tile_ld`` floats each,
    dh padded to a multiple of 4)."""
    rows = 2 if n <= 64 else 1
    g = -(-n // rows)
    heads = _even_heads(num_heads, F32_BLOCK_THREADS // g)
    ld = _tile_ld(heads, -(-dh // 4) * 4)
    return F32ShortPlan(heads, -(-heads * g // 32) * 32, 4 * 3 * g * rows * ld)


def f32_bwd_plan(n: int, dh: int, num_heads: int) -> F32ShortPlan:
    """The fp32 backward's plan (``bwd::geometry`` in
    csrc/short_attention_f32.cu): keys padded to np = ceil4(n), query chunks
    of qc = np rows (64 past 64), whole chunks staged; a thread holds 4 keys
    x 4 columns of dK and dV (a head takes np / 4 * dp / 4 such tiles, dp
    dh padded to a multiple of 4, at most F32_KV_TILES a thread); an item
    holds as many heads as keep those tiles at F32_BLOCK_THREADS (MD17's 16
    x dh 16: 2 heads, 64 threads), split evenly; its q, k, v and dO rows,
    then its S and dP (qc rows of ldp floats a head, plus 4)."""
    dp = -(-dh // 4) * 4
    np_ = -(-n // 4) * 4
    qc = np_ if np_ <= 64 else 64
    nr = -(-np_ // qc) * qc
    ldp = np_ if (np_ // 4) % 2 else np_ + 4
    tiles = (np_ // 4) * (dp // 4)
    heads = _even_heads(num_heads, F32_BLOCK_THREADS // tiles)
    units = heads * tiles
    threads = min(F32_MAX_THREADS,
                  -(-max(min(units, F32_BLOCK_THREADS), -(-units // F32_KV_TILES)) // 32) * 32)
    return F32ShortPlan(heads, threads,
                        4 * (4 * nr * _tile_ld(heads, dp) + 2 * heads * (qc * ldp + 4)))


def reference_short_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              num_heads: int, scale: Optional[float] = None) -> torch.Tensor:
    """Plain K9 forward, packed ``[B, n, H*dh]`` in and out: fp32 logits and
    softmax, weights cast to ``v.dtype`` for the AV product (``_scores``,
    short_attention.py:73-80) — the plain packed attention."""
    return reference_attention_packed(q, k, v, num_heads, scale)


def reference_short_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             g: torch.Tensor, num_heads: int,
                             scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_short_bwd_kernel``'s formulas on packed ``[B, n, H*dh]`` tensors ->
    (dq, dk, dv) in q's dtype (short_attention.py:96-126).

    P = softmax(q kᵀ · scale) in fp32; dV = bf16(P)ᵀ dO; dP = dO vᵀ;
    delta = rowsum(P ⊙ dP) with P in fp32; dS = (P ⊙ (dP − delta) · scale)
    rounded to the input dtype; dQ = dS k; dK = dSᵀ q; fp32 accumulation.
    """
    dtype = q.dtype
    qh, kh, vh = (_heads(t, num_heads).float() for t in (q, k, v))
    do = _heads(g.to(dtype), num_heads).float()
    w = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) * scale, dim=-1)
    dv = torch.matmul(w.to(dtype).float().transpose(-1, -2), do)
    dp = torch.matmul(do, vh.transpose(-1, -2))
    delta = (w * dp).sum(dim=-1, keepdim=True)
    ds = (w * (dp - delta) * scale).to(dtype).float()
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    return tuple(t.transpose(1, 2).reshape(q.shape).to(dtype) for t in (dq, dk, dv))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
           dtypes=(torch.bfloat16, torch.float32)) -> None:
    if q.dtype not in dtypes:
        raise ValueError(f"short_attention: q must be one of {dtypes}, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"short_attention: {name} must be on q's CUDA device, got {t.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"short_attention: {name} must be {q.dtype} like q, got {t.dtype}")
        if t.shape != q.shape or t.dim() != 3:
            raise ValueError(f"short_attention: {name} must be [B, n, H*dh] like q "
                             f"{tuple(q.shape)}, got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"short_attention: {name} needs unit stride on the last axis, "
                             f"got {t.stride()}")
    n, d_all = q.shape[1], q.shape[2]
    if not 8 < n < 128:
        raise ValueError(f"short_attention: sequence length {n} is not in (8, 128)")
    if d_all % num_heads or not 0 < d_all // num_heads <= MAX_DH:
        raise ValueError(f"short_attention: width {d_all} does not split into {num_heads} heads "
                         f"of dh <= {MAX_DH}")


def _forward(q, k, v, num_heads: int, scale: float) -> torch.Tensor:
    """Launch the K9 forward on checked CUDA tensors -> packed output."""
    _check(q, k, v, num_heads)
    b, n, d_all = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:2]]
    dh = d_all // num_heads
    fp32 = q.dtype == torch.float32
    global launches, fp32_launches
    with torch.cuda.device(q.device):
        if fp32:
            plan = f32_fwd_plan(n, dh, num_heads)
            _build.launch("lam_short_attention_fwd_f32", q.data_ptr(), k.data_ptr(),
                          v.data_ptr(), out.data_ptr(), b, num_heads, n, dh, plan.heads,
                          plan.threads, *strides, float(scale), _stream(q))
        else:
            _build.launch("lam_short_attention_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), b, num_heads, n, dh,
                          fwd_heads_per_block(n, num_heads, dh), *strides, float(scale),
                          _stream(q))
    launches += 1
    fp32_launches += fp32
    return out


class _ShortAttention(torch.autograd.Function):
    """K9 forward and backward: ``_short_core``'s VJP."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, scale):
        ctx.save_for_backward(q, k, v)
        ctx.num_heads, ctx.scale = num_heads, scale
        return _forward(q, k, v, num_heads, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*short_attention_backward(q, k, v, g, ctx.num_heads, ctx.scale), None, None)


def short_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q kᵀ · scale) v per head over packed ``[B, n, H*dh]`` operands
    of one shape, 8 < n < 128 -> packed ``[B, n, H*dh]``.

    CPU tensors take ``reference_short_attention``. CUDA tensors launch K9
    (bf16 or fp32, one dtype, dh <= 64, unit stride on the last axis) or
    raise; when they need a gradient, through ``_ShortAttention``, whose
    backward is K9's backward in the same dtype.
    """
    scale = float((q.shape[-1] // num_heads) ** -0.5 if scale is None else scale)
    if q.device.type == "cpu":
        return reference_short_attention(q, k, v, num_heads, scale)
    if needs_grad(q, k, v):
        return _ShortAttention.apply(q, k, v, num_heads, scale)
    return _forward(q, k, v, num_heads, scale)


def short_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             g: torch.Tensor, num_heads: int,
                             scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``short_attention`` from its inputs and the output
    gradient g, all packed ``[B, n, H*dh]``.

    CPU tensors take ``reference_short_backward``. CUDA tensors launch K9's
    backward kernel (bf16 or fp32, dh <= 64) or raise; g is cast to q's
    dtype first, as ``_short_core_bwd`` does.
    """
    if q.device.type == "cpu":
        return reference_short_backward(q, k, v, g, num_heads, scale)
    _check(q, k, v, num_heads)
    g = g.to(q.dtype)
    if g.shape != q.shape or g.device != q.device:
        raise ValueError(f"short_attention_backward: g must be {tuple(q.shape)} on {q.device}, "
                         f"got {tuple(g.shape)} on {g.device}")
    if g.stride(-1) != 1:
        g = g.contiguous()
    b, n, d_all = q.shape
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3))
    strides = (ctypes.c_longlong * 8)(*(s for t in (q, k, v, g) for s in t.stride()[:2]))
    dh = d_all // num_heads
    fp32 = q.dtype == torch.float32
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, num_heads, n, dh)
    global bwd_launches, bwd_fp32_launches
    with torch.cuda.device(q.device):
        if fp32:
            plan = f32_bwd_plan(n, dh, num_heads)
            _build.launch("lam_short_attention_bwd_f32", *ptrs, plan.heads, plan.threads,
                          strides, dq.stride(0), dq.stride(1), float(scale), _stream(q))
        else:
            _build.launch("lam_short_attention_bwd", *ptrs,
                          bwd_heads_per_block(n, num_heads, dh), strides, dq.stride(0),
                          dq.stride(1), float(scale), _stream(q))
    bwd_launches += 1
    bwd_fp32_launches += fp32
    return dq, dk, dv
