"""Fused MLP branch: CUDA kernel K2 and its plain PyTorch version.

Counterpart of ``lam_slide_tpu/ops/fused_mlp.py`` (``_mlp_kernel`` through
``fused_mlp``): ``gelu(x @ w1 + b1) @ w2`` with fp32 output, the mid rounded
once to the activation dtype, exact GELU, and the gelu intermediate never
leaving the chip (``csrc/fused_mlp.cu``).

Weights use the JAX layout ``w1 [d_in, d_mid]``, ``w2 [d_mid, d_out]``. On
CUDA the kernel takes them as transposed views of torch ``nn.Linear``
weights (``weight[rows].t()``, so ``stride(0) == 1``), which is how the DiT
holds them.

Three routes, all launched from ``fused_mlp``. In bf16, the Hopper kernel
(``lam_fused_mlp_sm90``: TMA-fed wgmma GEMMs back to back, the GELU in
shared memory between them) wherever ``sm90_plan`` finds a shared-memory
plan (every d_in up to 448, any d_mid and d_out), and the first port's WMMA
kernel (``lam_fused_mlp_wmma``) for wider inputs. The Hopper kernel loads x
by TMA when ``x_tma_ok`` holds, else by cp.async inside the same kernel, and
reads the GELU of each bf16 mid from a table a small kernel builds with the
same fp32 formula before it (one launch of K2 is the pair). In fp32 (the
MD17 test pass's fp32 DiT and the 4AA eval's), FFMA kernels in
``csrc/fused_mlp_f32.cu``, no TF32: the outer-product kernel
(``lam_fused_mlp_f32_tiled``, a thread a block of the output in registers,
16 x 8 floats at MD17's widths) for the widths ``tiled_plan`` has an
instance for (every width the registries build in fp32), on contiguous
copies of w1's and w2's transposed views the wrapper makes each call
(0.5 MB each at MD17, 1.2 MB at 4AA); the dot-product kernel
(``lam_fused_mlp_f32``, its d_mid chunks double-buffered by cp.async where
``f32_plan`` finds room) for the others. The mid is not rounded there, as
``astype(x.dtype)`` is a no-op in fp32.

Gradients: on CUDA tensors that need one, the kernel runs inside
``_FusedMLP``, whose backward is autograd of ``reference_mlp`` on the saved
inputs (``_fused_mlp_bwd``, fused_mlp.py:125-128); no backward kernel.

Counters (plain integers, touched only where a kernel launches):
``launches`` counts K2 launches of every route, ``wmma_launches`` those on
the WMMA route, ``cp_async_launches`` the Hopper kernel's launches that
load x by cp.async, ``fp32_launches`` those of the fp32 kernels,
``fp32_tiled_launches`` those of the outer-product kernel and
``fp32_dot_launches`` those of the dot-product kernel.
"""

import functools
from typing import Optional, Tuple

import torch

from lam_slide_tpu_torch.nn.blocks import gelu_exact
from lam_slide_tpu_torch.ops import _build
from lam_slide_tpu_torch.ops._grad import needs_grad, plain_vjp

launches = 0
wmma_launches = 0
cp_async_launches = 0
fp32_launches = 0
fp32_tiled_launches = 0
fp32_dot_launches = 0

# The Hopper kernel's GELU table (csrc/fused_mlp.cu GELU_LO, GELU_SPAN): the
# bf16 GELU of every bf16 mid with |mid| in [2^-9, 8) (bit patterns from
# GELU_TABLE_LO, GELU_TABLE_SPAN a sign), built by a small kernel before
# each launch into scratch the wrapper allocates.
GELU_TABLE_LO = 118 << 7
GELU_TABLE_SPAN = 12 << 7
GELU_TABLE_ENTRIES = 2 * GELU_TABLE_SPAN
SMEM_MAX = 232448  # the most dynamic shared memory an H100 block takes
SM90_ROWS = 128  # rows a tile of the Hopper kernel (two warpgroups of 64)
SM90_MAX_S1 = 4  # w1 ring stages


def sm90_smem_bytes(d_in: int, nc: int, no: int, s1: int) -> int:
    """Shared memory of a Hopper K2 block (``sm90::smem_bytes`` in
    csrc/fused_mlp.cu): the x tile of SM90_ROWS rows by d_in padded to
    64-column panels (128 bytes a row each), s1 w1 panels of nc rows, two w2
    panels of no rows by nc bf16, two GELU tiles of 64 rows by nc bf16 for
    each of the two consumer warpgroups, the mbarriers (128) and 1024 bytes
    of alignment slack."""
    kp = -(-d_in // 64)
    return (SM90_ROWS * kp * 128 + s1 * nc * kp * 128 + 2 * no * nc * 2 + 4 * 64 * nc * 2
            + 128 + 1024)


def sm90_plan(d_in: int, d_out: int) -> Optional[Tuple[int, int, int]]:
    """The Hopper kernel's geometry for these widths, ``(nc, no, s1)``, or
    None where its shared memory cannot hold them (the WMMA route then).

    no: output columns a pass, a multiple of 64 up to 256 (a 64 x 256 fp32
    accumulator is 128 registers a thread), as few passes as d_out allows and
    as even (d_out 384: two of 192). nc: columns of d_mid a chunk, 64 where
    two w1 stages fit, else 32. s1: w1 stages, as many as fit up to
    SM90_MAX_S1.
    """
    passes = -(-d_out // 256)
    per_pass = -(-d_out // passes)
    no = -(-per_pass // 64) * 64
    for nc in (64, 32):
        for s1 in range(SM90_MAX_S1, 1, -1):
            if sm90_smem_bytes(d_in, nc, no, s1) <= SMEM_MAX:
                return nc, no, s1
    return None


F32_CHUNK = 32  # d_mid columns a chunk of the fp32 kernel
F32_PLANS = ((64, 2), (32, 2), (64, 1), (32, 1))  # (rows, chunk stages), the first that fits
F32_MAX_D_OUT = 512  # a thread keeps up to 2 * 16 output columns of its rows


def f32_smem_bytes(rows: int, stages: int, d_in: int, d_out: int) -> int:
    """Shared memory of an fp32 K2 block (``smem_bytes`` in
    csrc/fused_mlp_f32.cu): the x tile (``rows``) and ``stages`` w1 chunks
    (32 rows of the weight) with rows of d_in + 4 floats, the GELU chunk
    (``rows``) and ``stages`` w2 chunks (d_out rows) with rows of 36."""
    return 4 * ((rows + stages * F32_CHUNK) * (d_in + 4)
                + (rows + stages * d_out) * (F32_CHUNK + 4))


def f32_plan(d_in: int, d_out: int) -> Optional[Tuple[int, int]]:
    """The fp32 kernel's (rows a block, chunk stages): the first of
    F32_PLANS whose shared memory fits (two stages let the next chunk's
    copies run under this one's products), or None where none does or d_out
    is past F32_MAX_D_OUT."""
    if d_out > F32_MAX_D_OUT:
        return None
    return next((p for p in F32_PLANS if f32_smem_bytes(*p, d_in, d_out) <= SMEM_MAX), None)


# The outer-product fp32 kernel's instances (csrc/fused_mlp_f32.cu
# tiled::Inst*): (d_out, rows a block) -> (threads, d_mid columns a chunk,
# d_in rows of a w1^T slice, d_mid rows of a w2^T slice); the slices pass
# through a ring of TILED_STAGES stages.
TILED_INSTANCES = {(256, 128): (256, 64, 64, 16), (384, 64): (384, 96, 64, 16),
                   (384, 32): (192, 96, 64, 32), (128, 32): (128, 128, 32, 32),
                   (32, 64): (128, 64, 32, 64)}
TILED_STAGES = 3
H100_SMS = 132


def tiled_smem_bytes(d_in: int, d_out: int, rows: int) -> int:
    """Shared memory of an outer-product fp32 block (``tiled::Inst::smem``):
    x^T [d_in, rows + 4], the ring's stages, each the larger of a w1^T slice
    [ks, chunk + 4] and a w2^T slice [ms, d_out], and G^T [chunk, rows + 4]."""
    _, chunk, ks, ms = TILED_INSTANCES[(d_out, rows)]
    stage = max(ks * (chunk + 4), ms * d_out)
    return 4 * (d_in * (rows + 4) + TILED_STAGES * stage + chunk * (rows + 4))


def tiled_plan(d_in: int, d_mid: int, d_out: int, rows: int = 1 << 30,
               sms: int = H100_SMS) -> Optional[Tuple[int, int, int, int]]:
    """The outer-product fp32 kernel's (rows a block, threads, d_mid columns
    a chunk, shared bytes) for ``rows`` rows (by default as many as fill the
    card) at these widths, or None where it has no instance (d_out not 256,
    384, 128 or 32, d_in not a multiple of the instance's k-slice, d_mid not
    one of its chunk) or its shared memory
    would not fit: the dot-product kernel's route then (``f32_plan``). Of
    two instances for one d_out, the smaller row block where the larger
    would leave SMs idle (the 4AA eval's 4,000 rows: 125 blocks of 32 rows,
    not 63 of 64)."""
    sizes = sorted((bm for (o, bm) in TILED_INSTANCES if o == d_out), reverse=True)
    if not sizes:
        return None
    bm = sizes[-1] if len(sizes) > 1 and -(-rows // sizes[0]) < sms else sizes[0]
    threads, chunk, ks, _ = TILED_INSTANCES[(d_out, bm)]
    smem = tiled_smem_bytes(d_in, d_out, bm)
    if d_in % ks or d_mid % chunk or smem > SMEM_MAX:
        return None
    return bm, threads, chunk, smem


@functools.cache
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def x_tma_ok(x2: torch.Tensor) -> bool:
    """Whether TMA can load the rows of x ``[rows, d_in]`` (unit stride on
    d_in): a 16-byte aligned base and row stride. Otherwise the Hopper
    kernel copies x by cp.async."""
    return x2.data_ptr() % 16 == 0 and (x2.shape[0] == 1 or (x2.stride(0) * 2) % 16 == 0)


def reference_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor) -> torch.Tensor:
    """Plain version: the mid rounded once to the activation dtype after the
    fp32 dot + bias (no rounding in fp32), exact GELU rounded to the
    activation dtype, fp32 output. The fp32 matmuls of bf16 values keep
    every product exact, as a bf16 GEMM with fp32 accumulation does."""
    mid = (torch.matmul(x.float(), w1.float()) + b1.float()).to(x.dtype)
    return torch.matmul(gelu_exact(mid).float(), w2.float())


def _check(x, w1, b1, w2) -> None:
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_mlp: x must be bfloat16 or float32, got {x.dtype}")
    for name, t in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"fused_mlp: {name} must be on x's CUDA device, got {t.device}")
        if t.dtype != x.dtype:
            raise ValueError(f"fused_mlp: {name} must be {x.dtype} like x, got {t.dtype}")
    d_in, d_mid = w1.shape
    if x.shape[-1] != d_in or b1.shape != (d_mid,) or w2.shape[0] != d_mid:
        raise ValueError(f"fused_mlp: shapes x {tuple(x.shape)} w1 {tuple(w1.shape)} "
                         f"b1 {tuple(b1.shape)} w2 {tuple(w2.shape)} do not match")
    if d_in % 16 or d_mid % 16 or w2.shape[1] % 16:
        raise ValueError("fused_mlp: d_in, d_mid and d_out must be multiples of 16")
    fp32 = x.dtype == torch.float32
    d_out = w2.shape[1]
    if fp32 and tiled_plan(d_in, d_mid, d_out) is None and f32_plan(d_in, d_out) is None:
        raise ValueError(f"fused_mlp: the fp32 kernels take d_out <= {F32_MAX_D_OUT} and "
                         f"widths whose tiles fit shared memory, got d_in {d_in} "
                         f"d_out {d_out}")
    for name, w in (("w1", w1), ("w2", w2)):
        align = (w.stride(1) % 4 or w.data_ptr() % 16) if fp32 else (
            w.stride(1) % 8 or w.data_ptr() % 32)
        if w.stride(0) != 1 or align:
            raise ValueError(f"fused_mlp: {name} must be a transposed nn.Linear weight view "
                             f"(stride(0) == 1; stride(1) % 8 == 0 and 32-byte aligned in bf16, "
                             f"stride(1) % 4 == 0 and 16-byte aligned in fp32), got strides "
                             f"{w.stride()}")
    if b1.stride(0) != 1:
        raise ValueError("fused_mlp: b1 must be contiguous")


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor) -> torch.Tensor:
    """gelu(x @ w1 + b1) @ w2 -> fp32 ``[..., d_out]``.

    CPU tensors take ``reference_mlp``; CUDA tensors (all bf16 or all fp32)
    launch the kernel or raise, through ``_FusedMLP`` when they need a
    gradient.
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
    if x.dtype == torch.float32 and (x2.data_ptr() % 16 or x2.stride(0) % 4):
        raise ValueError("fused_mlp: the fp32 kernel copies x in 16-byte pieces: it needs a "
                         "16-byte aligned x whose row stride is a multiple of 4")
    rows, d_in = x2.shape
    d_mid, d_out = w2.shape
    out = torch.empty((rows, d_out), dtype=torch.float32, device=x.device)
    plan = sm90_plan(d_in, d_out)
    ptrs = (x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), out.data_ptr())
    dims = (rows, d_in, d_mid, d_out, x2.stride(0), w1.stride(1), w2.stride(1), out.stride(0))
    global launches, wmma_launches, cp_async_launches, fp32_launches
    global fp32_tiled_launches, fp32_dot_launches
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        tiled = (tiled_plan(d_in, d_mid, d_out, rows, _sms(x.device))
                 if x.dtype == torch.float32 else None)
        if tiled is not None:
            # [d_in, d_mid] and [d_mid, d_out] row-major: the kernel's k-major operands
            w1t, w2t = w1.contiguous(), w2.contiguous()
            _build.launch("lam_fused_mlp_f32_tiled", x2.data_ptr(), w1t.data_ptr(),
                          b1.data_ptr(), w2t.data_ptr(), out.data_ptr(), rows, d_in, d_mid,
                          d_out, x2.stride(0), out.stride(0), tiled[0], stream)
            fp32_launches += 1
            fp32_tiled_launches += 1
        elif x.dtype == torch.float32:
            _build.launch("lam_fused_mlp_f32", *ptrs, *dims, *f32_plan(d_in, d_out), stream)
            fp32_launches += 1
            fp32_dot_launches += 1
        elif plan is None:
            _build.launch("lam_fused_mlp_wmma", *ptrs, *dims, stream)
            wmma_launches += 1
        else:
            tma = x_tma_ok(x2)
            table = torch.empty(GELU_TABLE_ENTRIES, dtype=torch.int16, device=x.device)
            _build.launch("lam_fused_mlp_sm90", *ptrs, table.data_ptr(), *dims, *plan, int(tma),
                          stream)
            cp_async_launches += not tma
    launches += 1
    return out.reshape(*lead, d_out)
