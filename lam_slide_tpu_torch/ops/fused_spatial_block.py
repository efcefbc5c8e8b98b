"""The DiT's small-L spatial block: CUDA kernel K8 and its plain PyTorch version.

Counterpart of ``lam_slide_tpu/ops/fused_spatial_block.py`` (``_kernel``
through ``fused_spatial_block``; plain version ``_reference_spatial_block``,
:65-84): the whole ParallelMLPAttention over L <= 8 positions of each
frame, linear1, per-head QK RMS-norm and RoPE, L×L softmax attention,
exact GELU of the MLP slice, and ``concat(attn, gelu) @ w2 + b2``.

Two routes, both launched from ``fused_spatial_block``; ``sm90_plan``
picks one from the widths alone:
- the Hopper kernel (``csrc/fused_spatial_block_sm90.cu``,
  ``lam_spatial_block_sm90``) wherever the plan holds: the (D, dh) it has
  instances of (``SM90_GROUPS``: 384 at dh 24 and 128, 256 at dh 16, 128 at
  dh 32, every composite's width) at any L. A persistent block walks 64-row
  tiles of whole frames with TMA-fed wgmma GEMMs; linear1 is computed once a
  row, chunk by chunk of linear2's K dimension (head groups of ``group``
  columns, then MLP chunks of twice that), and the fp32 output
  accumulator lives for the whole tile. x must be 16-byte aligned there;
- the first port's WMMA kernel (``csrc/fused_spatial_block.cu``,
  ``lam_spatial_block_wmma``) for every other width the checks accept (the
  tiny test registries' hidden 16 and 32 at dh 4 to 8, and the
  tensor-parallel ranks below a Hopper head group): the whole
  ``[32 rows, 3D+M]`` linear1 output of a block in shared memory.
Neither is a fallback for the other: a CUDA tensor launches the plan's
route or raises. Those two take bf16; an all-fp32 call (the 4AA eval's fp32
DiT) launches one of two FFMA kernels in ``csrc/fused_spatial_block_f32.cu``,
both walking linear2's K dimension head group by head group (linear1's q, k,
v of the group into a staging tile, norm, RoPE, L×L attention, then its
linear2 contribution) and then MLP columns, the output in registers, the
weights streamed through a two-stage ring; ``f32_plan`` picks the
route from the widths, and where it has none the call raises naming the
limit:
- ``lam_spatial_block_f32_tiled``, the outer-product kernel, at the widths
  it has instances of (``F32_TILED_INSTANCES``) with M a multiple of 32: the
  4AA DiT's D 384 at head groups of 96 or 128 columns (16 × 24, 3 × 128;
  32-row blocks, a thread a 4 × 12 block of the output), the NBA DiT's D
  256 (16 × 16; head groups of 64, 64-row blocks, 8 × 8 a thread) and the
  pedestrian DiT's D 128 (4 × 32; head groups of 128, 32-row blocks, 4 × 4
  a thread); 256 threads, x^T resident, linear1 in passes of a head group's
  q, k and v columns or D MLP columns (a last pass below D zero-padded in
  the stream); the wrapper's pass-ordered w1 stream (``f32_tiled_passes``)
  and w2^T copy arrive slice by slice by bulk copies into a two-stage ring;
- ``lam_spatial_block_f32``, the first fp32 kernel (a thread 2 × 2 mids of a
  32-column tile), for the other widths (the smoke and tiny registries', the
  ranks whose head group has no outer-product instance); the two agree bit
  for bit.
Under autograd they run inside ``_SpatialBlock`` like the others (the fp32
stage-2 training of both registries).

Weights are in torch ``nn.Linear`` layout: ``w1 [3D+M, D]``, ``w2 [D, D+M]``.

Tensor parallelism (parallel/tp.py): a rank's block holds ``n_heads``
whole heads, ``attn_width`` = Da of their q, k and v columns, and Mr MLP
columns, so ``w1 [3Da+Mr, D]`` and ``w2 [D, Da+Mr]``; with ``partial`` the
call returns the fp32 sum ``[attn | gelu(mlp)] @ w2^T`` of its slice,
unrounded and without b2, which the model group adds up before the one
rounding and ``+ b2`` of the whole block. Every route takes it, picked as
for a whole block: in bf16 the Hopper kernel where ``sm90_plan`` has an
instance for (D, Da / n_heads) and Da is a whole number of its head group
(4AA, NBA at tp 2 to 4, the pedestrian DiT at tp 2), else the WMMA route
(4AA 16 × 24 and NBA at tp 8, the pedestrian DiT at tp 4, the tiny widths;
a Da that is not a multiple of 16 padded with zero rows and columns,
``_wmma_operands``); in fp32 the outer-product kernel where its instance's
head group divides Da (4AA at tp 2, 3 and 4, NBA at tp 2 and 4), else the
dot-product kernel.

Gradients: on CUDA tensors that need one, the kernel runs inside
``_SpatialBlock``, whose backward is autograd of ``reference_spatial_block``
on the saved inputs (``_fused_bwd``, fused_spatial_block.py:225-230); no
backward kernel.

Counters (plain integers, touched only where a kernel launches):
``launches`` counts K8 launches of every route, ``wmma_launches`` those on
the WMMA route, ``f32_launches`` those of the fp32 kernels,
``f32_tiled_launches`` those of them on the outer-product kernel,
``f32_dot_launches`` those on the first fp32 kernel and
``tp_partial_launches`` the launches of a tensor-parallel rank's partial
(``partial`` set) on every route, the route counters saying which.
"""

import functools
import weakref
from typing import NamedTuple, Optional

import torch

from lam_slide_tpu_torch.nn.blocks import gelu_exact
from lam_slide_tpu_torch.ops import _build
from lam_slide_tpu_torch.ops._grad import needs_grad, plain_vjp
from lam_slide_tpu_torch.ops.fused_mlp import GELU_TABLE_ENTRIES, SMEM_MAX
from lam_slide_tpu_torch.ops.packed_attention import (
    headmajor_rmsnorm,
    headmajor_rope,
    small_attention,
)

launches = 0
wmma_launches = 0
f32_launches = 0
f32_tiled_launches = 0
f32_dot_launches = 0
tp_partial_launches = 0

# The Hopper kernel's geometry (csrc/fused_spatial_block_sm90.cu).
SM90_ROWS = 64  # rows a tile, of which whole frames are used
SM90_MAX_STAGES = 6  # stages of each weight ring
# (D, dh) -> head group width of the instances the Hopper kernel has
SM90_GROUPS = {(384, 24): 96, (384, 128): 128, (256, 16): 64, (128, 32): 64}


class Sm90Plan(NamedTuple):
    rows: int  # rows of a tile that are used: whole frames
    group: int  # columns of an attention chunk (a head group)
    mlp_chunk: int  # columns of an MLP chunk
    s1: int  # w1 stages
    s2: int  # w2 stages
    smem: int  # shared memory of a block, bytes


def sm90_smem_bytes(d: int, group: int, s1: int, s2: int) -> int:
    """Shared memory of a Hopper K8 block (``smem_bytes`` in
    csrc/fused_spatial_block_sm90.cu): the 64-row x tile (128 bytes a row
    for every 64 columns of D), s1 w1 stages of ``group`` rows by 64
    columns, s2 w2 stages of D rows by 32 columns, the staging area of q, k
    and v of a head group (3 x group columns by 64 rows), the mbarriers
    (256) and 1024 bytes of alignment slack."""
    return (d * SM90_ROWS * 2 + s1 * group * 64 * 2 + s2 * d * 32 * 2
            + 3 * group * SM90_ROWS * 2 + 256 + 1024)


def sm90_plan(n: int, l: int, d: int, m: int, n_heads: int,
              attn_width: Optional[int] = None) -> Optional[Sm90Plan]:
    """The Hopper kernel's geometry for x ``[n, l, d]``, mlp width m and
    n_heads heads over ``attn_width`` columns (default d; a tensor-parallel
    rank's Da), or None where it has no instance (the WMMA route then).

    rows: 64 // l * l, so no frame straddles two tiles. group: the head
    group width of the (d, dh) instance; an MLP chunk is twice that. s1, s2:
    three w2 stages and as many w1 stages as fit up to SM90_MAX_STAGES, if
    that is at least three; else two w2 stages and as many w1 stages as
    fit. (At [8000, 2, 384] on an H100: 3 x 128 0.2076 ms at (3, 3) against
    0.2188 at (5, 2); 16 x 24 0.2135 at (5, 3), 0.2241 at (6, 2), PERF.md.)
    """
    da = d if attn_width is None else attn_width
    if (n <= 0 or not 1 <= l <= 8 or n_heads <= 0 or not 0 < da <= d or da % n_heads
            or m <= 0 or m % 16):
        return None
    group = SM90_GROUPS.get((d, da // n_heads))
    if group is None or da % group or n * l >= 2 ** 31:
        return None
    for s2, least in ((3, 3), (2, 2)):
        s1 = max((s for s in range(2, SM90_MAX_STAGES + 1)
                  if sm90_smem_bytes(d, group, s, s2) <= SMEM_MAX), default=0)
        if s1 >= least:
            return Sm90Plan(64 // l * l, group, 2 * group, s1, s2,
                            sm90_smem_bytes(d, group, s1, s2))
    return None


# The fp32 kernels' geometry (csrc/fused_spatial_block_f32.cu).
F32_TILE = 32  # columns of a weight tile of the dot-product kernel
F32_ROWS = 32  # rows a dot-product block, of which 32 // l * l are whole frames
F32_MAX_GROUP = 128  # columns of a head group, unless one head is wider
F32_SLICE = 32  # rows of a weight slice of the outer-product kernel (tiled::KS)
# The outer-product kernel's instances (namespace tiled, tiled::I*): (D, head
# group) -> rows a block. Its MLP passes are D columns wide (a shorter last
# one zero-padded in the w1 stream), its GEMM2 slices 32 rows, so it takes M
# a multiple of 32.
F32_TILED_INSTANCES = {(384, 96): 32, (384, 128): 32, (256, 64): 64, (128, 128): 32}
# its head group where it is not f32_group's: the most whole heads within
# this many columns (at NBA's 16 x 16, four heads)
F32_TILED_MAX_GROUP = {256: 64}


class F32Plan(NamedTuple):
    group: int  # columns of a head group: whole heads, a multiple of 4 that divides D
    smem: int  # shared memory of a block, bytes
    route: str  # "tiled" (the outer-product kernel) or "dot" (the first fp32 kernel)
    blocks: int  # blocks of the call: one a rows // l frames
    rows: int  # rows a block, of which rows // l * l are whole frames


def f32_smem_bytes(d: int, group: int) -> int:
    """Shared memory of a dot-product fp32 K8 block (``smem_bytes`` in
    csrc/fused_spatial_block_f32.cu): the x tile ``[32][d + 4]``, the
    staging tile ``[32][3 group + 4]`` and two ring stages, each a w1 tile
    ``[32][d + 4]`` or a w2 tile ``[d][36]``, whichever is larger; fp32."""
    stage = max(F32_TILE * (d + 4), d * (F32_TILE + 4))
    return 4 * (F32_ROWS * (d + 4) + F32_ROWS * (3 * group + 4) + 2 * stage)


def f32_tiled_smem_bytes(d: int, group: int, rows: int) -> int:
    """Shared memory of an outer-product fp32 K8 block (``tiled::Inst::smem``):
    x^T ``[d][rows + 4]``, the staging tile S^T ``[ps][rows + 4]`` with ps
    the wider pass (a head group's ``3 group`` columns or ``d`` MLP columns),
    two ring stages of a ``[32][ps]`` slice of the w1 stream or w2^T, fp32,
    and an 8-byte mbarrier a stage."""
    ps = max(3 * group, d)
    return 4 * ((d + ps) * (rows + 4) + 2 * F32_SLICE * ps) + 8 * 2


def f32_group(d: int, n_heads: int, most: int = F32_MAX_GROUP) -> Optional[int]:
    """The fp32 kernels' head group: the most whole heads whose columns are at
    most ``most`` (one head if a head is wider), a multiple of 4 that
    divides D; None where no group qualifies."""
    if n_heads <= 0 or d % n_heads:
        return None
    dh = d // n_heads
    if dh > most:
        return dh if dh % 4 == 0 else None
    fits = [hg * dh for hg in range(1, n_heads + 1)
            if n_heads % hg == 0 and hg * dh <= most and (hg * dh) % 4 == 0]
    return max(fits, default=None)


def f32_tiled_passes(d: int, m: int, group: int, da: int) -> list:
    """The outer-product kernel's linear1 passes: the linear1 columns (w1
    rows) of each, every head group's q, k and v columns of the ``da``
    attention columns (d, or a tensor-parallel rank's Da), then the MLP
    columns d at a time (the last pass shorter where d does not divide m)."""
    passes = [[part * da + g * group + c for part in range(3) for c in range(group)]
              for g in range(da // group)]
    return passes + [list(range(3 * da + p, 3 * da + min(p + d, m))) for p in range(0, m, d)]


@functools.lru_cache(maxsize=16)
def _w1_stream_index(d: int, m: int, group: int, row_stride: int,
                     device: torch.device, da: int) -> torch.Tensor:
    """Offsets into w1's memory (rows ``row_stride`` apart) of the
    outer-product kernel's w1 stream: each pass's [D][P] block of w1^T (row
    k holds the pass's P columns at input k), the passes one after another,
    so a slice of KS rows of a pass is one contiguous run. A short last MLP
    pass is padded to D columns by the offset just past w1's memory, where
    ``_tiled_operands`` puts a zero."""
    pad = (3 * da + m - 1) * row_stride + d  # one past w1's last element
    blocks = []
    for cols in f32_tiled_passes(d, m, group, da):
        width = max(len(cols), d) if cols[0] >= 3 * da else len(cols)
        offs = torch.full((d, width), pad, dtype=torch.long)
        offs[:, :len(cols)] = torch.tensor(cols)[None, :] * row_stride + torch.arange(d)[:, None]
        blocks.append(offs.flatten())
    return torch.cat(blocks).to(device)


# The outer-product kernel's weight operands, kept while their weights are
# unchanged: id(w1) -> (weak refs to w1 and w2, their key, w1 stream, w2^T)
_tiled_weights: dict = {}


def _tiled_operands(w1: torch.Tensor, w2: torch.Tensor, d: int, m: int, group: int,
                    da: int):
    """The outer-product kernel's k-major weights: the pass-ordered w1^T
    blocks (the w1 stream) and the contiguous ``[Da + M, D]`` w2^T, each
    slice of either a contiguous run. ``da``: the attention width (d, or a
    tensor-parallel rank's Da; part of the key, so shards of other
    widths never share a stream). Built once for a pair of weight tensors
    and kept until either is written in place (its version moves, as an
    optimizer step moves it) or freed; an eval over fixed weights builds
    them once a block."""
    key = (w1.data_ptr(), w1._version, w1.stride(0), w2.data_ptr(), w2._version, group, da, m)
    hit = _tiled_weights.get(id(w1))
    if hit is not None and hit[0]() is w1 and hit[1]() is w2 and hit[2] == key:
        return hit[3], hit[4]
    span = (w1.shape[0] - 1) * w1.stride(0) + d
    with torch.no_grad():
        flat = w1.as_strided((span,), (1,))
        if m % d:  # the short last pass's padding reads the zero past w1
            flat = torch.cat([flat, flat.new_zeros(1)])
        w1s = flat.index_select(0, _w1_stream_index(d, m, group, w1.stride(0), w1.device, da))
        w2t = w2.t().contiguous()
    wid = id(w1)
    _tiled_weights[wid] = (weakref.ref(w1, lambda _: _tiled_weights.pop(wid, None)),
                           weakref.ref(w2), key, w1s, w2t)
    return w1s, w2t


def clear_weight_cache() -> None:
    """Drop every kept weight operand. For writers that leave a weight's
    version as it was: FSDP2 all-gathers into the same parameter under a
    preserved version counter, so parallel/fsdp.py calls this before each
    sharded unit runs."""
    _tiled_weights.clear()


def f32_plan(n: int, l: int, d: int, m: int, n_heads: int,
             attn_width: Optional[int] = None) -> Optional[F32Plan]:
    """The fp32 kernels' geometry for x ``[n, l, d]``, mlp width m and
    n_heads heads over ``attn_width`` columns (default d; a tensor-parallel
    rank's Da), or None where they have none: D and M multiples of 16, an
    even head dim with a head group of the attention columns
    (``f32_group``). The outer-product kernel where it has an instance for D
    and the group (``F32_TILED_INSTANCES``; at D 256 the group of at most 64
    columns) and M is a multiple of 32: the 4AA, NBA and pedestrian DiTs'
    widths (at the 4AA eval's 4,000 rows, 125 blocks of 32 rows on the
    H100's 132 SMs, one block an SM) and their ranks at 4AA tp 2, 3 and 4
    and NBA tp 2 and 4; else the dot-product kernel where its shared memory
    fits SMEM_MAX (D up to 438 at head groups of 128 columns)."""
    da = d if attn_width is None else attn_width
    if (n <= 0 or not 1 <= l <= 8 or d % 16 or m <= 0 or m % 16 or n_heads <= 0
            or not 0 < da <= d or da % n_heads or (da // n_heads) % 2 or n * l >= 2 ** 31):
        return None
    group = f32_group(da, n_heads)
    if group is None:
        return None
    tiled = f32_group(da, n_heads, F32_TILED_MAX_GROUP.get(d, F32_MAX_GROUP))
    if (d, tiled) in F32_TILED_INSTANCES and m % F32_SLICE == 0:
        rows = F32_TILED_INSTANCES[(d, tiled)]
        return F32Plan(tiled, f32_tiled_smem_bytes(d, tiled, rows), "tiled",
                       -(-n // (rows // l)), rows)
    if f32_smem_bytes(d, group) > SMEM_MAX:
        return None
    return F32Plan(group, f32_smem_bytes(d, group), "dot", -(-n // (F32_ROWS // l)), F32_ROWS)


def reference_spatial_block(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                            q_scale: torch.Tensor, k_scale: torch.Tensor,
                            w2: torch.Tensor, b2: Optional[torch.Tensor], cos: torch.Tensor,
                            sin: torch.Tensor, n_heads: int, scale: float,
                            eps: float = 1e-6, attn_width: Optional[int] = None,
                            partial: bool = False) -> torch.Tensor:
    """linear1 → QKNorm → RoPE → L×L attention ∥ gelu MLP → linear2.

    x: ``[N, L, D]`` in the compute dtype; cos/sin: ``[L, dh/2]`` fp32.
    ``attn_width``: the q, k and v columns of the ``n_heads`` heads (default
    D); with ``partial`` the fp32 product of linear2 without b2 (b2 unread).
    """
    n, l, d = x.shape
    da = d if attn_width is None else attn_width
    dh = da // n_heads
    dtype = x.dtype
    xw = torch.matmul(x, w1.to(dtype).t()) + b1.to(dtype)
    q, k, v, mlp = xw[..., :da], xw[..., da:2 * da], xw[..., 2 * da:3 * da], xw[..., 3 * da:]

    def heads(t):  # [N, L, Da] -> [N, H, L, dh]
        return t.reshape(n, l, n_heads, dh).transpose(1, 2)

    qh = headmajor_rope(headmajor_rmsnorm(heads(q), q_scale, eps), cos, sin)
    kh = headmajor_rope(headmajor_rmsnorm(heads(k), k_scale, eps), cos, sin)
    attn = small_attention(qh, kh, heads(v), scale=scale).transpose(1, 2).reshape(n, l, da)
    out = torch.cat([attn, gelu_exact(mlp)], dim=-1)
    if partial:
        return torch.matmul(out.float(), w2.float().t())
    return torch.matmul(out, w2.to(dtype).t()) + b2.to(dtype)


def _check(x, w1, b1, q_scale, k_scale, w2, b2, cos, sin, n_heads, da, partial) -> None:
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_spatial_block: x must be bfloat16 or float32, got {x.dtype}")
    for name, t, dtype in (("x", x, x.dtype), ("w1", w1, x.dtype), ("b1", b1, x.dtype),
                           ("w2", w2, x.dtype), ("b2", b2, x.dtype),
                           ("q_scale", q_scale, torch.float32),
                           ("k_scale", k_scale, torch.float32), ("cos", cos, torch.float32),
                           ("sin", sin, torch.float32)):
        if name == "b2" and partial:
            continue
        if not t.is_cuda or t.device != x.device or t.dtype != dtype:
            raise ValueError(f"fused_spatial_block: {name} must be {dtype} on x's CUDA device, "
                             f"got {t.dtype} on {t.device}")
        if name != "w1" and name != "w2" and not t.is_contiguous():
            raise ValueError(f"fused_spatial_block: {name} must be contiguous")
    if x.dim() != 3 or not 1 <= x.shape[1] <= 8:
        raise ValueError(f"fused_spatial_block: x must be [N, L <= 8, D], got {tuple(x.shape)}")
    n, l, d = x.shape
    width = w1.shape[0]
    dh = da // n_heads if 0 < da <= d and da % n_heads == 0 else 0
    if d % 16 or (width - 3 * da) % 16 or width <= 3 * da or dh % 2 or dh == 0:
        raise ValueError(f"fused_spatial_block: needs D and M multiples of 16 and an even "
                         f"head dim, got D={d}, attention width {da}, w1 rows {width}, "
                         f"{n_heads} heads")
    m = width - 3 * da
    if (w1.shape != (width, d) or b1.shape != (width,) or w2.shape != (d, da + m)
            or (not partial and b2.shape != (d,)) or q_scale.shape != (dh,)
            or k_scale.shape != (dh,)
            or cos.shape != (l, dh // 2) or sin.shape != (l, dh // 2)):
        raise ValueError("fused_spatial_block: parameter shapes do not match x and the heads")
    fp32 = x.dtype == torch.float32
    if fp32 and f32_plan(n, l, d, m, n_heads, da) is None:
        group = f32_group(da, n_heads)
        smem = None if group is None else f32_smem_bytes(d, group)
        raise ValueError(f"fused_spatial_block: the fp32 kernel takes a head group of whole "
                         f"heads that is a multiple of 4 and shared memory <= {SMEM_MAX} bytes, "
                         f"got D={d}, {n_heads} heads over {da} columns: head group {group}, "
                         f"{smem} bytes")
    for name, w in (("w1", w1), ("w2", w2)):
        if w.stride(1) != 1 or w.stride(0) % (4 if fp32 else 8) or w.data_ptr() % (16 if fp32
                                                                                    else 32):
            raise ValueError(f"fused_spatial_block: {name} must be in nn.Linear layout "
                             f"(unit column stride, row stride % 8 == 0 and 32-byte aligned in "
                             f"bf16, % 4 and 16-byte aligned in fp32), got strides "
                             f"{w.stride()}")


def fused_spatial_block(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                        q_scale: torch.Tensor, k_scale: torch.Tensor,
                        w2: torch.Tensor, b2: Optional[torch.Tensor], cos: torch.Tensor,
                        sin: torch.Tensor, n_heads: int, scale: float,
                        attn_width: Optional[int] = None,
                        partial: bool = False) -> torch.Tensor:
    """The spatial block over x ``[N, L, D]`` -> ``[N, L, D]`` (fp32 with
    ``partial``: a tensor-parallel rank's share, module docstring).

    CPU tensors take ``reference_spatial_block``. CUDA tensors launch a
    kernel or raise: bf16 x and weights the route of ``sm90_plan``, fp32 x
    and weights the fp32 kernel; through ``_SpatialBlock`` when they need a
    gradient. The norm scales and the ``[L, dh/2]`` tables are fp32 in both.
    """
    args = (x, w1, b1, q_scale, k_scale, w2, b2, cos, sin, n_heads, scale)
    kw = {"attn_width": attn_width, "partial": partial}
    if x.device.type == "cpu":
        return reference_spatial_block(*args, **kw)
    if needs_grad(*args):
        return _SpatialBlock.apply(*args, attn_width, partial)
    return _launch(*args, **kw)


class _SpatialBlock(torch.autograd.Function):
    """K8 forward, autograd of ``reference_spatial_block`` backward."""

    @staticmethod
    def forward(ctx, x, w1, b1, q_scale, k_scale, w2, b2, cos, sin, n_heads, scale,
                attn_width=None, partial=False):
        ctx.save_for_backward(x, w1, b1, q_scale, k_scale, w2, b2, cos, sin)
        ctx.n_heads, ctx.scale = n_heads, scale
        ctx.kw = {"attn_width": attn_width, "partial": partial}
        return _launch(x, w1, b1, q_scale, k_scale, w2, b2, cos, sin, n_heads, scale, **ctx.kw)

    @staticmethod
    def backward(ctx, g):
        grads = plain_vjp(
            lambda *a: reference_spatial_block(*a, ctx.n_heads, ctx.scale, **ctx.kw),
            ctx.saved_tensors, ctx.needs_input_grad[:9], (g,))
        return (*grads, None, None, None, None)


def _wmma_operands(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, da: int, m: int):
    """The WMMA kernel's weights and its section width S: Da rounded up to
    16, the width of its fragments. Where Da is not a multiple of 16 (a rank
    of the tiny widths: Da 8), new copies with each of w1's q, k and v
    sections (and b1's) padded to S rows and w2's attention columns to S
    columns, all zeros, which add exact zeros to every sum; else the weights
    themselves."""
    s = -(-da // 16) * 16
    if s == da:
        return w1, b1, w2, s

    def sections(t):
        zeros = t.new_zeros((s - da,) + tuple(t.shape[1:]))
        return torch.cat([p for i in range(3) for p in (t[i * da:(i + 1) * da], zeros)]
                         + [t[3 * da:]]).contiguous()

    w2p = torch.cat([w2[:, :da], w2.new_zeros(w2.shape[0], s - da), w2[:, da:da + m]], dim=1)
    return sections(w1), sections(b1), w2p.contiguous(), s


def _ptrs(x, w1, b1, q_scale, k_scale, w2, b2, cos, sin, out, partial) -> tuple:
    """The pointers every K8 entry takes first; b2's is 0 (unread) with
    ``partial``."""
    return (x.data_ptr(), w1.data_ptr(), b1.data_ptr(), q_scale.data_ptr(), k_scale.data_ptr(),
            w2.data_ptr(), 0 if partial else b2.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            out.data_ptr())


def _f32_dot(x, w1, b1, q_scale, k_scale, w2, b2, cos, sin, n_heads, scale, da, partial,
             group, out, stream) -> None:
    n, l, d = x.shape
    _build.launch("lam_spatial_block_f32",
                  *_ptrs(x, w1, b1, q_scale, k_scale, w2, b2, cos, sin, out, partial), n, l, d,
                  w1.shape[0] - 3 * da, n_heads, w1.stride(0), w2.stride(0), float(scale), group,
                  da, int(partial), stream)


def _launch_f32_dot(x, w1, b1, q_scale, k_scale, w2, b2, cos, sin, n_heads, scale,
                    attn_width: Optional[int] = None, partial: bool = False) -> torch.Tensor:
    """K8-fp32's dot-product kernel on checked fp32 CUDA tensors at its own
    head group (``f32_group``), whatever route ``f32_plan`` picks: the
    outer-product route's yardstick (the two sum in one order, so they
    agree bit for bit). Counts nothing; the main path goes through
    ``fused_spatial_block``."""
    n, l, d = x.shape
    da = d if attn_width is None else attn_width
    _check(x, w1, b1, q_scale, k_scale, w2, b2, cos, sin, n_heads, da, partial)
    if x.dtype != torch.float32 or x.data_ptr() % 16:
        raise ValueError("_launch_f32_dot: x must be fp32 and 16-byte aligned")
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _f32_dot(x, w1, b1, q_scale, k_scale, w2, b2, cos, sin, n_heads, scale, da, partial,
                 f32_group(da, n_heads), out, torch.cuda.current_stream(x.device).cuda_stream)
    return out


def _launch(x, w1, b1, q_scale, k_scale, w2, b2, cos, sin, n_heads, scale,
            attn_width: Optional[int] = None, partial: bool = False) -> torch.Tensor:
    """Launch K8 on CUDA tensors (checked here): fp32 on the route of
    ``f32_plan``, bf16 on the Hopper kernel where ``sm90_plan`` has a plan,
    else on the WMMA kernel -> ``[N, L, D]``."""
    n, l, d = x.shape
    da = d if attn_width is None else attn_width
    _check(x, w1, b1, q_scale, k_scale, w2, b2, cos, sin, n_heads, da, partial)
    m = w1.shape[0] - 3 * da
    fp32 = x.dtype == torch.float32
    plan = None if fp32 else sm90_plan(n, l, d, m, n_heads, da)
    if (plan is not None or fp32) and x.data_ptr() % 16:
        raise ValueError("fused_spatial_block: x must be 16-byte aligned for the Hopper and "
                         "fp32 kernels")
    out = torch.empty(x.shape, dtype=torch.float32 if partial else x.dtype, device=x.device)

    def ptrs(w1, b1, w2):
        return _ptrs(x, w1, b1, q_scale, k_scale, w2, b2, cos, sin, out, partial)

    global launches, wmma_launches, f32_launches, f32_tiled_launches, f32_dot_launches
    global tp_partial_launches
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if fp32:
            f32 = f32_plan(n, l, d, m, n_heads, da)
            if f32.route == "tiled":
                w1s, w2t = _tiled_operands(w1, w2, d, m, f32.group, da)
                _build.launch("lam_spatial_block_f32_tiled", *ptrs(w1s, b1, w2t), n, l, d, m,
                              n_heads, float(scale), f32.group, f32.rows, da, int(partial),
                              stream)
                f32_tiled_launches += 1
            else:
                _f32_dot(x, w1, b1, q_scale, k_scale, w2, b2, cos, sin, n_heads, scale, da,
                         partial, f32.group, out, stream)
                f32_dot_launches += 1
            f32_launches += 1
        elif plan is None:
            w1p, b1p, w2p, sec = _wmma_operands(w1, b1, w2, da, m)
            _build.launch("lam_spatial_block_wmma", *ptrs(w1p, b1p, w2p), n, l, d, m, n_heads,
                          w1p.stride(0), w2p.stride(0), float(scale), sec, da, int(partial),
                          stream)
            wmma_launches += 1
        else:
            table = torch.empty(GELU_TABLE_ENTRIES, dtype=torch.int16, device=x.device)
            _build.launch("lam_spatial_block_sm90", *ptrs(w1, b1, w2), table.data_ptr(), n, l,
                          d, m, n_heads, w1.stride(0), w2.stride(0), float(scale), plan.s1,
                          plan.s2, da, int(partial), stream)
        tp_partial_launches += int(partial)
    launches += 1
    return out
