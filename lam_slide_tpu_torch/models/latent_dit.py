"""Factorized spatial/temporal latent diffusion transformer, PyTorch port.

Counterpart of ``lam_slide_tpu/models/latent_dit.py`` (reference
``latent_si_v31.py`` + ``mmdit.py``). Module attribute names follow the
reference state_dict keys, so a reference ``state_dict`` (for example
``tests/golden/latent_dit_golden.npz``) loads with ``load_state_dict``.

Parameters are fp32; activations run in ``dtype`` (bf16 for the stage-2
configs), with weights cast at each use as the JAX package does. This is
the JAX package's fused configuration (``LAM_SLIDE_FUSED=1``) with its
shipping defaults:

* the temporal axis (n > ``packed_threshold``): at dh % 128 == 0 the flash
  kernel with QK RMS-norm and RoPE inside (K5) on raw views of linear1's
  output (latent_dit.py:336-361); otherwise QK RMS-norm and RoPE as
  elementwise ops and ``attention_packed`` on packed views
  (latent_dit.py:390-404): the packed flash entry (K3, the K1 binary) at
  n >= 128, the short-axis kernel K9 at 8 < n < 128 (the MD17 temporal
  axis, T=30); the fused MLP kernel (K2) for the MLP
  branch, and linear2 adds the two fp32 partials before a single rounding
  (latent_dit.py:415-434);
* the small spatial axis: the whole block in one kernel (K8,
  latent_dit.py:220-231);
* the residual + LayerNorm + modulate glue: K7, twice per layer and once
  before the output layer (latent_dit.py:484-487,680).

``ParallelMLPAttention(fused_temporal=True)`` (only the block exposes it,
as in JAX) takes the long axis through K10 instead, before the K5 route:
QK RMS-norm, RoPE and attention on packed views with lane tables and tiled
lane scales (latent_dit.py:299-319). ``attention_mode="linear"`` replaces
every softmax attention by ``linear_attention`` on normed and rotated q/k,
so K8, K10, K5 and K3 are skipped (latent_dit.py:386-408).
``share_weights=True`` applies one layer ``depth`` times (state_dict keys
``blocks.0.*``, latent_dit.py:657-661).

Tensor parallelism (parallel/tp.py) splits a ``ParallelMLPAttention`` into
shards of whole heads and MLP slices; each shard runs the block's kernels at
its own widths and returns linear2's fp32 partial without b2 (K8 with
``partial``, or K3/K1, K5, K9 on its heads and K2 at ``d_mid = M/tp``), the
model group adds them, and the block rounds once and adds b2 as the
unsharded block does.

``backend="auto"`` lets CUDA tensors launch the kernels; ``"plain"`` runs the
plain PyTorch versions everywhere (for comparisons and timing). Under
autograd each kernel runs inside its ``torch.autograd.Function``.
``checkpointing=True`` recomputes each layer in the backward
(``torch.utils.checkpoint``, the counterpart of ``nn.remat``,
latent_dit.py:643).
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from lam_slide_tpu_torch.nn import initializers as inits
from lam_slide_tpu_torch.nn.dense import dense, linear
from lam_slide_tpu_torch.nn.embeddings import timestep_embedding
from lam_slide_tpu_torch.nn.norms import QKNorm, layer_norm
from lam_slide_tpu_torch.ops.ablations.fused_temporal_attention import (
    fused_temporal_attention,
    reference_fused_temporal,
)
from lam_slide_tpu_torch.ops.attention import BACKENDS, attention_packed, linear_attention
from lam_slide_tpu_torch.ops.flash_normrope import (
    flash_attention_normrope,
    reference_attention_normrope,
)
from lam_slide_tpu_torch.ops.fused_adaln import (
    reference_residual_adaln_modulate,
    residual_adaln_modulate,
)
from lam_slide_tpu_torch.ops.fused_mlp import fused_mlp, reference_mlp
from lam_slide_tpu_torch.ops.fused_spatial_block import fused_spatial_block, reference_spatial_block
from lam_slide_tpu_torch.ops.packed_attention import (
    headmajor_rmsnorm,
    headmajor_rope,
    lane_rope_tables,
)

ATTENTION_MODES = ("scaled_dot_product", "linear")


def rope_cos_sin(n: int, dim: int, theta: float = 10_000.0,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotary tables for positions arange(n): (cos, sin), each [n, dim//2], fp32."""
    if dim % 2:
        raise ValueError(f"rope dim must be even, got {dim}")
    scale = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    omega = 1.0 / (theta ** scale)
    out = torch.arange(n, dtype=torch.float32, device=device)[:, None] * omega[None]
    return torch.cos(out), torch.sin(out)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate adjacent feature pairs of x [..., n, d] by position angle
    (reference mmdit.py:84-90); fp32 math, cast back to the input dtype."""
    return headmajor_rope(x, cos, sin)


class Modulation(nn.Module):
    """vec [B, D] -> two (shift, scale, gate) triples, each [B, 1, 1, D]
    (mmdit.py:184-197)."""

    def __init__(self, dim: int, zero_init: bool, gen: torch.Generator):
        super().__init__()
        self.lin = linear(dim, 6 * dim, inits.zeros_ if zero_init else inits.torch_linear_init_, gen)

    def forward(self, vec: torch.Tensor, dtype: torch.dtype):
        out = dense(F.silu(vec), self.lin, dtype)[:, None, None, :]
        parts = out.chunk(6, dim=-1)
        return parts[:3], parts[3:]


class ModulationTriple(nn.Module):
    """vec [B, D] -> three (shift, scale, gate) triples, each [B, 1, 1, D]
    (mmdit.py:200-212; latent_dit.py:105-124, for triple-branch DiT
    variants; no composite uses it)."""

    def __init__(self, dim: int, zero_init: bool, gen: torch.Generator):
        super().__init__()
        init = inits.zeros_ if zero_init else inits.torch_linear_init_
        self.lin = linear(dim, 9 * dim, init, gen)

    def forward(self, vec: torch.Tensor, dtype: torch.dtype):
        parts = dense(F.silu(vec), self.lin, dtype)[:, None, None, :].chunk(9, dim=-1)
        return parts[:3], parts[3:6], parts[6:]


class MLPEmbedder(nn.Module):
    """Linear -> SiLU -> Linear vector embedder (mmdit.py:116-124), std-0.02 init."""

    def __init__(self, in_dim: int, hidden_dim: int, gen: torch.Generator):
        super().__init__()
        self.in_layer = linear(in_dim, hidden_dim, inits.normal_002_, gen)
        self.out_layer = linear(hidden_dim, hidden_dim, inits.normal_002_, gen)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return dense(F.silu(dense(x, self.in_layer, dtype)), self.out_layer, dtype)


class ParallelMLPAttention(nn.Module):
    """Fused attention ∥ MLP block (reference ParallelMLPAttentionV2).

    One linear1 produces q/k/v and the MLP-up projection; linear2 reduces
    concat(attention, gelu(mlp)). x: [B', n, D] with RoPE tables for the n axis.
    """

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float,
                 reference_init: bool, packed_threshold: int, dtype: torch.dtype,
                 gen: torch.Generator, qk_scale: Optional[float] = None,
                 attention_mode: str = "scaled_dot_product", fused_temporal: bool = False):
        super().__init__()
        if attention_mode not in ATTENTION_MODES:
            raise ValueError(f"unknown attention_mode {attention_mode!r}; expected one of "
                             f"{ATTENTION_MODES}")
        d = hidden_size
        self.hidden_size, self.num_heads = d, num_heads
        self.mlp_hidden = int(d * mlp_ratio)
        self.packed_threshold = packed_threshold
        self.dtype = dtype
        self.qk_scale = qk_scale
        self.linear_mode = attention_mode == "linear"
        self.fused_temporal = fused_temporal
        kinit = inits.attn_kernel_init_ if reference_init else inits.torch_linear_init_
        self.linear1 = linear(d, 3 * d + self.mlp_hidden, kinit, gen)
        self.linear2 = linear(d + self.mlp_hidden, d, kinit, gen)
        self.norm = QKNorm(d // num_heads)
        self.tp = None  # parallel/tp.py: how the shards meet, once sharded

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                backend: str = "auto") -> torch.Tensor:
        dt = self.dtype
        b2 = self.linear2.bias.to(dt)
        qs, ks = self.norm.query_norm.scale, self.norm.key_norm.scale
        if self.tp is not None:
            # the input and the QK-norm scales enter the shards, which each
            # give back their part of the grads, summed over the model group;
            # each shard's fp32 partial (K8 on its route in bf16 and fp32: the
            # Hopper kernel, the WMMA kernel below a Hopper head group, the
            # fp32 outer- or dot-product kernel), then one fp32 sum, one
            # rounding and + b2, in either dtype
            xd, qs, ks = (self.tp.enter(t) for t in (x.to(dt), qs, ks))
            h = self.num_heads // self.tp.size
            partials = [self._partial(xd, s.linear1.weight, s.linear1.bias, s.linear2.weight,
                                      qs, ks, h, cos, sin, backend) for s in self.shards]
            return self.tp.reduce(partials).to(dt) + b2
        xd = x.to(dt)
        w1, b1, w2 = self.linear1.weight, self.linear1.bias, self.linear2.weight
        if x.shape[1] <= self.packed_threshold and not self.linear_mode:
            block = reference_spatial_block if backend == "plain" else fused_spatial_block
            return block(xd, w1.to(dt), b1.to(dt), qs, ks, w2.to(dt), b2, cos, sin,
                         self.num_heads, float(self._scale()))
        return self._partial(xd, w1, b1, w2, qs, ks, self.num_heads, cos, sin,
                             backend).to(dt) + b2

    def _scale(self) -> float:
        dh = self.hidden_size // self.num_heads
        return self.qk_scale if self.qk_scale is not None else dh ** -0.5

    def _partial(self, xd, w1, b1, w2, q_scale, k_scale, h, cos, sin, backend) -> torch.Tensor:
        """linear2's fp32 product, without b2, of the block over ``h`` heads
        and the MLP columns of ``w1 [3Da+Mr, D]``, ``b1`` and ``w2 [D, Da+Mr]``
        (the whole block, or a tensor-parallel shard)."""
        dt = self.dtype
        dh = self.hidden_size // self.num_heads
        d = h * dh  # Da: the q, k and v columns of the h heads
        b, n = xd.shape[0], xd.shape[1]
        scale = self._scale()
        plain = backend == "plain"
        w1, b1, w2 = w1.to(dt), b1.to(dt), w2.to(dt)
        if n <= self.packed_threshold and not self.linear_mode:
            block = reference_spatial_block if plain else fused_spatial_block
            return block(xd, w1, b1, q_scale, k_scale, w2, None, cos, sin, h, float(scale),
                         attn_width=d, partial=True)

        # linear1 computes only the q/k/v columns here; the MLP branch reads x.
        qkv = torch.matmul(xd, w1[:3 * d].t()) + b1[:3 * d]
        if self.linear_mode:
            q, k, v = (t.transpose(1, 2) for t in qkv.view(b, n, 3, h, dh).unbind(2))
            q = headmajor_rope(headmajor_rmsnorm(q, q_scale), cos, sin)
            k = headmajor_rope(headmajor_rmsnorm(k, k_scale), cos, sin)
            attn = linear_attention(q, k, v).transpose(1, 2).reshape(b, n, d)
        elif self.fused_temporal:
            # K10 on packed views of linear1's output, lane tables and [1, D]
            # tiled scales (latent_dit.py:309-311)
            cos_l, sin_l = lane_rope_tables(cos, sin, h)
            q, k, v = qkv.split(d, dim=-1)
            attn_fn = reference_fused_temporal if plain else fused_temporal_attention
            attn = attn_fn(q, k, v, cos_l, sin_l, q_scale.repeat(h)[None],
                           k_scale.repeat(h)[None], h, float(scale))
        elif dh % 128 == 0:
            # raw head-major q/k/v views; the kernel norms and rotates q/k
            q, k, v = (t.transpose(1, 2) for t in qkv.view(b, n, 3, h, dh).unbind(2))
            attn_fn = reference_attention_normrope if plain else flash_attention_normrope
            ah = attn_fn(q, k, v, q_scale, k_scale, cos, sin, scale=self.qk_scale)
            attn = ah.transpose(1, 2).reshape(b, n, d)
        else:
            q, k, _ = qkv.view(b, n, 3, h, dh).unbind(2)  # packed [B', n, H, dh] views
            rope = (cos[:, None, :], sin[:, None, :])
            q = headmajor_rope(headmajor_rmsnorm(q, q_scale), *rope).reshape(b, n, d)
            k = headmajor_rope(headmajor_rmsnorm(k, k_scale), *rope).reshape(b, n, d)
            attn = attention_packed(q, k, qkv[..., 2 * d:], h, scale=self.qk_scale,
                                    backend=backend)

        mlp_fn = reference_mlp if plain else fused_mlp
        out32 = torch.matmul(attn.float(), w2[:, :d].float().t())
        return out32 + mlp_fn(xd, w1[3 * d:].t(), b1[3 * d:], w2[:, d:].t())


def _adaln_fn(backend: str):
    return reference_residual_adaln_modulate if backend == "plain" else residual_adaln_modulate


class LatentDiTLayer(nn.Module):
    """One factorized spatial + temporal AdaLN block (latent_si_v31.py:19-63)."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float,
                 reference_init: bool, packed_threshold: int, dtype: torch.dtype,
                 gen: torch.Generator, attention_mode: str = "scaled_dot_product"):
        super().__init__()
        self.dtype = dtype
        self.modulation = Modulation(hidden_size, zero_init=reference_init, gen=gen)
        common = (hidden_size, num_heads, mlp_ratio, reference_init, packed_threshold, dtype)
        self.spatial_block = ParallelMLPAttention(*common, gen=gen, attention_mode=attention_mode)
        self.temporal_block = ParallelMLPAttention(*common, gen=gen, attention_mode=attention_mode)

    def forward(self, x, pend_h, pend_gate, vec, sp_cos, sp_sin, tm_cos, tm_sin,
                backend: str = "auto"):
        """(x, pending residual, pending gate) -> same triple.

        The previous block's temporal residual is applied here, together with
        this block's first LN + modulate; the caller applies the last one
        before the output AdaLN (deferred residual, latent_dit.py:450-491).
        """
        b, t, l, d = x.shape
        (shift1, scale1, gate1), (shift2, scale2, gate2) = self.modulation(vec, self.dtype)
        adaln = _adaln_fn(backend)
        x, h = adaln(x, pend_h, pend_gate, shift1, scale1)
        h = self.spatial_block(h.reshape(b * t, l, d), sp_cos, sp_sin, backend).reshape(b, t, l, d)
        x, h = adaln(x, h, gate1, shift2, scale2)
        h = h.transpose(1, 2).reshape(b * l, t, d)
        h = self.temporal_block(h, tm_cos, tm_sin, backend).reshape(b, l, t, d).transpose(1, 2)
        return x, h, gate2


class LatentDiT(nn.Module):
    """Conditional latent-trajectory denoiser (reference LatentSIV3).

    forward(x, t, x_cond, x_cond_mask, y=None):
      x, x_cond: [B, T, L, in_dim]; t: [B] in [0, 1];
      x_cond_mask: [B, T, L] int (1 = conditioning frame); y: [B, vec_in_dim].
    Returns fp32 [B, T, L, in_dim].

    ``reference_init=True`` zeroes every gate and the output layer, as the
    reference does; ``reference_init=False`` draws them from the torch
    Linear default instead. ``generator`` seeds the fresh init (a CPU
    generator; the parameters are drawn on the CPU and moved to ``device``).
    ``device`` defaults to the CUDA card, so a missing card raises; pass
    ``device="cpu"`` to run on the CPU. ``checkpointing=True`` keeps only
    each layer's inputs for the backward and recomputes the layer there.
    ``attention_mode="linear"`` takes linear attention on both axes;
    ``share_weights=True`` builds one layer and applies it ``depth`` times.
    """

    def __init__(self, depth: int, in_dim: int, hidden_size: int, num_heads: int,
                 vec_in_dim: Optional[int] = None, mlp_ratio: float = 2.0,
                 theta: float = 10_000.0, normalize: bool = False,
                 reference_init: bool = True, packed_threshold: int = 8,
                 backend: str = "auto", dtype: torch.dtype = torch.float32,
                 checkpointing: bool = False, attention_mode: str = "scaled_dot_product",
                 share_weights: bool = False, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} not divisible by num_heads {num_heads}")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        d = hidden_size
        self.depth, self.hidden_size, self.num_heads = depth, d, num_heads
        self.theta, self.normalize = theta, normalize
        self.backend, self.dtype, self.checkpointing = backend, dtype, checkpointing
        self.share_weights = share_weights
        kinit = inits.attn_kernel_init_ if reference_init else inits.torch_linear_init_
        self.x_in = linear(in_dim, d, kinit, gen)
        self.cond_to_emb = linear(in_dim, d, kinit, gen)
        self.mask_to_emb = nn.utils.skip_init(nn.Embedding, 2, d)
        inits.normal_(self.mask_to_emb.weight, gen, 1.0)
        self.time_in = MLPEmbedder(256, d, gen)
        self.vec_in = MLPEmbedder(vec_in_dim, d, gen) if vec_in_dim is not None else None
        self.blocks = nn.ModuleList(
            LatentDiTLayer(d, num_heads, mlp_ratio, reference_init, packed_threshold, dtype, gen,
                           attention_mode)
            for _ in range(1 if share_weights else depth))
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), linear(d, 2 * d, kinit, gen))
        out_init = inits.zeros_ if reference_init else inits.torch_linear_init_
        self.linear = linear(d, in_dim, out_init, gen)
        self.to(device)

    def forward(self, x: torch.Tensor, t: torch.Tensor, x_cond: torch.Tensor,
                x_cond_mask: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t_len, l_len, _ = x.shape
        dt = self.dtype
        h = (dense(x, self.x_in, dt) + dense(x_cond, self.cond_to_emb, dt)
             + self.mask_to_emb.weight[x_cond_mask.long()].to(dt))
        if self.normalize:
            h = layer_norm(h, eps=1e-5)
        vec = self.time_in(timestep_embedding(t, 256).to(dt), dt)
        if y is not None:
            if self.vec_in is None:
                raise ValueError("y given but vec_in_dim not configured")
            vec = vec + self.vec_in(y, dt)

        pe_dim = self.hidden_size // self.num_heads
        sp_cos, sp_sin = rope_cos_sin(l_len, pe_dim, self.theta, device=x.device)
        tm_cos, tm_sin = rope_cos_sin(t_len, pe_dim, self.theta, device=x.device)

        pend_h = torch.zeros_like(h)
        pend_gate = torch.zeros((b, 1, 1, self.hidden_size), dtype=dt, device=x.device)
        blocks = [self.blocks[0]] * self.depth if self.share_weights else self.blocks
        for block in blocks:
            args = (h, pend_h, pend_gate, vec, sp_cos, sp_sin, tm_cos, tm_sin, self.backend)
            if self.checkpointing:
                h, pend_h, pend_gate = checkpoint(block, *args, use_reentrant=False)
            else:
                h, pend_h, pend_gate = block(*args)

        mod = dense(F.silu(vec), self.adaLN_modulation[1], dt)
        shift, scale = mod[:, None, None, :].chunk(2, dim=-1)
        _, h = _adaln_fn(self.backend)(h, pend_h, pend_gate, shift, scale)
        return dense(h, self.linear, dt).float()
