"""Factorized spatial/temporal latent diffusion transformer, PyTorch port.

Counterpart of ``lam_slide_tpu/models/latent_dit.py`` (reference
``latent_si_v31.py`` + ``mmdit.py``). Module attribute names follow the
reference state_dict keys, so a reference ``state_dict`` (for example
``tests/golden/latent_dit_golden.npz``) loads with ``load_state_dict``.

Parameters are fp32; activations run in ``dtype`` (bf16 for the stage-2
configs), with weights cast at each use as the JAX package does. The
temporal axis (n > ``packed_threshold``) runs QK RMS-norm and RoPE as
elementwise ops, then the flash kernel (K1) for attention and the fused
MLP kernel (K2) for the MLP branch; linear2 adds the two fp32 partials
before a single rounding (latent_dit.py:287-296,415-434). The small spatial
axis runs the plain composition (ops/fused_spatial_block.py).

``backend="auto"`` lets CUDA tensors launch the kernels; ``"plain"`` runs the
plain PyTorch versions everywhere (for comparisons and timing).
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lam_slide_tpu_torch.nn import initializers as inits
from lam_slide_tpu_torch.nn.embeddings import timestep_embedding
from lam_slide_tpu_torch.nn.norms import QKNorm, layer_norm
from lam_slide_tpu_torch.ops.attention import BACKENDS, attention
from lam_slide_tpu_torch.ops.fused_adaln import residual_adaln_modulate
from lam_slide_tpu_torch.ops.fused_mlp import fused_mlp, reference_mlp
from lam_slide_tpu_torch.ops.fused_spatial_block import reference_spatial_block
from lam_slide_tpu_torch.ops.packed_attention import headmajor_rmsnorm, headmajor_rope


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


def dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)``: x @ W in dtype, then + bias in dtype."""
    out = torch.matmul(x.to(dtype), lin.weight.to(dtype).t())
    return out if lin.bias is None else out + lin.bias.to(dtype)


def _linear(d_in: int, d_out: int, init, gen: torch.Generator) -> nn.Linear:
    """nn.Linear with the given weight init and zero bias (flax Dense defaults)."""
    lin = nn.utils.skip_init(nn.Linear, d_in, d_out)  # no draw from the global RNG
    init(lin.weight, gen)
    inits.zeros_(lin.bias)
    return lin


class Modulation(nn.Module):
    """vec [B, D] -> two (shift, scale, gate) triples, each [B, 1, 1, D]
    (mmdit.py:184-197)."""

    def __init__(self, dim: int, zero_init: bool, gen: torch.Generator):
        super().__init__()
        self.lin = _linear(dim, 6 * dim, inits.zeros_ if zero_init else inits.torch_linear_init_, gen)

    def forward(self, vec: torch.Tensor, dtype: torch.dtype):
        out = dense(F.silu(vec), self.lin, dtype)[:, None, None, :]
        parts = out.chunk(6, dim=-1)
        return parts[:3], parts[3:]


class MLPEmbedder(nn.Module):
    """Linear -> SiLU -> Linear vector embedder (mmdit.py:116-124), std-0.02 init."""

    def __init__(self, in_dim: int, hidden_dim: int, gen: torch.Generator):
        super().__init__()
        self.in_layer = _linear(in_dim, hidden_dim, inits.normal_002_, gen)
        self.out_layer = _linear(hidden_dim, hidden_dim, inits.normal_002_, gen)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return dense(F.silu(dense(x, self.in_layer, dtype)), self.out_layer, dtype)


class ParallelMLPAttention(nn.Module):
    """Fused attention ∥ MLP block (reference ParallelMLPAttentionV2).

    One linear1 produces q/k/v and the MLP-up projection; linear2 reduces
    concat(attention, gelu(mlp)). x: [B', n, D] with RoPE tables for the n axis.
    """

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float,
                 reference_init: bool, packed_threshold: int, dtype: torch.dtype,
                 gen: torch.Generator, qk_scale: Optional[float] = None):
        super().__init__()
        d = hidden_size
        self.hidden_size, self.num_heads = d, num_heads
        self.mlp_hidden = int(d * mlp_ratio)
        self.packed_threshold = packed_threshold
        self.dtype = dtype
        self.qk_scale = qk_scale
        kinit = inits.attn_kernel_init_ if reference_init else inits.torch_linear_init_
        self.linear1 = _linear(d, 3 * d + self.mlp_hidden, kinit, gen)
        self.linear2 = _linear(d + self.mlp_hidden, d, kinit, gen)
        self.norm = QKNorm(d // num_heads)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                backend: str = "auto") -> torch.Tensor:
        d, h = self.hidden_size, self.num_heads
        dh = d // h
        b, n = x.shape[0], x.shape[1]
        scale = self.qk_scale if self.qk_scale is not None else dh ** -0.5
        dt = self.dtype
        xd = x.to(dt)
        q_scale = self.norm.query_norm.scale
        k_scale = self.norm.key_norm.scale
        if n <= self.packed_threshold:
            return reference_spatial_block(
                xd, self.linear1.weight, self.linear1.bias, q_scale, k_scale,
                self.linear2.weight, self.linear2.bias, cos, sin, h, float(scale))

        w1 = self.linear1.weight.to(dt)
        b1 = self.linear1.bias.to(dt)
        # linear1 computes only the q/k/v columns here; the MLP branch reads x.
        qkv = (torch.matmul(xd, w1[:3 * d].t()) + b1[:3 * d]).view(b, n, 3, h, dh)
        q, k, v = qkv.unbind(2)  # packed [B', n, H, dh] views
        rope = (cos[:, None, :], sin[:, None, :])
        q = headmajor_rope(headmajor_rmsnorm(q, q_scale), *rope)
        k = headmajor_rope(headmajor_rmsnorm(k, k_scale), *rope)
        ah = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                       scale=self.qk_scale, backend=backend)
        attn = ah.transpose(1, 2).reshape(b, n, d)

        w2 = self.linear2.weight.to(dt)
        mlp_fn = reference_mlp if backend == "plain" else fused_mlp
        out32 = torch.matmul(attn.float(), w2[:, :d].float().t())
        out32 = out32 + mlp_fn(xd, w1[3 * d:].t(), b1[3 * d:], w2[:, d:].t())
        return out32.to(dt) + self.linear2.bias.to(dt)


class LatentDiTLayer(nn.Module):
    """One factorized spatial + temporal AdaLN block (latent_si_v31.py:19-63)."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float,
                 reference_init: bool, packed_threshold: int, dtype: torch.dtype,
                 gen: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.modulation = Modulation(hidden_size, zero_init=reference_init, gen=gen)
        common = (hidden_size, num_heads, mlp_ratio, reference_init, packed_threshold, dtype)
        self.spatial_block = ParallelMLPAttention(*common, gen=gen)
        self.temporal_block = ParallelMLPAttention(*common, gen=gen)

    def forward(self, x, pend_h, pend_gate, vec, sp_cos, sp_sin, tm_cos, tm_sin,
                backend: str = "auto"):
        """(x, pending residual, pending gate) -> same triple.

        The previous block's temporal residual is applied here, together with
        this block's first LN + modulate; the caller applies the last one
        before the output AdaLN (deferred residual, latent_dit.py:450-491).
        """
        b, t, l, d = x.shape
        (shift1, scale1, gate1), (shift2, scale2, gate2) = self.modulation(vec, self.dtype)
        x, h = residual_adaln_modulate(x, pend_h, pend_gate, shift1, scale1)
        h = self.spatial_block(h.reshape(b * t, l, d), sp_cos, sp_sin, backend).reshape(b, t, l, d)
        x, h = residual_adaln_modulate(x, h, gate1, shift2, scale2)
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
    """

    def __init__(self, depth: int, in_dim: int, hidden_size: int, num_heads: int,
                 vec_in_dim: Optional[int] = None, mlp_ratio: float = 2.0,
                 theta: float = 10_000.0, normalize: bool = False,
                 reference_init: bool = True, packed_threshold: int = 8,
                 backend: str = "auto", dtype: torch.dtype = torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} not divisible by num_heads {num_heads}")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        d = hidden_size
        self.depth, self.hidden_size, self.num_heads = depth, d, num_heads
        self.theta, self.normalize = theta, normalize
        self.backend, self.dtype = backend, dtype
        kinit = inits.attn_kernel_init_ if reference_init else inits.torch_linear_init_
        self.x_in = _linear(in_dim, d, kinit, gen)
        self.cond_to_emb = _linear(in_dim, d, kinit, gen)
        self.mask_to_emb = nn.utils.skip_init(nn.Embedding, 2, d)
        inits.normal_(self.mask_to_emb.weight, gen, 1.0)
        self.time_in = MLPEmbedder(256, d, gen)
        self.vec_in = MLPEmbedder(vec_in_dim, d, gen) if vec_in_dim is not None else None
        self.blocks = nn.ModuleList(
            LatentDiTLayer(d, num_heads, mlp_ratio, reference_init, packed_threshold, dtype, gen)
            for _ in range(depth))
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), _linear(d, 2 * d, kinit, gen))
        out_init = inits.zeros_ if reference_init else inits.torch_linear_init_
        self.linear = _linear(d, in_dim, out_init, gen)
        if device is not None:
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
        for block in self.blocks:
            h, pend_h, pend_gate = block(h, pend_h, pend_gate, vec, sp_cos, sp_sin,
                                         tm_cos, tm_sin, self.backend)

        mod = dense(F.silu(vec), self.adaLN_modulation[1], dt)
        shift, scale = mod[:, None, None, :].chunk(2, dim=-1)
        _, h = residual_adaln_modulate(h, pend_h, pend_gate, shift, scale)
        return dense(h, self.linear, dt).float()
