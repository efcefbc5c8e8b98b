"""Perceiver-style attention blocks (counterpart of ``lam_slide_tpu/nn/blocks.py``).

PreNorm cross/self attention with residuals and a GELU feed-forward, the
UPT encoder/decoder building blocks (reference torch_modules.py:108-273).
Attribute names follow the reference's state_dict keys
(``attn.fn.to_q``, ``attn.norm``, ``ff.fn.net.0.0``, ...), so reference
weights load with ``load_state_dict``. Dense layers compute in ``dtype``
with the weights cast at each use, as flax ``nn.Dense(dtype=...)`` does;
norm and softmax statistics stay fp32. The dropouts (``dropout``,
``dropout_seq``) draw from a ``torch.Generator`` the caller passes, never
from the global RNG.
"""

import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from lam_slide_tpu_torch.nn import initializers as inits
from lam_slide_tpu_torch.nn.dense import dense, linear
from lam_slide_tpu_torch.nn.norms import LayerNorm, QKNorm, rms_normalize
from lam_slide_tpu_torch.ops.attention import BACKENDS, attention
from lam_slide_tpu_torch.parallel import rows as batch_rows


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU — the activation the reference configs select
    (torch_modules.py:36-50). Computed in fp32 with a real erf, rounded once
    to x.dtype."""
    x32 = x.float()
    return (0.5 * x32 * (1.0 + torch.erf(x32 * (2.0 ** -0.5)))).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU (``jax.nn.gelu(approximate=True)``), in fp32,
    rounded once to x.dtype."""
    x32 = x.float()
    inner = math.sqrt(2.0 / math.pi) * (x32 + 0.044715 * x32 * x32 * x32)
    return (0.5 * x32 * (1.0 + torch.tanh(inner))).to(x.dtype)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            deterministic: bool = True, broadcast_dims: Tuple[int, ...] = ()) -> torch.Tensor:
    """flax ``nn.Dropout(rate, broadcast_dims)``: in train mode
    (``deterministic=False``) keep each element with probability 1 - rate,
    drawn from ``generator`` (on x's device), and scale the kept ones by
    1 / (1 - rate); ``broadcast_dims`` share one draw along those axes (the
    encoder's latent-token dropout drops whole rows). Identity when
    deterministic or rate is 0. The draws are torch's, not JAX's."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator")
    if rate >= 1.0:
        return torch.zeros_like(x)
    shape = [1 if i in broadcast_dims else n for i, n in enumerate(x.shape)]
    keep = batch_rows.rand(shape, generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class Dropout(nn.Module):
    """A parameter-free dropout slot in a ``Sequential`` (keeps the
    reference's layer indices, e.g. ``query_mlp.1``); call it with the
    generator: ``slot(x, generator, deterministic)``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                deterministic: bool = True) -> torch.Tensor:
        return dropout(x, self.rate, generator, deterministic)


def dropout_seq(x: torch.Tensor, mask: Optional[torch.Tensor], rate: float,
                generator: torch.Generator) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Random sequence-element dropout with compaction (``dropout_seq``,
    nn/blocks.py:55-73; reference torch_modules.dropout_seq): keeps
    max(1, int(n * (1 - rate))) elements of the sequence axis per batch row,
    chosen by scores drawn from ``generator``, padding (``mask`` False)
    dropped first. Returns (x, mask) gathered to that length."""
    b, n = x.shape[:2]
    keep = max(1, int(n * (1.0 - rate)))
    scores = batch_rows.rand((b, n), generator, device=x.device)
    if mask is not None:
        scores = torch.where(mask, scores, -1.0)
    idx = torch.argsort(-scores, dim=1)[:, :keep]
    rows = torch.arange(b, device=x.device)[:, None]
    return x[rows, idx], None if mask is None else mask[rows, idx]


def set_backend(model: nn.Module, backend: str) -> None:
    """Point every module of ``model`` that dispatches attention or kernels
    (a ``backend`` attribute) at ``backend`` ("auto" or "plain")."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    for module in model.modules():
        if hasattr(module, "backend"):
            module.backend = backend


class Activation(nn.Module):
    """A parameter-free activation in a ``Sequential`` slot (keeps the
    reference's layer indices, e.g. ``mlp.0`` / ``mlp.2``)."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)


def mlp(dims, act: Callable, gen: torch.Generator) -> nn.Sequential:
    """Linear, act, Linear, ... over ``dims`` (torch Linear default init);
    run it with ``run_mlp``."""
    layers = []
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        if i:
            layers.append(Activation(act))
        layers.append(linear(d_in, d_out, inits.torch_linear_init_, gen))
    return nn.Sequential(*layers)


def run_mlp(seq: nn.Sequential, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    for layer in seq:
        x = dense(x, layer, dtype) if isinstance(layer, nn.Linear) else layer(x)
    return x


class FeedForward(nn.Module):
    """MLP: (in -> dim, act) x depth -> out (torch_modules.py:125-144); keys
    ``net.{i}.0`` for the hidden layers and ``net.{depth}`` for the output."""

    def __init__(self, dim_in: int, dim: int, depth: int = 1, out_dim: Optional[int] = None,
                 act: Callable = gelu_exact, dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.act, self.dtype = act, dtype
        layers = [nn.Sequential(linear(dim_in if i == 0 else dim, dim, inits.torch_linear_init_,
                                       gen))
                  for i in range(depth)]
        layers.append(linear(dim if depth else dim_in, out_dim or dim, inits.torch_linear_init_,
                             gen))
        self.net = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for hidden in self.net[:-1]:
            x = self.act(dense(x, hidden[0], self.dtype))
        return dense(x, self.net[-1], self.dtype)


class Attention(nn.Module):
    """Multi-head attention; queries from x, keys/values from the context
    (torch_modules.py:147-253). Biasless projections with xavier(1/sqrt 2)
    init, optional per-head QKNorm, an output projection with xavier(1) and
    zero bias.

    Self-attention (``context_dim=None``) holds the reference
    ``SelfAttention``'s fused ``to_qkv``; cross-attention ``to_q`` and
    ``to_kv``. The JAX module always splits them, ``to_q`` being the first
    ``heads * dim_head`` rows of ``to_qkv``; the products are the same.
    ``mask`` is a ``[B, Lk]`` boolean key-padding mask (True = attend).
    """

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: Optional[int] = None,
                 qk_norm: bool = False, scale: Optional[float] = None, backend: str = "auto",
                 dtype: torch.dtype = torch.float32, gen: Optional[torch.Generator] = None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.scale = heads, dim_head, scale
        self.backend, self.dtype = backend, dtype
        if context_dim is None:
            self.to_qkv = linear(dim, 3 * inner, lambda w, g: w, gen, bias=False)
            inits.attn_kernel_init_(self.to_qkv.weight.data[:inner], gen)
            inits.attn_kernel_init_(self.to_qkv.weight.data[inner:], gen)
        else:
            self.to_q = linear(dim, inner, inits.attn_kernel_init_, gen, bias=False)
            self.to_kv = linear(context_dim, 2 * inner, inits.attn_kernel_init_, gen, bias=False)
        self.to_out = linear(inner, dim, inits.xavier_uniform_, gen)
        self.norm = QKNorm(dim_head) if qk_norm else None

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h, dh = self.heads, self.dim_head
        inner = h * dh
        if hasattr(self, "to_qkv"):
            q, k, v = dense(x, self.to_qkv, self.dtype).split(inner, dim=-1)
        else:
            q = dense(x, self.to_q, self.dtype)
            k, v = dense(context, self.to_kv, self.dtype).split(inner, dim=-1)
        q, k, v = (t.unflatten(-1, (h, dh)).transpose(-3, -2) for t in (q, k, v))  # [B, H, L, dh]
        if self.norm is not None:
            q = (rms_normalize(q) * self.norm.query_norm.scale.to(q.dtype)).to(v.dtype)
            k = (rms_normalize(k) * self.norm.key_norm.scale.to(k.dtype)).to(v.dtype)
        scale = self.scale if self.scale is not None else dh ** -0.5
        out = attention(q, k, v, mask=mask, scale=scale, backend=self.backend)
        return dense(out.transpose(-3, -2).flatten(-2), self.to_out, self.dtype)


class PreNorm(nn.Module):
    """``fn`` after an affine LayerNorm of its input (``norm``) and, for
    cross-attention, of its context (``norm_context``)."""

    def __init__(self, dim: int, fn: nn.Module, context_dim: Optional[int] = None):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.fn = fn
        self.norm_context = LayerNorm(context_dim) if context_dim is not None else None


class CrossAttentionBlock(nn.Module):
    """PreNorm cross-attention + PreNorm FF, both residual (torch_modules.py:189-218)."""

    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int,
                 qk_norm: bool = False, act: Callable = gelu_exact, scale: Optional[float] = None,
                 backend: str = "auto", dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.attn = PreNorm(dim, Attention(dim, heads, dim_head, context_dim, qk_norm, scale,
                                           backend, dtype, gen), context_dim)
        self.ff = PreNorm(dim, FeedForward(dim, dim, act=act, dtype=dtype, gen=gen))

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        a = self.attn
        x = a.fn(a.norm(x), context=a.norm_context(context), mask=mask) + x
        return self.ff.fn(self.ff.norm(x)) + x


class SelfAttentionBlock(nn.Module):
    """PreNorm self-attention + PreNorm FF, both residual (torch_modules.py:256-273)."""

    def __init__(self, dim: int, heads: int, dim_head: int, qk_norm: bool = False,
                 act: Callable = gelu_exact, scale: Optional[float] = None,
                 backend: str = "auto", dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.attn = PreNorm(dim, Attention(dim, heads, dim_head, None, qk_norm, scale, backend,
                                           dtype, gen))
        self.ff = PreNorm(dim, FeedForward(dim, dim, act=act, dtype=dtype, gen=gen))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.attn.fn(self.attn.norm(x), mask=mask) + x
        return self.ff.fn(self.ff.norm(x)) + x
