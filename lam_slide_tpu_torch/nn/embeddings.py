"""Embeddings (counterpart of ``lam_slide_tpu/nn/embeddings.py``).

Ported: the timestep embedding, the 1D sin-cos position table and its
``SinCosPositionalEmbedding1D``, ``PointEmbed``, ``Embed`` with its max_norm
row clamp and the frozen orthogonal ``EntityEmbedding``. Attribute names
follow the reference's state_dict keys.
"""

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from lam_slide_tpu_torch.nn import initializers as inits
from lam_slide_tpu_torch.nn.dense import dense, linear


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10_000.0,
                       time_factor: float = 1000.0) -> torch.Tensor:
    """Sinusoidal diffusion-time embedding (reference mmdit.py:93-113).

    t: [B] fractional timesteps in [0, 1]; returns [B, dim] = [cos | sin], fp32.
    """
    t = time_factor * t.float()
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def sincos_position_table(n_positions: int, embed_dim: int) -> np.ndarray:
    """1D sin-cos position table (reference embeddings.py:6-26): [sin | cos]."""
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10_000**omega
    pos = np.arange(n_positions, dtype=np.float64)
    out = np.einsum("m,d->md", pos, omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1).astype(np.float32)


class SinCosPositionalEmbedding1D(nn.Module):
    """Adds the fixed sin-cos table to x[:, :S] (embeddings.py:41-47). The
    table is the reference's persistent buffer ``embeddings``, so its
    state_dict key is ``<name>.embeddings``; nothing trains it."""

    def __init__(self, n_positions: int, embed_dim: int):
        super().__init__()
        self.register_buffer("embeddings",
                             torch.from_numpy(sincos_position_table(n_positions, embed_dim)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.embeddings[:x.shape[-2]][None].to(x.dtype)


class PointEmbed(nn.Module):
    """3D Fourier point embedding (reference embeddings.py:50-88): xyz onto a
    fixed power-of-two frequency basis, sin/cos, the raw coordinates
    appended, one linear layer (``mlp``). The basis is a constant, not
    saved in the state_dict."""

    def __init__(self, hidden_dim: int = 48, embedding_dim: int = 128,
                 dtype: torch.dtype = torch.float32, gen: Optional[torch.Generator] = None):
        super().__init__()
        if hidden_dim % 6:
            raise ValueError(f"PointEmbed hidden_dim {hidden_dim} is not a multiple of 6")
        k = hidden_dim // 6
        e = (2.0 ** torch.arange(k, dtype=torch.float64)) * math.pi
        basis = torch.zeros(3, 3 * k, dtype=torch.float64)
        for axis in range(3):
            basis[axis, axis * k:(axis + 1) * k] = e
        self.register_buffer("basis", basis.float(), persistent=False)  # [3, hidden_dim/2]
        self.dtype = dtype
        self.mlp = linear(hidden_dim + 3, embedding_dim, inits.lecun_normal_, _gen(gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        proj = torch.matmul(x.float(), self.basis)
        feats = torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
        feats = torch.cat([feats.to(x.dtype), x], dim=-1)
        return dense(feats, self.mlp, self.dtype)


class Embed(nn.Module):
    """Trainable embedding (torch ``nn.Embedding`` key ``weight``, N(0, 1)
    init) whose rows are clamped to ``max_norm`` at lookup without changing
    the stored table, as the JAX ``Embed`` does."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 max_norm: Optional[float] = None, dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.max_norm, self.dtype = max_norm, dtype
        self.weight = nn.Parameter(inits.normal_(torch.empty(num_embeddings, embedding_dim),
                                                 _gen(gen), 1.0))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        table = self.weight
        if self.max_norm is not None:
            norms = torch.linalg.vector_norm(table.float(), dim=-1, keepdim=True)
            factor = torch.clamp(self.max_norm / torch.clamp(norms, min=1e-12), max=1.0)
            table = table * factor.to(table.dtype)
        return table[ids.long()].to(self.dtype)


class _FrozenTable(nn.Module):
    """Holds a constant ``weight`` buffer (key ``embedding.weight``)."""

    def __init__(self, table: torch.Tensor):
        super().__init__()
        self.register_buffer("weight", table)


class EntityEmbedding(nn.Module):
    """Frozen orthogonal entity codes (reference entity_embeddings.py:7-30):
    a buffer, never a parameter, so no gradient or optimizer touches it (the
    JAX ``constants`` collection). Rows are orthonormal (n_entities <=
    embedding_dim), so the reference's max_norm=1 clamp is a no-op."""

    def __init__(self, n_entities: int, embedding_dim: int, dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        table = inits.orthogonal_rows_(torch.empty(n_entities, embedding_dim), _gen(gen))
        self.embedding = _FrozenTable(table)

    def forward(self, entities: torch.Tensor) -> torch.Tensor:
        return self.embedding.weight[entities.long()].to(self.dtype)


def _gen(gen: Optional[torch.Generator]) -> torch.Generator:
    return gen if gen is not None else torch.Generator().manual_seed(0)
