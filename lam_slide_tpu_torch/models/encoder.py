"""Entity-linked UPT/Perceiver encoder (counterpart of
``lam_slide_tpu/models/encoder.py``; reference encoder.py:11-162).

Compresses one frame of N entities into ``num_latents`` latent tokens:
cross-attention from learned latent queries onto the per-entity features
(keys masked where ``mask`` is False), then self-attention among the
latents. As in JAX, the caller passes the already embedded entity codes.
``entity_embedding`` holds the frozen entity table the backbone shares with
the decoder (the reference passes one module to both), so the state_dict
keys are the reference's: ``latents``, ``mlp.{0,2}``, ``entity_embedding.*``,
``cross_attn_blocks.{i}`` and ``blocks_attn.{i}`` (``Encoder``), or
``cross_attn_blocks.{i}.{0,1}`` (``Encoder2``).

With 192 latents on the card both attentions reach the flash kernel K1:
fp32 operands (stage 1 runs in fp32), the cross-attention with the mask's
bias row; under autograd their backward is K4 with the same bias and dtype.
In train mode (``deterministic=False``) the latent token dropout
(``dropout_latent``, 0 in the MD17 config) zeroes whole latent rows with
draws from the caller's generator (encoder.py:70-75).
"""

from typing import Callable, Optional

import torch
from torch import nn

from lam_slide_tpu_torch.nn import initializers as inits
from lam_slide_tpu_torch.nn.blocks import (
    CrossAttentionBlock,
    SelfAttentionBlock,
    dropout,
    gelu_tanh,
    mlp,
    run_mlp,
)
from lam_slide_tpu_torch.nn.embeddings import EntityEmbedding


class _EncoderBase(nn.Module):
    """Shared input pipeline (reference encoder.py:11-41): entity features
    concatenated with the entity codes, mixed by a bottleneck MLP (ctx ->
    dim_latent -> ctx) into the cross-attention context; learned latent
    queries broadcast over the batch."""

    def __init__(self, dim_input: int, dim_entity: int, dim_latent: int, num_latents: int,
                 dropout_latent: float, act: Callable, dtype: torch.dtype,
                 gen: torch.Generator):
        super().__init__()
        self.dim_latent, self.num_latents = dim_latent, num_latents
        self.dropout_latent = dropout_latent
        self.act, self.dtype = act, dtype
        self.dim_context = dim_input + dim_entity
        self.entity_embedding: Optional[EntityEmbedding] = None  # set by the backbone
        self.mlp = mlp((self.dim_context, dim_latent, self.dim_context), act, gen)
        self.latents = nn.Parameter(inits.normal_(torch.empty(num_latents, dim_latent), gen, 1.0))

    def prepare_inputs(self, x: torch.Tensor, entity_emb: torch.Tensor, deterministic: bool,
                       generator: Optional[torch.Generator]):
        ctx = run_mlp(self.mlp, torch.cat([x, entity_emb.to(x.dtype)], dim=-1), self.dtype)
        latents = self.latents.to(self.dtype).expand(x.shape[0], -1, -1)
        # token dropout (torch Dropout2d over the latent axis): whole rows
        latents = dropout(latents, self.dropout_latent, generator, deterministic,
                          broadcast_dims=(2,))
        return ctx, latents

    def _cross(self, heads, dim_head, qk_norm, backend, gen) -> CrossAttentionBlock:
        return CrossAttentionBlock(self.dim_latent, self.dim_context, heads, dim_head, qk_norm,
                                   self.act, backend=backend, dtype=self.dtype, gen=gen)

    def _self(self, heads, dim_head, qk_norm, backend, gen) -> SelfAttentionBlock:
        return SelfAttentionBlock(self.dim_latent, heads, dim_head, qk_norm, self.act,
                                  backend=backend, dtype=self.dtype, gen=gen)


class Encoder(_EncoderBase):
    """Blocked variant: all cross-attention first, then all self-attention
    (reference encoder.py:44-103)."""

    def __init__(self, dim_input: int, dim_entity: int, dim_latent: int, num_latents: int,
                 dim_head_cross: int = 16, dim_head_latent: int = 16, num_head_cross: int = 8,
                 num_head_latent: int = 2, num_block_cross: int = 1, num_block_attn: int = 1,
                 dropout_latent: float = 0.0, qk_norm: bool = True, act: Callable = gelu_tanh,
                 backend: str = "auto", dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None):
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        super().__init__(dim_input, dim_entity, dim_latent, num_latents, dropout_latent, act,
                         dtype, gen)
        self.cross_attn_blocks = nn.ModuleList(
            self._cross(num_head_cross, dim_head_cross, qk_norm, backend, gen)
            for _ in range(num_block_cross))
        self.blocks_attn = nn.ModuleList(
            self._self(num_head_latent, dim_head_latent, qk_norm, backend, gen)
            for _ in range(num_block_attn))

    def forward(self, x: torch.Tensor, entity_emb: torch.Tensor,
                mask: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: [B, N, F]; entity_emb: [B, N, E]; mask: [B, N] bool (True =
        valid) -> latents [B, num_latents, dim_latent]. ``generator`` draws
        the train-mode dropout."""
        ctx, latents = self.prepare_inputs(x, entity_emb, deterministic, generator)
        for block in self.cross_attn_blocks:
            latents = block(latents, ctx, mask)
        for block in self.blocks_attn:
            latents = block(latents)
        return latents


class Encoder2(_EncoderBase):
    """Interleaved variant: (cross, self) x num_block (reference
    encoder.py:106-162)."""

    def __init__(self, dim_input: int, dim_entity: int, dim_latent: int, num_latents: int,
                 dim_head_cross: int = 16, dim_head_latent: int = 16, num_head_cross: int = 8,
                 num_head_latent: int = 2, num_block: int = 1, dropout_latent: float = 0.0,
                 qk_norm: bool = True, act: Callable = gelu_tanh, backend: str = "auto",
                 dtype: torch.dtype = torch.float32, gen: Optional[torch.Generator] = None):
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        super().__init__(dim_input, dim_entity, dim_latent, num_latents, dropout_latent, act,
                         dtype, gen)
        self.cross_attn_blocks = nn.ModuleList(
            nn.ModuleList([self._cross(num_head_cross, dim_head_cross, qk_norm, backend, gen),
                           self._self(num_head_latent, dim_head_latent, qk_norm, backend, gen)])
            for _ in range(num_block))

    def forward(self, x: torch.Tensor, entity_emb: torch.Tensor,
                mask: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        ctx, latents = self.prepare_inputs(x, entity_emb, deterministic, generator)
        for cross, self_block in self.cross_attn_blocks:
            latents = self_block(cross(latents, ctx, mask))
        return latents
