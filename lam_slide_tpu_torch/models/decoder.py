"""Query-based entity-linked decoders (counterpart of
``lam_slide_tpu/models/decoder.py``; reference decoder.py:12-310).

Entity codes -> query MLP; self-attention over the latent set; optional
cross-attention latents <- queries; a final cross-attention queries <-
latents (``output_block``); one MLP head per named output. The frozen
entity table the backbone shares with the encoder sits in
``entity_embedding``, so the state_dict keys are the reference's
(``query_mlp.1``, ``self_attn_blocks.{i}``, ``cross_attn_blocks.{i}``,
``output_block``, ``output_layers.<name>.{0,2}``, ``entity_embedding.*``;
``DecoderQuerySplitter`` adds ``extender.1``, the reference's Conv1d). In
train mode
(``deterministic=False``) ``dropout_query`` (0.1 in MD17) and
``dropout_latent`` (0) draw from the caller's generator (decoder.py:51-69);
in eval nothing is dropped.

With 192 latents on the card the self-attention reaches the flash kernel K1
in fp32 (and K4 in its backward); the output block's queries (one per
entity, 32 for MD17) stay on the plain path, as ``_pick_backend`` keeps them
below 128.
"""

from typing import Callable, Dict, Mapping, Optional

import torch
from torch import nn

from lam_slide_tpu_torch.nn import initializers as inits
from lam_slide_tpu_torch.nn.blocks import (
    CrossAttentionBlock,
    Dropout,
    SelfAttentionBlock,
    dropout,
    gelu_tanh,
    mlp,
    run_mlp,
)
from lam_slide_tpu_torch.nn.dense import dense, linear
from lam_slide_tpu_torch.nn.embeddings import EntityEmbedding


class _DecoderCore(nn.Module):
    """Shared trunk and heads of the decoder variants."""

    def __init__(self, outputs: Mapping[str, int], dim_latent: int, dim_entity: int,
                 dim_query: int, dim_head_cross: int = 64, dim_head_latent: int = 64,
                 num_head_cross: int = 1, num_head_latent: int = 4, num_block_cross: int = 2,
                 num_block_attn: int = 4, dropout_query: float = 0.1,
                 dropout_latent: float = 0.0, qk_norm: bool = False, act: Callable = gelu_tanh,
                 backend: str = "auto", dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.act, self.dtype = act, dtype
        self.dim_query = dim_query
        self.dropout_latent = dropout_latent
        self.entity_embedding: Optional[EntityEmbedding] = None  # set by the backbone
        self.query_mlp = nn.Sequential(
            Dropout(dropout_query),
            linear(dim_entity, dim_query, inits.torch_linear_init_, gen))
        cross = dict(heads=num_head_cross, dim_head=dim_head_cross, qk_norm=qk_norm, act=act,
                     backend=backend, dtype=dtype, gen=gen)
        self.self_attn_blocks = nn.ModuleList(
            SelfAttentionBlock(dim_latent, num_head_latent, dim_head_latent, qk_norm, act,
                               backend=backend, dtype=dtype, gen=gen)
            for _ in range(num_block_attn))
        self.cross_attn_blocks = nn.ModuleList(
            CrossAttentionBlock(dim_latent, dim_query, **cross) for _ in range(num_block_cross))
        self.output_block = CrossAttentionBlock(dim_query, dim_latent, **cross)
        self.output_layers = nn.ModuleDict(
            {name: mlp((dim_query, dim_query, out_dim), act, gen)
             for name, out_dim in outputs.items()})
        self._cross = cross  # the output block's settings, for the variants' extra blocks

    def queries_from(self, entity_emb: torch.Tensor, deterministic: bool,
                     generator: Optional[torch.Generator]) -> torch.Tensor:
        q = self.query_mlp[0](entity_emb.to(self.dtype), generator, deterministic)
        return dense(q, self.query_mlp[1], self.dtype)

    def trunk(self, latent: torch.Tensor, queries: torch.Tensor, deterministic: bool,
              generator: Optional[torch.Generator]) -> torch.Tensor:
        """Self-attention over the latents, then cross-attention latents <- queries."""
        latent = dropout(latent, self.dropout_latent, generator, deterministic)
        for block in self.self_attn_blocks:
            latent = block(latent)
        for block in self.cross_attn_blocks:
            latent = block(latent, queries)
        return latent

    def heads(self, h: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {name: run_mlp(head, h, self.dtype) for name, head in self.output_layers.items()}


class Decoder(_DecoderCore):
    """Standard decoder (reference decoder.py:12-102)."""

    def forward(self, latent: torch.Tensor, entity_emb: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """latent: [B, L, D]; entity_emb: [B, N, E] -> {name: [B, N, out_dim]};
        ``generator`` draws the train-mode dropouts."""
        queries = self.queries_from(entity_emb, deterministic, generator)
        latent = self.trunk(latent, queries, deterministic, generator)
        return self.heads(self.output_block(queries, latent))


class DecoderFE(_DecoderCore):
    """Decoder plus a learned global energy query (reference
    decoder.py:105-216): one query cross-attends onto the processed latents
    and maps to a scalar per sample under ``"energy"``."""

    def __init__(self, outputs: Mapping[str, int], dim_latent: int, dim_entity: int,
                 dim_query: int, **kwargs):
        super().__init__(outputs, dim_latent, dim_entity, dim_query, **kwargs)
        gen = self._cross["gen"]
        self.energy_query = nn.Parameter(inits.normal_(torch.empty(dim_query), gen, 1.0))
        self.energy_block = CrossAttentionBlock(dim_query, dim_latent, **self._cross)
        self.energy_mlp = mlp((dim_query, dim_query, 1), self.act, gen)

    def forward(self, latent: torch.Tensor, entity_emb: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        queries = self.queries_from(entity_emb, deterministic, generator)
        latent = self.trunk(latent, queries, deterministic, generator)
        out = self.heads(self.output_block(queries, latent))
        eq = self.energy_query.to(self.dtype).expand(latent.shape[0], 1, -1)
        e = run_mlp(self.energy_mlp, self.energy_block(eq, latent), self.dtype)
        out["energy"] = e[..., 0]
        return out


class Decoder2(_DecoderCore):
    """Decoder with a learned query bias shared across entities (reference
    decoder.py:219-310): queries = query_mlp(entity_emb) + query."""

    def __init__(self, outputs: Mapping[str, int], dim_latent: int, dim_entity: int,
                 dim_query: int, **kwargs):
        super().__init__(outputs, dim_latent, dim_entity, dim_query, **kwargs)
        self.query = nn.Parameter(inits.normal_(torch.empty(dim_query), self._cross["gen"], 1.0))

    def forward(self, latent: torch.Tensor, entity_emb: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        queries = (self.queries_from(entity_emb, deterministic, generator)
                   + self.query.to(self.dtype))
        latent = self.trunk(latent, queries, deterministic, generator)
        return self.heads(self.output_block(queries, latent))


class DecoderQuerySplitter(_DecoderCore):
    """Decoder that widens the latent set L -> L * num_split before the
    output cross-attention (reference decoder.py:313-411; the peptide
    decoder).

    ``extender.1`` is the reference's ``Conv1d(D, D * num_split, 1)`` (weight
    ``[D * num_split, D, 1]``), applied as one dense layer in the compute
    dtype; its output channel ``(d, n)`` is d-major, the reference's
    ``B (D N) L -> B (L N) D``, so token ``l * num_split + n`` takes channels
    ``d * num_split + n``.
    """

    def __init__(self, outputs: Mapping[str, int], dim_latent: int, dim_entity: int,
                 dim_query: int, num_split: int = 8, **kwargs):
        super().__init__(outputs, dim_latent, dim_entity, dim_query, **kwargs)
        self.num_split = num_split
        conv = nn.utils.skip_init(nn.Conv1d, dim_latent, dim_latent * num_split, 1)
        with torch.no_grad():
            conv.weight.copy_(inits.torch_linear_init_(
                torch.empty(dim_latent * num_split, dim_latent), self._cross["gen"])[..., None])
            conv.bias.zero_()
        self.extender = nn.Sequential(nn.Identity(), conv)

    def forward(self, latent: torch.Tensor, entity_emb: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        queries = self.queries_from(entity_emb, deterministic, generator)
        latent = self.trunk(latent, queries, deterministic, generator)
        b, l, d = latent.shape
        conv = self.extender[1]
        ext = (torch.matmul(latent.to(self.dtype), conv.weight[..., 0].to(self.dtype).t())
               + conv.bias.to(self.dtype))
        ext = ext.reshape(b, l, d, self.num_split).transpose(2, 3).reshape(b, l * self.num_split, d)
        return self.heads(self.output_block(queries, ext))
