"""Generic first-stage backbone: input embedder -> encoder -> quant
bottleneck -> decoder (counterpart of
``lam_slide_tpu/composites/first_stage.py``; reference
lightning_base.py:17-48).

The latent bottleneck is ``quant = Linear + non-affine LayerNorm`` after
encoding and ``post_quant = non-affine LayerNorm + Linear`` before decoding.
One frozen orthogonal entity table is made here and shared by the encoder
and the decoder (``encoder.entity_embedding`` and
``decoder.entity_embedding`` are the same module, as in the reference).

State_dict keys are the reference domain ``Backbone``'s: the input
embedder's layers sit at the root (for MD17 ``embed_atom``, ``embed_pos``,
``net_merge``), then ``encoder.*``, ``decoder.*``, ``quant.0`` and
``post_quant.1``.
"""

from typing import Dict, Optional

import torch
from torch import nn

from lam_slide_tpu_torch.nn import initializers as inits
from lam_slide_tpu_torch.nn.dense import dense, linear
from lam_slide_tpu_torch.nn.embeddings import EntityEmbedding
from lam_slide_tpu_torch.nn.norms import layer_norm


class _NonAffineLayerNorm(nn.Module):
    """Parameter-free LayerNorm slot of quant / post_quant (eps 1e-5)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, eps=1e-5)


class FirstStageBackbone(nn.Module):
    """encode/decode pair around the latent bottleneck.

    input_embedder: batch dict -> [B, N, F]; encoder: (x, entity_emb, mask)
    -> [B, L, D]; decoder: (latents, entity_emb) -> {name: [B, N, out]}.
    Both take their entity codes from the one table made here.
    """

    def __init__(self, dim_latent: int, n_entities: int, dim_entity: int,
                 input_embedder: nn.Module, encoder: nn.Module, decoder: nn.Module,
                 dtype: torch.dtype = torch.float32, gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.dtype = dtype
        # the reference Backbone holds its input layers at its root
        for name, child in input_embedder.named_children():
            self.add_module(name, child)
        self._embed_inputs = input_embedder.forward  # not a submodule: no second key
        self.encoder, self.decoder = encoder, decoder
        table = EntityEmbedding(n_entities, dim_entity, dtype, gen)
        encoder.entity_embedding = decoder.entity_embedding = table
        self.quant = nn.Sequential(linear(encoder.dim_latent, dim_latent,
                                          inits.torch_linear_init_, gen),
                                   _NonAffineLayerNorm())
        self.post_quant = nn.Sequential(_NonAffineLayerNorm(),
                                        linear(dim_latent, dim_latent, inits.torch_linear_init_,
                                               gen))

    def encode(self, batch: Dict[str, torch.Tensor], deterministic: bool = True,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """batch -> latent z [B, L, dim_latent] (lightning_base.py:36-40)."""
        x = self._embed_inputs(batch)
        entity_emb = self.encoder.entity_embedding(batch["entities"])
        latents = self.encoder(x, entity_emb, batch.get("attention_mask"), deterministic,
                               generator)
        return self.quant[1](dense(latents, self.quant[0], self.dtype))

    def decode(self, z: torch.Tensor, entities: torch.Tensor, deterministic: bool = True,
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """z [B, L, dim_latent] -> named output heads (lightning_base.py:42-44)."""
        latents = dense(self.post_quant[0](z), self.post_quant[1], self.dtype)
        return self.decoder(latents, self.decoder.entity_embedding(entities), deterministic,
                            generator)

    def forward(self, batch: Dict[str, torch.Tensor], deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """encode then decode (composites/first_stage.py:72); in train mode
        (``deterministic=False``) the dropouts draw from ``generator``."""
        z = self.encode(batch, deterministic, generator)
        return self.decode(z, batch["entities"], deterministic, generator)
