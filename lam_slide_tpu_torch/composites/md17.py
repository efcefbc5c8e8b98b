"""MD17 domain composite (counterpart of ``lam_slide_tpu/composites/md17.py``;
reference first_stage/md17.py and second_stage/md17.py).

Stage 1: ``atom-type embedding ⊕ Fourier PointEmbed(pos)`` merged by a
2-layer MLP into the per-atom features of the first-stage backbone, in fp32
(``build_md17_first_stage``'s default dtype, composites/md17.py:93), and its
loss (``make_md17_first_stage_loss``): masked position MSE + pairwise
distance MSE + atom-type CE (+ norm), with the ``dist`` metric in dataset
units through the config's scale (first_stage/md17.py:158-194). Stage 2: the
class-conditional latent DiT over [B, T=30, L=192, 32] latents, in bf16 as
the registry makes it (experiments/registry.py:251-262), with per-layer
checkpointing; its loss is ``SecondStage.make_loss`` with this config's
weights.
"""

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch import nn

from lam_slide_tpu_torch.composites.first_stage import FirstStageBackbone
from lam_slide_tpu_torch.models.decoder import Decoder
from lam_slide_tpu_torch.models.encoder import Encoder
from lam_slide_tpu_torch.nn.blocks import gelu_exact, mlp, run_mlp
from lam_slide_tpu_torch.nn.embeddings import Embed, PointEmbed
from lam_slide_tpu_torch.nn.losses import (
    inter_distance,
    masked_cross_entropy,
    masked_mse,
    masked_norm,
)


class MD17InputEmbedder(nn.Module):
    """atom embed ⊕ PointEmbed(pos) -> merge MLP (first_stage/md17.py:52-58);
    keys ``embed_atom.weight``, ``embed_pos.mlp``, ``net_merge.{0,2}``."""

    def __init__(self, n_atom_types: int, dim_input: int = 128, dim_embed_atom: int = 64,
                 dim_embed_pos: int = 128, dim_embed_pos_hidden: int = 126,
                 act: Callable = gelu_exact, dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.dtype = dtype
        self.embed_atom = Embed(n_atom_types, dim_embed_atom, max_norm=1.0, dtype=dtype, gen=gen)
        self.embed_pos = PointEmbed(dim_embed_pos_hidden, dim_embed_pos, dtype, gen)
        self.net_merge = mlp((dim_embed_atom + dim_embed_pos, dim_input, dim_input), act, gen)

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        atom_emb = self.embed_atom(batch["atom"])
        pos_emb = self.embed_pos(batch["pos"].to(self.dtype))
        return run_mlp(self.net_merge, torch.cat([atom_emb, pos_emb], dim=-1), self.dtype)


@dataclass(frozen=True)
class MD17FirstStageConfig:
    """Mirrors configs/model/md17/first-stage.yaml keys: the architecture and
    the loss section the stage-1 loss reads (its weights, and ``scale``, the
    dataset's normalization, which turns the ``dist`` metric back into
    dataset units)."""

    n_atom_types: int = 10
    num_entities: int = 50
    dim_input: int = 128
    dim_latent: int = 32
    dim_entity: int = 128
    num_latents: int = 192
    dim_head_cross: int = 16
    dim_head_latent: int = 16
    num_head_cross: int = 8
    num_head_latent: int = 2
    enc_num_block_cross: int = 1
    enc_num_block_attn: int = 1
    dec_num_block_cross: int = 0
    dec_num_block_attn: int = 1
    dropout_query: float = 0.1
    qk_norm: bool = True
    # loss weights (configs/model/md17/first-stage.yaml:10-24)
    loss_pos_weight: float = 1.0
    loss_inter_distance_weight: float = 1.0
    loss_atom_type_weight: float = 0.1
    loss_norm_weight: float = 0.0
    scale: float = 1.0


def build_md17_first_stage(cfg: MD17FirstStageConfig, dtype: torch.dtype = torch.float32,
                           device="cuda",
                           generator: Optional[torch.Generator] = None) -> FirstStageBackbone:
    """The MD17 first stage, drawn from ``generator`` (a CPU generator) and
    moved to ``device``: the card by default, so a missing card raises; pass
    ``device="cpu"`` to run on the CPU."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    common = dict(qk_norm=cfg.qk_norm, act=gelu_exact, dtype=dtype, gen=gen)
    embedder = MD17InputEmbedder(cfg.n_atom_types, cfg.dim_input, dtype=dtype, gen=gen)
    encoder = Encoder(cfg.dim_input, cfg.dim_entity, cfg.dim_latent, cfg.num_latents,
                      dim_head_cross=cfg.dim_head_cross, dim_head_latent=cfg.dim_head_latent,
                      num_head_cross=cfg.num_head_cross, num_head_latent=cfg.num_head_latent,
                      num_block_cross=cfg.enc_num_block_cross,
                      num_block_attn=cfg.enc_num_block_attn, **common)
    decoder = Decoder({"pos": 3, "atom": cfg.n_atom_types}, cfg.dim_latent, cfg.dim_entity,
                      cfg.dim_entity, dim_head_cross=cfg.dim_head_cross,
                      dim_head_latent=cfg.dim_head_latent, num_head_cross=cfg.num_head_cross,
                      num_head_latent=cfg.num_head_latent,
                      num_block_cross=cfg.dec_num_block_cross,
                      num_block_attn=cfg.dec_num_block_attn, dropout_query=cfg.dropout_query,
                      **common)
    model = FirstStageBackbone(cfg.dim_latent, cfg.num_entities, cfg.dim_entity, embedder,
                               encoder, decoder, dtype, gen)
    return model.to(device)


@dataclass(frozen=True)
class MD17SecondStageConfig:
    """Mirrors configs/model/md17/second-stage.yaml keys: the model, the
    transport and the loss weights of ``SecondStage.make_loss``; the
    protocol's K and sampler settings are arguments of ``make_k_sample_fn``
    and ``evaluate_md17``."""

    depth: int = 4
    in_dim: int = 32
    hidden_size: int = 256
    num_heads: int = 16
    mlp_ratio: float = 2.0
    cond_idx: tuple = (0, 10)
    mask_cond_mean: bool = True
    path_type: str = "GVP"
    prediction: str = "data"
    # class conditioning (CondWrapper, second_stage/md17.py:182-191)
    class_conditional: bool = False
    n_classes: int = 8
    vec_in_dim: int = 256
    reference_init: bool = False  # md17 config sets reset_parameters: False
    weight_si_loss: float = 1.0
    weight_pos_loss: float = 0.25
    weight_inter_dist_loss: float = 0.25
    calc_additional_losses: bool = True
    # recompute each DiT layer in the backward (composites/md17.py:157-160):
    # with L=192 latent tokens the stored activations of the B=64 step are
    # what checkpointing saves
    checkpointing: bool = True


def build_md17_second_stage(cfg: MD17SecondStageConfig, first_stage: FirstStageBackbone,
                            dtype: torch.dtype = torch.float32, device="cuda",
                            generator: Optional[torch.Generator] = None):
    """Assemble the SecondStage bundle (reference Wrapper/CondWrapper): the
    DiT (wrapped in ``ClassCondDiT`` when class-conditional), drawn from
    ``generator`` and built on ``device`` (the card by default), the GVP
    transport and the frozen first stage."""
    from lam_slide_tpu_torch.composites.second_stage import ClassCondDiT, SecondStage
    from lam_slide_tpu_torch.models import LatentDiT
    from lam_slide_tpu_torch.transport import create_transport

    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    dit = LatentDiT(depth=cfg.depth, in_dim=cfg.in_dim, hidden_size=cfg.hidden_size,
                    num_heads=cfg.num_heads, mlp_ratio=cfg.mlp_ratio,
                    vec_in_dim=cfg.vec_in_dim if cfg.class_conditional else None,
                    reference_init=cfg.reference_init, dtype=dtype,
                    checkpointing=cfg.checkpointing, device=device, generator=gen)
    backbone = (ClassCondDiT(dit, cfg.n_classes, cfg.vec_in_dim, generator=gen).to(device)
                if cfg.class_conditional else dit)
    return SecondStage(
        backbone=backbone,
        transport=create_transport(path_type=cfg.path_type, prediction=cfg.prediction),
        first_stage=first_stage,
        cond_idx=cfg.cond_idx,
        mask_cond_mean=cfg.mask_cond_mean,
        class_conditional=cfg.class_conditional,
    )


def make_md17_first_stage_loss(cfg: MD17FirstStageConfig):
    """loss_fn(model, batch, generator, train) for ``train.make_train_step``
    (JAX ``make_md17_first_stage_loss``; reference Loss.forward,
    first_stage/md17.py:158-194). ``model`` is the first stage (or a call of
    it on other weights); in train mode its dropouts draw from
    ``generator``."""

    def loss_fn(model, batch, generator, train):
        preds = model(batch, deterministic=not train, generator=generator)
        mask = batch["attention_mask"]
        pos_pred = preds["pos"].float()
        atom_pred = preds["atom"].float()
        loss_pos = masked_mse(pos_pred, batch["pos"], mask)
        loss_inter = inter_distance(pos_pred, batch["pos"], mask)
        loss_atom = masked_cross_entropy(atom_pred, batch["atom"], mask)
        loss_norm = masked_norm(pos_pred, batch["pos"], mask)
        total = (cfg.loss_pos_weight * loss_pos + cfg.loss_inter_distance_weight * loss_inter
                 + cfg.loss_atom_type_weight * loss_atom + cfg.loss_norm_weight * loss_norm)
        metrics = {"pos_loss": loss_pos, "inter_distance_loss": loss_inter,
                   "atom_type_loss": loss_atom, "norm_loss": loss_norm,
                   "dist": loss_norm * cfg.scale}
        return total, metrics

    return loss_fn
