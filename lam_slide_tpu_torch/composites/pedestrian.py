"""Pedestrian ETH/UCY domain composite (counterpart of
``lam_slide_tpu/composites/pedestrian.py``; reference
first_stage/pedestrian.py and second_stage/pedestrian.py).

Stage 1: the 2D positions through a 2-layer merge MLP (keys
``net_merge.{0,2}`` at the backbone's root, first_stage/pedestrian.py:33-42)
into the first-stage backbone, in fp32, and its loss: masked position MSE +
pairwise distance MSE (+ norm), the ``dist`` metric in dataset units
(first_stage/pedestrian.py:118-164). Stage 2: the class-conditional latent
DiT over [B, T=20, L=2, 32] latents (8 past frames condition the 12 future
ones; 5 scene classes), bf16 for training as the registry makes it; its
loss is ``SecondStage.make_loss`` with this config's weights. The test
protocol is the per-entity min over K=20 samples
(``composites.testing.evaluate_min_k``), with the k-means final-position
clustering when ``post_process``. ``scan_layers`` stays a config field for
the run metadata; the port's DiT has one layout.
"""

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch import nn

from lam_slide_tpu_torch.composites.first_stage import FirstStageBackbone
from lam_slide_tpu_torch.models.decoder import Decoder
from lam_slide_tpu_torch.models.encoder import Encoder
from lam_slide_tpu_torch.nn.blocks import gelu_exact, mlp, run_mlp
from lam_slide_tpu_torch.nn.losses import inter_distance, masked_mse, masked_norm


class PedestrianInputEmbedder(nn.Module):
    """pos [B, N, 2] -> merge MLP (first_stage/pedestrian.py:33-42)."""

    def __init__(self, dim_input: int = 128, act: Callable = gelu_exact,
                 dtype: torch.dtype = torch.float32, gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.dtype = dtype
        self.net_merge = mlp((2, dim_input, dim_input), act, gen)

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return run_mlp(self.net_merge, batch["pos"].to(self.dtype), self.dtype)


@dataclass(frozen=True)
class PedestrianFirstStageConfig:
    """Mirrors configs/model/pedestrian/first-stage.yaml."""

    num_entities: int = 10
    dim_input: int = 128
    dim_latent: int = 32
    dim_entity: int = 128
    num_latents: int = 2
    dim_head_cross: int = 16
    dim_head_latent: int = 16
    num_head_cross: int = 4
    num_head_latent: int = 2
    enc_num_block_cross: int = 1
    enc_num_block_attn: int = 1
    dec_num_block_cross: int = 0
    dec_num_block_attn: int = 1
    dropout_query: float = 0.1
    qk_norm: bool = True
    loss_pos_weight: float = 1.0
    loss_inter_distance_weight: float = 1.0
    loss_norm_weight: float = 0.0
    shift: float = 0.0
    scale: float = 1.0


def build_first_stage(cfg, embedder: nn.Module, outputs: Dict[str, int],
                      dtype: torch.dtype, device, gen: torch.Generator) -> FirstStageBackbone:
    """The first-stage backbone of the pedestrian and NBA configs (their
    encoder and decoder settings have the same names), with ``embedder``
    and the decoder heads ``outputs``, drawn from ``gen``, on ``device``."""
    common = dict(qk_norm=cfg.qk_norm, act=gelu_exact, dtype=dtype, gen=gen)
    encoder = Encoder(cfg.dim_input, cfg.dim_entity, cfg.dim_latent, cfg.num_latents,
                      dim_head_cross=cfg.dim_head_cross, dim_head_latent=cfg.dim_head_latent,
                      num_head_cross=cfg.num_head_cross, num_head_latent=cfg.num_head_latent,
                      num_block_cross=cfg.enc_num_block_cross,
                      num_block_attn=cfg.enc_num_block_attn, **common)
    decoder = Decoder(outputs, cfg.dim_latent, cfg.dim_entity, cfg.dim_entity,
                      dim_head_cross=cfg.dim_head_cross, dim_head_latent=cfg.dim_head_latent,
                      num_head_cross=cfg.num_head_cross, num_head_latent=cfg.num_head_latent,
                      num_block_cross=cfg.dec_num_block_cross,
                      num_block_attn=cfg.dec_num_block_attn, dropout_query=cfg.dropout_query,
                      **common)
    model = FirstStageBackbone(cfg.dim_latent, cfg.num_entities, cfg.dim_entity, embedder,
                               encoder, decoder, dtype, gen)
    return model.to(device)


def build_pedestrian_first_stage(cfg: PedestrianFirstStageConfig,
                                 dtype: torch.dtype = torch.float32, device="cuda",
                                 generator: Optional[torch.Generator] = None
                                 ) -> FirstStageBackbone:
    """The pedestrian first stage, drawn from ``generator`` (a CPU
    generator) and moved to ``device``: the card by default; pass
    ``device="cpu"`` to run on the CPU."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    embedder = PedestrianInputEmbedder(cfg.dim_input, dtype=dtype, gen=gen)
    return build_first_stage(cfg, embedder, {"pos": 2}, dtype, device, gen)


def position_losses(preds: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], cfg):
    """The position terms both domains' stage-1 losses share: (their
    weighted sum, the metrics)."""
    mask = batch["attention_mask"]
    pos_pred = preds["pos"].float()
    loss_pos = masked_mse(pos_pred, batch["pos"], mask)
    loss_inter = inter_distance(pos_pred, batch["pos"], mask)
    loss_norm = masked_norm(pos_pred, batch["pos"], mask)
    total = (cfg.loss_pos_weight * loss_pos + cfg.loss_inter_distance_weight * loss_inter
             + cfg.loss_norm_weight * loss_norm)
    return total, {"pos_loss": loss_pos, "inter_distance_loss": loss_inter,
                   "norm_loss": loss_norm, "dist": loss_norm * cfg.scale}


def make_pedestrian_first_stage_loss(cfg: PedestrianFirstStageConfig):
    """loss_fn(model, batch, generator, train) for ``train.make_train_step``
    (JAX ``make_pedestrian_first_stage_loss``; reference Loss.forward,
    first_stage/pedestrian.py:118-164); in train mode the dropouts draw
    from ``generator``."""

    def loss_fn(model, batch, generator, train):
        preds = model(batch, deterministic=not train, generator=generator)
        return position_losses(preds, batch, cfg)

    return loss_fn


@dataclass(frozen=True)
class PedestrianSecondStageConfig:
    """Mirrors configs/model/pedestrian/second-stage.yaml."""
    scan_layers: bool = False

    depth: int = 6
    in_dim: int = 32
    hidden_size: int = 128
    num_heads: int = 4
    mlp_ratio: float = 2.0
    cond_idx: tuple = (0, 8)
    mask_cond_mean: bool = True
    num_timesteps: int = 20  # past 8 + future 12
    K: int = 20
    num_runs: int = 20
    post_process: bool = False
    path_type: str = "GVP"
    prediction: str = "data"
    sampling_method: str = "ODE"
    sampling_kwargs: tuple = (("sampling_method", "euler"), ("num_steps", 10))
    weight_si_loss: float = 1.0
    weight_pos_loss: float = 0.25
    weight_inter_dist_loss: float = 0.25
    calc_additional_losses: bool = True
    class_conditional: bool = False
    n_classes: int = 5
    vec_in_dim: int = 128
    reference_init: bool = True
    share_weights: bool = False


def build_second_stage(cfg, first_stage: FirstStageBackbone, frame_keys, dtype: torch.dtype,
                       device, generator: Optional[torch.Generator]):
    """The SecondStage bundle of the pedestrian and NBA configs: the DiT
    (wrapped in ``ClassCondDiT`` when class-conditional, scenes under
    ``cond_scene``), drawn from ``generator`` and built on ``device``, the
    GVP transport and the frozen first stage."""
    from lam_slide_tpu_torch.composites.second_stage import ClassCondDiT, SecondStage
    from lam_slide_tpu_torch.models import LatentDiT
    from lam_slide_tpu_torch.transport import create_transport

    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    dit = LatentDiT(depth=cfg.depth, in_dim=cfg.in_dim, hidden_size=cfg.hidden_size,
                    num_heads=cfg.num_heads, mlp_ratio=cfg.mlp_ratio,
                    vec_in_dim=cfg.vec_in_dim if cfg.class_conditional else None,
                    reference_init=cfg.reference_init,
                    share_weights=getattr(cfg, "share_weights", False), dtype=dtype,
                    device=device, generator=gen)
    backbone = (ClassCondDiT(dit, cfg.n_classes, cfg.vec_in_dim, generator=gen).to(device)
                if cfg.class_conditional else dit)
    return SecondStage(
        backbone=backbone,
        transport=create_transport(path_type=cfg.path_type, prediction=cfg.prediction),
        first_stage=first_stage,
        cond_idx=cfg.cond_idx,
        mask_cond_mean=cfg.mask_cond_mean,
        num_timesteps=cfg.num_timesteps,
        class_conditional=cfg.class_conditional,
        cond_key="cond_scene",
        frame_keys=frame_keys,
    )


def build_pedestrian_second_stage(cfg: PedestrianSecondStageConfig,
                                  first_stage: FirstStageBackbone,
                                  dtype: torch.dtype = torch.float32, device="cuda",
                                  generator: Optional[torch.Generator] = None):
    return build_second_stage(cfg, first_stage, ("pos", "attention_mask", "entities"), dtype,
                              device, generator)
