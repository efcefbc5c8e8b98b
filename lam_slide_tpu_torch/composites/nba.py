"""NBA SportVU domain composite (counterpart of
``lam_slide_tpu/composites/nba.py``; reference first_stage/nba.py and
second_stage/nba.py).

Stage 1: pos (2) ⊕ team embedding ⊕ group embedding -> merge MLP (keys
``embed_team.weight``, ``embed_group.weight``, ``net_merge.{0,2}``,
first_stage/nba.py:41-59) into the first-stage backbone, whose decoder has
pos, team and group heads; the loss adds masked team/group cross entropy
to the position terms and reports macro accuracy/precision/recall of both
heads (``classification_metrics``). Stage 2 is the pedestrian pattern with
the DiT at hidden 256, 16 heads, L=8 latents, K=60 samples of which the
first ``num_runs``=20 count, and the final-position clustering on.
"""

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch import nn

from lam_slide_tpu_torch.composites.first_stage import FirstStageBackbone
from lam_slide_tpu_torch.composites.pedestrian import (
    build_first_stage,
    build_second_stage,
    position_losses,
)
from lam_slide_tpu_torch.nn.blocks import gelu_exact, mlp, run_mlp
from lam_slide_tpu_torch.nn.embeddings import Embed
from lam_slide_tpu_torch.nn.losses import masked_cross_entropy
from lam_slide_tpu_torch.parallel.rows import mask_denominator


class NBAInputEmbedder(nn.Module):
    """pos ⊕ team-embed ⊕ group-embed -> merge MLP (first_stage/nba.py:54-59);
    the embeddings N(0, 1) tables without a max_norm."""

    def __init__(self, dim_input: int = 128, dim_embed_team: int = 32,
                 dim_embed_group: int = 32, n_teams: int = 3, n_groups: int = 2,
                 act: Callable = gelu_exact, dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.dtype = dtype
        self.embed_team = Embed(n_teams, dim_embed_team, dtype=dtype, gen=gen)
        self.embed_group = Embed(n_groups, dim_embed_group, dtype=dtype, gen=gen)
        self.net_merge = mlp((2 + dim_embed_team + dim_embed_group, dim_input, dim_input), act,
                             gen)

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = torch.cat([batch["pos"].to(self.dtype), self.embed_team(batch["team"]),
                       self.embed_group(batch["group"])], dim=-1)
        return run_mlp(self.net_merge, x, self.dtype)


@dataclass(frozen=True)
class NBAFirstStageConfig:
    """Mirrors configs/model/nba/first-stage.yaml."""

    num_entities: int = 11
    dim_input: int = 128
    dim_latent: int = 32
    dim_entity: int = 128
    num_latents: int = 8
    dim_head_cross: int = 16
    dim_head_latent: int = 16
    num_head_cross: int = 2
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
    loss_team_weight: float = 0.01
    loss_group_weight: float = 0.01
    shift: float = 0.0
    scale: float = 1.0


def build_nba_first_stage(cfg: NBAFirstStageConfig, dtype: torch.dtype = torch.float32,
                          device="cuda",
                          generator: Optional[torch.Generator] = None) -> FirstStageBackbone:
    """The NBA first stage, drawn from ``generator`` and moved to ``device``
    (the card by default; ``device="cpu"`` for the CPU)."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    embedder = NBAInputEmbedder(cfg.dim_input, dtype=dtype, gen=gen)
    return build_first_stage(cfg, embedder, {"pos": 2, "team": 3, "group": 2}, dtype, device,
                             gen)


def classification_metrics(logits: torch.Tensor, targets: torch.Tensor,
                           mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Masked accuracy and macro precision/recall (the reference's team/group
    torchmetrics collections, first_stage/nba.py:90-123)."""
    n_classes = logits.shape[-1]
    pred = logits.argmax(dim=-1)
    targets = targets.long()
    m = mask.float()
    real = m > 0
    acc = ((pred == targets) * m).sum() / mask_denominator(m.sum())
    precs, recs = [], []
    for c in range(n_classes):
        tp = ((pred == c) & (targets == c) & real).sum()
        fp = ((pred == c) & (targets != c) & real).sum()
        fn = ((pred != c) & (targets == c) & real).sum()
        precs.append(tp / (tp + fp).clamp_min(1))
        recs.append(tp / (tp + fn).clamp_min(1))
    # the mean as XLA takes jnp.mean: the sum times 1 / n
    return {"accuracy": acc, "precision": torch.stack(precs).sum() * (1.0 / n_classes),
            "recall": torch.stack(recs).sum() * (1.0 / n_classes)}


def make_nba_first_stage_loss(cfg: NBAFirstStageConfig):
    """loss_fn(model, batch, generator, train) (JAX ``make_nba_first_stage_loss``;
    reference Loss.forward, first_stage/nba.py:220-290). The team/group CE is
    masked, as in JAX: the reference's is unmasked over padded rows, whose
    zero targets are the ball's class."""

    def loss_fn(model, batch, generator, train):
        preds = model(batch, deterministic=not train, generator=generator)
        mask = batch["attention_mask"]
        total, metrics = position_losses(preds, batch, cfg)
        team, group = preds["team"].float(), preds["group"].float()
        loss_team = masked_cross_entropy(team, batch["team"], mask)
        loss_group = masked_cross_entropy(group, batch["group"], mask)
        total = total + cfg.loss_team_weight * loss_team + cfg.loss_group_weight * loss_group
        metrics.update({"team_loss": loss_team, "group_loss": loss_group})
        for name, logits in (("team", team), ("group", group)):
            metrics.update({f"{name}_{k}": v for k, v in classification_metrics(
                logits, batch[name], mask).items()})
        return total, metrics

    return loss_fn


@dataclass(frozen=True)
class NBASecondStageConfig:
    """Mirrors configs/model/nba/second-stage.yaml."""
    scan_layers: bool = False

    depth: int = 6
    in_dim: int = 32
    hidden_size: int = 256
    num_heads: int = 16
    mlp_ratio: float = 2.0
    cond_idx: tuple = (0, 8)
    mask_cond_mean: bool = True
    num_timesteps: int = 20
    K: int = 60
    num_runs: int = 20
    post_process: bool = True
    path_type: str = "GVP"
    prediction: str = "data"
    sampling_method: str = "ODE"
    sampling_kwargs: tuple = (("sampling_method", "euler"), ("num_steps", 10))
    weight_si_loss: float = 1.0
    weight_pos_loss: float = 0.25
    weight_inter_dist_loss: float = 0.25
    calc_additional_losses: bool = True
    class_conditional: bool = False
    n_classes: int = 2
    vec_in_dim: int = 256
    reference_init: bool = True


def build_nba_second_stage(cfg: NBASecondStageConfig, first_stage: FirstStageBackbone,
                           dtype: torch.dtype = torch.float32, device="cuda",
                           generator: Optional[torch.Generator] = None):
    return build_second_stage(cfg, first_stage,
                              ("pos", "team", "group", "attention_mask", "entities"), dtype,
                              device, generator)
