"""Tetrapeptide (4AA) domain composite (counterpart of
``lam_slide_tpu/composites/peptide.py``; reference
first_stage/peptide.py and second_stage/peptide.py).

Stage 1: residue-type embedding ⊕ flattened atom14 (14 × 3) -> merge MLP +
sin-cos residue positions (first_stage/peptide.py:96-103), keys
``embedding_res``, ``net_merge.{0,2}`` and ``embed_res_pos.embeddings`` at the
backbone's root; the decoder is the QuerySplitter with atom14_pos (42) and
aatype (20) heads. The loss runs the differentiable geometry of
``geometry/``: frame-aligned position MSE (atom14 -> backbone frames ->
invert_apply) and the torsion cosine loss through atom14 -> atom37 ->
torsions (first_stage/peptide.py:215-474), plain torch in fp32.

Stage 2: cond_idx (0, 1), one conditioning frame, over ``num_timesteps``
windows, the DiT in bf16 for training (the registry's default), with the
same decoded aux losses over (B T). The reference's
``self_optimization_prob`` is never read there (second_stage/peptide.py:41)
and is omitted. ``scan_layers`` stays a config field for the run metadata;
the port's DiT has one layout.
"""

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch import nn

from lam_slide_tpu_torch.composites.first_stage import FirstStageBackbone
from lam_slide_tpu_torch.geometry import ops as geo
from lam_slide_tpu_torch.geometry.rigid import Rigid
from lam_slide_tpu_torch.models.decoder import DecoderQuerySplitter
from lam_slide_tpu_torch.models.encoder import Encoder
from lam_slide_tpu_torch.nn.blocks import gelu_exact, mlp, run_mlp
from lam_slide_tpu_torch.nn.embeddings import Embed, SinCosPositionalEmbedding1D
from lam_slide_tpu_torch.nn.losses import (
    inter_distance,
    masked_cross_entropy,
    masked_mse,
    masked_norm,
    safe_norm,
)
from lam_slide_tpu_torch.parallel.rows import mask_denominator


class PeptideInputEmbedder(nn.Module):
    """res-embed ⊕ atom14 flat -> merge MLP + sincos residue positions."""

    def __init__(self, dim_input: int = 256, dim_embed_res: int = 64, n_restypes: int = 20,
                 max_res: int = 10, act: Callable = gelu_exact,
                 dtype: torch.dtype = torch.float32, gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.dtype = dtype
        self.embedding_res = Embed(n_restypes, dim_embed_res, max_norm=1.0, dtype=dtype, gen=gen)
        self.net_merge = mlp((dim_embed_res + 42, dim_input, dim_input), act, gen)
        self.embed_res_pos = SinCosPositionalEmbedding1D(max_res, dim_input)

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        res_emb = self.embedding_res(batch["aatype"])
        pos = batch["atom14_pos"].to(self.dtype)
        x = torch.cat([res_emb, pos.reshape(*pos.shape[:-2], 42)], dim=-1)
        return self.embed_res_pos(run_mlp(self.net_merge, x, self.dtype))


@dataclass(frozen=True)
class PeptideFirstStageConfig:
    """Mirrors configs/model/peptide/first-stage.yaml."""

    num_entities: int = 8
    dim_input: int = 256
    dim_latent: int = 96
    dim_entity: int = 128
    max_res: int = 10
    num_latents: int = 2
    num_split: int = 8
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
    loss_pos_frame_weight: float = 0.0
    loss_inter_distance_weight: float = 1.0
    loss_res_type_weight: float = 0.01
    loss_torsion_weight: float = 0.0
    loss_norm_weight: float = 0.0
    shift: float = 0.0
    scale: float = 1.0


def build_peptide_first_stage(cfg: PeptideFirstStageConfig, dtype: torch.dtype = torch.float32,
                              device="cuda",
                              generator: Optional[torch.Generator] = None) -> FirstStageBackbone:
    """The peptide first stage, drawn from ``generator`` (a CPU generator)
    and moved to ``device``: the card by default, so a missing card raises;
    pass ``device="cpu"`` to run on the CPU."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    common = dict(qk_norm=cfg.qk_norm, act=gelu_exact, dtype=dtype, gen=gen)
    embedder = PeptideInputEmbedder(cfg.dim_input, max_res=cfg.max_res, dtype=dtype, gen=gen)
    encoder = Encoder(cfg.dim_input, cfg.dim_entity, cfg.dim_latent, cfg.num_latents,
                      dim_head_cross=cfg.dim_head_cross, dim_head_latent=cfg.dim_head_latent,
                      num_head_cross=cfg.num_head_cross, num_head_latent=cfg.num_head_latent,
                      num_block_cross=cfg.enc_num_block_cross,
                      num_block_attn=cfg.enc_num_block_attn, **common)
    decoder = DecoderQuerySplitter(
        {"atom14_pos": 42, "aatype": 20}, cfg.dim_latent, cfg.dim_entity, cfg.dim_entity,
        num_split=cfg.num_split, dim_head_cross=cfg.dim_head_cross,
        dim_head_latent=cfg.dim_head_latent, num_head_cross=cfg.num_head_cross,
        num_head_latent=cfg.num_head_latent, num_block_cross=cfg.dec_num_block_cross,
        num_block_attn=cfg.dec_num_block_attn, dropout_query=cfg.dropout_query, **common)
    model = FirstStageBackbone(cfg.dim_latent, cfg.num_entities, cfg.dim_entity, embedder,
                               encoder, decoder, dtype, gen)
    return model.to(device)


def frame_aligned_positions(atom14_pos: torch.Tensor) -> torch.Tensor:
    """atom14 -> per-residue backbone frame -> frame-local coordinates
    (first_stage/peptide.py:422-424)."""
    frames = geo.atom14_to_frames(atom14_pos)
    frames = Rigid(frames.rots[..., None, :, :], frames.trans[..., None, :])
    return frames.invert_apply(atom14_pos)


def peptide_torsions(atom14_pos: torch.Tensor, aatype: torch.Tensor) -> torch.Tensor:
    """Differentiable atom14 -> atom37 -> torsion sin/cos (peptide.py:404-408)."""
    sin_cos, _ = geo.atom37_to_torsions(geo.atom14_to_atom37(atom14_pos, aatype), aatype)
    return sin_cos


def masked_cosine_flat(pred: torch.Tensor, target: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """1 - cosine similarity, masked (reference MaskedCosineLoss). safe_norm
    keeps the gradient of undefined torsions (exactly-zero sin/cos vectors)
    finite: a NaN there would reach the weights even through a zero loss
    weight."""
    pn = pred / torch.clamp(safe_norm(pred, dim=-1, keepdim=True), min=1e-8)
    tn = target / torch.clamp(safe_norm(target, dim=-1, keepdim=True), min=1e-8)
    per = 1.0 - (pn * tn).sum(dim=-1)
    m = mask.to(per.dtype)
    return (per * m).sum() / mask_denominator(m.sum())


def peptide_reconstruction_losses(preds: Dict[str, torch.Tensor],
                                  batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The stage-1/stage-2 aux loss bundle (first_stage/peptide.py:404-474);
    ``preds["atom14_pos"]`` is the flat (…, R, 42) head output."""
    r = batch["aatype"].shape[-1]
    pos_pred = preds["atom14_pos"].float().reshape(*batch["aatype"].shape, 14, 3)
    pos_true = batch["atom14_pos"]
    a14_mask = batch["atom14_mask"].float()

    loss_pos = masked_mse(pos_pred.reshape(-1, 3), pos_true.reshape(-1, 3), a14_mask.reshape(-1))
    loss_norm = masked_norm(pos_pred.reshape(-1, 3), pos_true.reshape(-1, 3),
                            a14_mask.reshape(-1))
    loss_pos_frame = masked_mse(frame_aligned_positions(pos_pred).reshape(-1, 3),
                                batch["atom14_pos_frame"].reshape(-1, 3), a14_mask.reshape(-1))
    loss_inter = inter_distance(pos_pred.reshape(-1, r * 14, 3), pos_true.reshape(-1, r * 14, 3),
                                a14_mask.reshape(-1, r * 14))
    loss_torsion = masked_cosine_flat(peptide_torsions(pos_pred, batch["aatype"]).reshape(-1, 2),
                                      batch["torsions"].reshape(-1, 2),
                                      batch["torsions_mask"].reshape(-1))
    return {"pos_loss": loss_pos, "pos_frame_loss": loss_pos_frame,
            "inter_distance_loss": loss_inter, "norm_loss": loss_norm,
            "torsion_loss": loss_torsion}


def make_peptide_first_stage_loss(cfg: PeptideFirstStageConfig):
    """loss_fn(model, batch, generator, train) for ``train.make_train_step``
    (JAX ``make_peptide_first_stage_loss``): the reconstruction bundle plus
    the residue-type CE, weighted by the config; in train mode the dropouts
    draw from ``generator``."""

    def loss_fn(model, batch, generator, train):
        preds = model(batch, deterministic=not train, generator=generator)
        parts = peptide_reconstruction_losses(preds, batch)
        res_mask = torch.ones(batch["aatype"].shape, device=batch["aatype"].device)
        loss_res = masked_cross_entropy(preds["aatype"].float(), batch["aatype"], res_mask)
        total = (cfg.loss_pos_weight * parts["pos_loss"]
                 + cfg.loss_pos_frame_weight * parts["pos_frame_loss"]
                 + cfg.loss_inter_distance_weight * parts["inter_distance_loss"]
                 + cfg.loss_res_type_weight * loss_res
                 + cfg.loss_norm_weight * parts["norm_loss"]
                 + cfg.loss_torsion_weight * parts["torsion_loss"])
        pred_res = preds["aatype"].argmax(dim=-1)
        metrics = dict(parts)
        metrics["res_type_loss"] = loss_res
        metrics["res_accuracy"] = (pred_res == batch["aatype"]).float().mean()
        metrics["dist"] = parts["norm_loss"] * cfg.scale
        return total, metrics

    return loss_fn


@dataclass(frozen=True)
class PeptideSecondStageConfig:
    """Mirrors configs/model/peptide/second-stage.yaml."""

    scan_layers: bool = False

    depth: int = 7
    in_dim: int = 96
    hidden_size: int = 384
    num_heads: int = 16
    mlp_ratio: float = 2.0
    cond_idx: tuple = (0, 1)
    mask_cond_mean: bool = True
    num_timesteps: int = 100
    path_type: str = "GVP"
    prediction: str = "data"
    sampling_method: str = "ODE"
    sampling_kwargs: tuple = (("sampling_method", "euler"), ("num_steps", 10))
    loss_si_weight: float = 1.0
    loss_pos_weight: float = 0.25
    loss_pos_frame_weight: float = 0.25
    loss_inter_distance_weight: float = 0.25
    loss_torsion_weight: float = 0.0
    loss_norm_weight: float = 0.0
    calc_additional_losses: bool = True
    checkpointing: bool = False
    reference_init: bool = True


def build_peptide_second_stage(cfg: PeptideSecondStageConfig, first_stage: FirstStageBackbone,
                               dtype: torch.dtype = torch.float32, device="cuda",
                               generator: Optional[torch.Generator] = None):
    """The SecondStage bundle: the DiT drawn from ``generator`` and built on
    ``device`` (the card by default), the GVP transport and the frozen first
    stage, which construction freezes in place."""
    from lam_slide_tpu_torch.composites.second_stage import SecondStage
    from lam_slide_tpu_torch.models import LatentDiT
    from lam_slide_tpu_torch.transport import create_transport

    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    dit = LatentDiT(depth=cfg.depth, in_dim=cfg.in_dim, hidden_size=cfg.hidden_size,
                    num_heads=cfg.num_heads, mlp_ratio=cfg.mlp_ratio,
                    checkpointing=cfg.checkpointing,
                    reference_init=cfg.reference_init, dtype=dtype, device=device,
                    generator=gen)
    return SecondStage(
        backbone=dit,
        transport=create_transport(path_type=cfg.path_type, prediction=cfg.prediction),
        first_stage=first_stage,
        cond_idx=cfg.cond_idx,
        mask_cond_mean=cfg.mask_cond_mean,
        num_timesteps=cfg.num_timesteps,
        frame_keys=("atom14_pos", "aatype", "attention_mask", "entities"),
    )


_AUX_KEYS = ("atom14_pos", "atom14_mask", "atom14_pos_frame", "aatype", "torsions",
             "torsions_mask")


def make_peptide_second_stage_loss(ss, cfg: PeptideSecondStageConfig):
    """loss_fn(model, batch, generator, train): the SI loss of ``model`` (the
    backbone, or a call of it on other weights) on the encoded batch, t and
    x0 drawn from ``generator``, plus the geometry aux losses of the
    data-prediction latents decoded through the frozen first stage over
    (B T) (second_stage/peptide.py:293-378)."""

    def loss_fn(model, batch, generator, train):
        x1, model_kwargs = ss.prepare_batch(batch)
        terms = ss.transport.training_losses(model, x1, model_kwargs, generator=generator)
        si_loss = terms["loss"].mean()
        total = cfg.loss_si_weight * si_loss
        metrics = {"si_loss": si_loss}
        if cfg.calc_additional_losses:
            pred_latent = terms["pred"]
            preds = ss.decode(pred_latent.flatten(0, 1), batch["entities"].flatten(0, 1))
            flat_batch = {k: batch[k].flatten(0, 1) for k in _AUX_KEYS}
            parts = peptide_reconstruction_losses(preds, flat_batch)
            total = (total + cfg.loss_pos_weight * parts["pos_loss"]
                     + cfg.loss_pos_frame_weight * parts["pos_frame_loss"]
                     + cfg.loss_inter_distance_weight * parts["inter_distance_loss"]
                     + cfg.loss_torsion_weight * parts["torsion_loss"]
                     + cfg.loss_norm_weight * parts["norm_loss"])
            metrics.update(parts)
        return total, metrics

    return loss_fn
