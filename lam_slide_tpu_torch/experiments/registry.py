"""Experiment registry: the MD17 training runs (counterpart of
``lam_slide_tpu/experiments/registry.py:105-300``; reference
configs/experiment/md17/{first,second}-stage.yaml).

Each builder assembles one run with the JAX registry's configs, batch
sizes, ``TrainerConfig`` values, loaders and loss wiring: the model, the
``loss_fn`` for ``train.make_train_step``, the optimizer from
``make_optimizer`` and the loaders, and for stage 2 the sampled validation
hook. ``smoke=True`` shrinks everything as the JAX smoke runs do (tiny
widths, few windows) for CPU runs. Models are drawn from ``seed`` and built
on the card unless ``device="cpu"``.

Stage 2 takes the stage-1 model object itself (it is frozen there); reading
it from the run registry by id waits for the port's checkpoints, as do the
``Trainer`` loop and the fp32 rebuild of the DiT for the ``--test`` pass.
With no raw MD17 files under ``data_root`` the datasets are the JAX
package's synthetic trajectories (``data/md17.py``).
"""

import functools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from lam_slide_tpu_torch.composites.md17 import (
    MD17FirstStageConfig,
    MD17SecondStageConfig,
    build_md17_first_stage,
    build_md17_second_stage,
    make_md17_first_stage_loss,
)
from lam_slide_tpu_torch.composites.testing import make_protocol_val_hook
from lam_slide_tpu_torch.data.collate import pad_collate, pad_collate_temporal
from lam_slide_tpu_torch.data.loader import Loader
from lam_slide_tpu_torch.data.md17 import MD17Dataset
from lam_slide_tpu_torch.train.trainer import TrainerConfig, make_optimizer

MD17_SCALES = {
    "aspirin": 1.721, "benzene": 1.169, "ethanol": 0.893, "malonaldehyde": 0.989,
    "naphthalene": 1.515, "salicylic": 1.429, "toluene": 1.339, "uracil": 1.173,
    "all": 1.376,
}


@dataclass
class ExperimentRun:
    """One training run. ``model`` is the module whose parameters train
    (stage 1: the first stage; stage 2: the DiT backbone); ``second_stage``
    is the stage-2 bundle (frozen stage 1, backbone, transport)."""

    name: str
    config: Any
    trainer_cfg: TrainerConfig
    model: nn.Module
    loss_fn: Callable
    tx: Any
    train_loader: Loader
    val_loaders: Dict[str, Loader]
    second_stage: Any = None
    eval_fns: Dict[str, Callable] = field(default_factory=dict)


def _md17_datasets(smoke, data_root, first_stage, molecules, num_entities, span, scales,
                   synthetic_frames=None):
    # the synthetic fallback's default size is the JAX registry's; a larger
    # synthetic_frames fills the reference's 5000 train / 1000 val windows
    kw = dict(root=data_root, span=span, first_stage=first_stage, num_entities=num_entities,
              synthetic_frames=synthetic_frames or (3000 if smoke else 4000))
    train_sets = [MD17Dataset(molecule=m, mode="train", scale=scales[m], rand_rotation=True,
                              force_length=48 if smoke else None, **kw)
                  for m in molecules]
    val_sets = {m: MD17Dataset(molecule=m, mode="val", scale=scales[m], rand_rotation=False,
                               force_length=16 if smoke else 256, **kw)
                for m in molecules}
    return train_sets, val_sets


class _ConcatDataset:
    def __init__(self, datasets):
        self.datasets = datasets
        self.offsets = np.cumsum([0] + [len(d) for d in datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def sample(self, idx, rng):
        d = int(np.searchsorted(self.offsets, idx, side="right")) - 1
        return self.datasets[d].sample(idx - int(self.offsets[d]), rng)


def _molecules(molecule: str, smoke: bool):
    molecules = list(MD17_SCALES)[:-1] if molecule == "all" else [molecule]
    return molecules[:2] if smoke else molecules


def _loaders(smoke, data_root, first_stage, molecules, num_entities, bs, collate, seed,
             synthetic_frames):
    train_sets, val_sets = _md17_datasets(smoke, data_root, first_stage, molecules,
                                          num_entities, 30, MD17_SCALES, synthetic_frames)
    collate = functools.partial(collate, num_entities=num_entities)
    train_loader = Loader(_ConcatDataset(train_sets), bs, collate, seed=seed)
    val_loaders = {m: Loader(ds, bs, collate, shuffle=False, seed=seed, drop_last=False)
                   for m, ds in val_sets.items()}
    return train_loader, val_loaders


def md17_first_stage(smoke: bool = False, data_root: Optional[str] = None, seed: int = 0,
                     molecule: str = "all", synthetic_frames: Optional[int] = None,
                     device="cuda") -> ExperimentRun:
    """MD17 stage 1 (registry.py:155-193): fp32, B=256 single frames, AdamW
    lr 4e-4 over 3000 epochs, the stage-1 loss."""
    scale = MD17_SCALES[molecule]
    cfg = MD17FirstStageConfig(num_entities=32, scale=scale) if not smoke else (
        MD17FirstStageConfig(num_entities=32, dim_input=32, dim_latent=8, dim_entity=32,
                             num_latents=8, dim_head_cross=8, dim_head_latent=8,
                             num_head_cross=2, scale=scale))
    model = build_md17_first_stage(cfg, device=device,
                                   generator=torch.Generator().manual_seed(seed))
    train_loader, val_loaders = _loaders(smoke, data_root, True, _molecules(molecule, smoke),
                                         cfg.num_entities, 16 if smoke else 256, pad_collate,
                                         seed, synthetic_frames)
    trainer_cfg = TrainerConfig(max_epochs=2 if smoke else 3000, lr=4e-4)
    tx, _ = make_optimizer(trainer_cfg, len(train_loader))
    return ExperimentRun(name="md17_first_stage", config=cfg, trainer_cfg=trainer_cfg,
                         model=model, loss_fn=make_md17_first_stage_loss(cfg), tx=tx,
                         train_loader=train_loader, val_loaders=val_loaders)


def md17_second_stage(first_stage: nn.Module, first_stage_cfg: MD17FirstStageConfig,
                      smoke: bool = False, data_root: Optional[str] = None, seed: int = 0,
                      molecule: str = "all", synthetic_frames: Optional[int] = None,
                      device="cuda") -> ExperimentRun:
    """MD17 stage 2 (registry.py:196-300) on a trained stage 1: the bf16
    class-conditional DiT with per-layer checkpointing (fp32 in smoke runs),
    B=64 trajectories, AdamW lr 1e-3 over 1000 epochs, EMA 0.999, the SI
    loss plus the aux pos/inter-distance losses through the frozen stage 1,
    and the sampled val hook (K=5, one batch per molecule) under
    ``eval_fns["val_sample"]``."""
    molecules = _molecules(molecule, smoke)
    train_loader, val_loaders = _loaders(smoke, data_root, False, molecules,
                                         first_stage_cfg.num_entities, 4 if smoke else 64,
                                         pad_collate_temporal, seed, synthetic_frames)
    cfg = (MD17SecondStageConfig(in_dim=first_stage_cfg.dim_latent, class_conditional=True)
           if not smoke else
           MD17SecondStageConfig(in_dim=first_stage_cfg.dim_latent, depth=2, hidden_size=32,
                                 num_heads=4, class_conditional=True, vec_in_dim=32))
    dtype = torch.float32 if smoke else torch.bfloat16
    ss = build_md17_second_stage(cfg, first_stage, dtype=dtype, device=device,
                                 generator=torch.Generator().manual_seed(seed + 1))
    scale = MD17_SCALES[molecule]
    loss_fn = ss.make_loss(weight_si_loss=cfg.weight_si_loss, weight_pos_loss=cfg.weight_pos_loss,
                           weight_inter_dist_loss=cfg.weight_inter_dist_loss,
                           calc_additional_losses=cfg.calc_additional_losses, scale=scale)
    trainer_cfg = TrainerConfig(max_epochs=2 if smoke else 1000, lr=1e-3)
    tx, _ = make_optimizer(trainer_cfg, len(train_loader))
    hook = make_protocol_val_hook(ss, val_loaders, scale=scale, k=2 if smoke else 5,
                                  limit_batches=1)
    return ExperimentRun(name="md17_second_stage", config=cfg, trainer_cfg=trainer_cfg,
                         model=ss.backbone, loss_fn=loss_fn, tx=tx, train_loader=train_loader, val_loaders=val_loaders, second_stage=ss,
                         eval_fns={"val_sample": hook})
