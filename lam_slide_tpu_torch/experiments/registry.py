"""Experiment registry: the MD17, pedestrian, NBA and 4AA peptide training
runs (counterpart of ``lam_slide_tpu/experiments/registry.py``; reference
configs/experiment/{md17,pedestrian,nba,peptide}/{first,second}-stage.yaml).

Each builder assembles one run with the JAX registry's configs, batch
sizes, ``TrainerConfig`` values (monitors, val cadence), loaders and loss
wiring: the model, the ``loss_fn`` for ``train.make_train_step``, the
optimizer from ``make_optimizer`` and the loaders; stage 2 also the sampled
validation hook, the held-out test loaders and ``test_model``, the fp32
rebuild of its bundle for the ``--test`` pass. ``meta`` holds the config,
stage, domain and stage lineage for the run registry. ``smoke=True``
shrinks everything as the JAX smoke runs do (tiny widths, few windows) for
CPU runs. Models are drawn from ``seed`` and built on the card unless
``device="cpu"``.

Cross-stage lineage: ``md17_second_stage(first_stage_run=<id>)`` resolves
the frozen stage 1 through the run registry (run_id -> run_dir ->
checkpoint; the wandb run-ID lookup of src/utils/utils.py:180-199) and
loads its EMA weights, matching ``load_ema_weights`` + ``freeze()``
(second_stage/md17.py:46-51); the other stage-2 builders do the same.
``first_stage=<stage-1 ExperimentRun>`` takes a stage 1 trained in the same
process instead (no JAX counterpart). With no raw files under
``data_root`` the datasets are the synthetic trajectories of
``data/{md17,pedestrian,nba,peptide}.py``; the port-only knobs
``synthetic_frames`` (MD17), ``synthetic_scenes`` (pedestrian) and
``synthetic_games`` (NBA) size them, and ``test_batches`` keeps the first
batches of each test loader of the pedestrian and NBA stage 2.
"""

import dataclasses
import functools
import itertools
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from lam_slide_tpu_torch.composites.nba import (
    NBAFirstStageConfig,
    NBASecondStageConfig,
    build_nba_first_stage,
    build_nba_second_stage,
    make_nba_first_stage_loss,
)
from lam_slide_tpu_torch.composites.pedestrian import (
    PedestrianFirstStageConfig,
    PedestrianSecondStageConfig,
    build_pedestrian_first_stage,
    build_pedestrian_second_stage,
    make_pedestrian_first_stage_loss,
)
from lam_slide_tpu_torch.composites.md17 import (
    MD17FirstStageConfig,
    MD17SecondStageConfig,
    build_md17_first_stage,
    build_md17_second_stage,
    make_md17_first_stage_loss,
)
from lam_slide_tpu_torch.composites.peptide import (
    PeptideFirstStageConfig,
    PeptideSecondStageConfig,
    build_peptide_first_stage,
    build_peptide_second_stage,
    make_peptide_first_stage_loss,
    make_peptide_second_stage_loss,
)
from lam_slide_tpu_torch.composites.testing import make_protocol_val_hook
from lam_slide_tpu_torch.data.collate import pad_collate, pad_collate_temporal
from lam_slide_tpu_torch.data.loader import Loader
from lam_slide_tpu_torch.data.md17 import MD17Dataset
from lam_slide_tpu_torch.data.nba import NBADataset
from lam_slide_tpu_torch.data.pedestrian import PedestrianDataset
from lam_slide_tpu_torch.data.peptide import PeptideDataset
from lam_slide_tpu_torch.train.checkpoint import resolve_run
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
    is the stage-2 bundle (frozen stage 1, backbone, transport) and
    ``test_model`` its fp32 rebuild on the same frozen stage 1 for the
    ``--test`` pass (reference src/train.py:100-118, precision="32-true");
    ``test_loaders`` the held-out test split."""

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
    test_loaders: Optional[Dict[str, Loader]] = None
    test_model: Any = None
    meta: Dict[str, Any] = field(default_factory=dict)

    @property
    def constants(self) -> Optional[Dict[str, Any]]:
        """What the checkpoints carry beside the trained parameters: stage
        2's frozen first stage, as ``{"first_stage": state_dict}``."""
        if self.second_stage is None:
            return None
        return {"first_stage": self.second_stage.first_stage.state_dict()}


def load_checkpoint_raw(run_dir: str, which: str = "best") -> dict:
    """Read a checkpoint file without a train state -> its dict, tensors on
    the CPU.

    Falls back ``best`` -> ``last`` (a run that never improved its monitored
    metric has no ``best``) with a visible warning: silently testing a
    different checkpoint than requested would misattribute the metrics.
    """
    ckpt_dir = os.path.join(os.path.abspath(run_dir), "checkpoints")
    path = os.path.join(ckpt_dir, f"{which}.pt")
    if not os.path.exists(path):
        fallback = os.path.join(ckpt_dir, "last.pt")
        if which != "last" and os.path.exists(fallback):
            print(f"WARNING: no '{which}' checkpoint in {run_dir}; falling back to 'last'",
                  flush=True)
            path = fallback
        else:
            raise FileNotFoundError(f"no '{which}' checkpoint under {ckpt_dir}")
    return torch.load(path, map_location="cpu", weights_only=True)


def load_first_stage_variables(workspace: str, run_id: str, which: str = "best"):
    """run_id -> (the frozen stage 1's state dict, its EMA parameters where
    the run kept an EMA; the run's registry config)."""
    info = resolve_run(workspace, run_id)
    raw = load_checkpoint_raw(info["run_dir"], which)
    state_dict = {**raw["params"], **(raw.get("ema_params") or {})}
    return state_dict, info.get("config", {})


def _md17_datasets(smoke, data_root, first_stage, molecules, num_entities, span, scales,
                   with_test=False, synthetic_frames=None):
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
    if not with_test:
        return train_sets, val_sets
    # the held-out chronological test split, 1000 eval samples a molecule
    # (geo_tdm/md17.py:120-154): the --test protocol's data
    test_sets = {m: MD17Dataset(molecule=m, mode="test", scale=scales[m], rand_rotation=False,
                                force_length=16 if smoke else None, **kw)
                 for m in molecules}
    return train_sets, val_sets, test_sets


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


def _smoke_first_stage_config(scale: float) -> MD17FirstStageConfig:
    return MD17FirstStageConfig(num_entities=32, dim_input=32, dim_latent=8, dim_entity=32,
                                num_latents=8, dim_head_cross=8, dim_head_latent=8,
                                num_head_cross=2, scale=scale)


def _eval_loader(ds, bs, collate, seed):
    return Loader(ds, bs, collate, shuffle=False, seed=seed, drop_last=False)


def md17_first_stage(smoke: bool = False, data_root: Optional[str] = None,
                     workspace: str = "runs", seed: int = 0, molecule: str = "all",
                     synthetic_frames: Optional[int] = None, device="cuda",
                     **_) -> ExperimentRun:
    """MD17 stage 1 (registry.py:155-193): fp32, B=256 single frames, AdamW
    lr 4e-4 over 3000 epochs, the stage-1 loss, ``pos_loss`` monitored on
    val every 25 epochs."""
    scale = MD17_SCALES[molecule]
    cfg = (MD17FirstStageConfig(num_entities=32, scale=scale) if not smoke
           else _smoke_first_stage_config(scale))
    model = build_md17_first_stage(cfg, device=device,
                                   generator=torch.Generator().manual_seed(seed))
    train_sets, val_sets = _md17_datasets(smoke, data_root, True, _molecules(molecule, smoke),
                                          cfg.num_entities, 30, MD17_SCALES,
                                          synthetic_frames=synthetic_frames)
    bs = 16 if smoke else 256
    collate = functools.partial(pad_collate, num_entities=cfg.num_entities)
    train_loader = Loader(_ConcatDataset(train_sets), bs, collate, seed=seed)
    val_loaders = {m: _eval_loader(ds, bs, collate, seed) for m, ds in val_sets.items()}
    trainer_cfg = TrainerConfig(max_epochs=2 if smoke else 3000, lr=4e-4, monitor="pos_loss",
                                val_every_n_epochs=1 if smoke else 25, seed=seed)
    tx, _ = make_optimizer(trainer_cfg, len(train_loader))
    return ExperimentRun(name="md17_first_stage", config=cfg, trainer_cfg=trainer_cfg,
                         model=model, loss_fn=make_md17_first_stage_loss(cfg), tx=tx,
                         train_loader=train_loader, val_loaders=val_loaders,
                         meta={"config": dataclasses.asdict(cfg), "stage": 1, "domain": "md17"})


def _dtype(dit_dtype) -> Optional[torch.dtype]:
    """A dtype from its name ("bfloat16", "float32") or as given."""
    return getattr(torch, dit_dtype) if isinstance(dit_dtype, str) else dit_dtype


def md17_second_stage(smoke: bool = False, data_root: Optional[str] = None,
                      workspace: str = "runs", seed: int = 0, molecule: str = "all",
                      first_stage_run: Optional[str] = None, dit_dtype=None,
                      synthetic_frames: Optional[int] = None, batch_size: Optional[int] = None,
                      num_heads: Optional[int] = None,
                      first_stage: Optional[ExperimentRun] = None, device="cuda",
                      **_) -> ExperimentRun:
    """MD17 stage 2 (registry.py:196-300) on a frozen stage 1: from the run
    registry (``first_stage_run``), from a stage-1 run of this process
    (``first_stage``) or, in smoke runs, freshly drawn. The bf16
    class-conditional DiT with per-layer checkpointing (fp32 in smoke runs;
    ``dit_dtype`` overrides), B=64 trajectories (``batch_size``), 16 heads
    (``num_heads``), AdamW lr 1e-3 over 1000 epochs, EMA 0.999, the SI loss
    plus the aux pos/inter-distance losses through the frozen stage 1,
    ``si_loss`` monitored on val every 10 epochs over 5 batches, the sampled
    val hook (K=5, one batch a molecule) under ``eval_fns["val_sample"]``,
    the test split's loaders and the fp32 ``test_model``."""
    molecules = _molecules(molecule, smoke)
    scale = MD17_SCALES[molecule]
    if first_stage_run is not None:
        fs_state, fs_cfg_dict = load_first_stage_variables(workspace, first_stage_run)
        fs_cfg = MD17FirstStageConfig(**{
            k: v for k, v in fs_cfg_dict.get("config", fs_cfg_dict).items()
            if k in MD17FirstStageConfig.__dataclass_fields__})
        fs_model = build_md17_first_stage(fs_cfg, device=device)
        fs_model.load_state_dict(fs_state)
    elif first_stage is not None:
        fs_model, fs_cfg = first_stage.model, first_stage.config
    elif smoke:
        fs_cfg = _smoke_first_stage_config(scale)
        fs_model = build_md17_first_stage(fs_cfg, device=device,
                                          generator=torch.Generator().manual_seed(seed))
    else:
        raise ValueError("md17_second_stage requires first_stage_run (see run registry)")

    train_sets, val_sets, test_sets = _md17_datasets(
        smoke, data_root, False, molecules, fs_cfg.num_entities, 30, MD17_SCALES,
        with_test=True, synthetic_frames=synthetic_frames)
    bs = batch_size or (4 if smoke else 64)
    collate = functools.partial(pad_collate_temporal, num_entities=fs_cfg.num_entities)
    train_loader = Loader(_ConcatDataset(train_sets), bs, collate, seed=seed)
    val_loaders = {m: _eval_loader(ds, bs, collate, seed) for m, ds in val_sets.items()}
    test_loaders = {m: _eval_loader(ds, bs, collate, seed) for m, ds in test_sets.items()}
    # num_heads: the head-split override (same hidden width, another dh)
    heads = {"num_heads": num_heads} if num_heads else {}
    cfg = (MD17SecondStageConfig(in_dim=fs_cfg.dim_latent, class_conditional=True, **heads)
           if not smoke else
           MD17SecondStageConfig(in_dim=fs_cfg.dim_latent, depth=2, hidden_size=32,
                                 num_heads=num_heads or 4, class_conditional=True,
                                 vec_in_dim=32))
    # bf16-mixed stage 2 by default; dit_dtype overrides (sweeps, tests)
    dtype = _dtype(dit_dtype) or (torch.float32 if smoke else torch.bfloat16)
    ss = build_md17_second_stage(cfg, fs_model, dtype=dtype, device=device,
                                 generator=torch.Generator().manual_seed(seed + 1))
    # the fp32 rebuild for the --test pass (src/train.py:106-118
    # precision="32-true"); the test protocol loads the trained weights
    ss_test = build_md17_second_stage(cfg, fs_model, dtype=torch.float32, device=device,
                                      generator=torch.Generator().manual_seed(seed + 1))
    loss_fn = ss.make_loss(weight_si_loss=cfg.weight_si_loss, weight_pos_loss=cfg.weight_pos_loss,
                           weight_inter_dist_loss=cfg.weight_inter_dist_loss,
                           calc_additional_losses=cfg.calc_additional_losses, scale=scale)
    trainer_cfg = TrainerConfig(max_epochs=2 if smoke else 1000, lr=1e-3, monitor="si_loss",
                                val_every_n_epochs=1 if smoke else 10, seed=seed,
                                limit_val_batches=0 if smoke else 5)
    tx, _ = make_optimizer(trainer_cfg, len(train_loader))
    # sampled val ADE/FDE each val epoch (reference second_stage/md17.py:75-113)
    hook = make_protocol_val_hook(ss, val_loaders, scale=scale, k=2 if smoke else 5,
                                  limit_batches=1)
    return ExperimentRun(name="md17_second_stage", config=cfg, trainer_cfg=trainer_cfg,
                         model=ss.backbone, loss_fn=loss_fn, tx=tx, train_loader=train_loader,
                         val_loaders=val_loaders, second_stage=ss,
                         eval_fns={"val_sample": hook}, test_loaders=test_loaders,
                         test_model=ss_test,
                         meta={"config": dataclasses.asdict(cfg), "stage": 2, "domain": "md17",
                               "first_stage_run": first_stage_run})


def _stage1_of_run(workspace, run_id, cfg_cls, build, device):
    """The frozen stage 1 of a registered run: (model with its EMA weights,
    config)."""
    fs_state, fs_cfg_dict = load_first_stage_variables(workspace, run_id)
    fs_cfg = cfg_cls(**{k: v for k, v in fs_cfg_dict.get("config", fs_cfg_dict).items()
                        if k in cfg_cls.__dataclass_fields__})
    fs_model = build(fs_cfg, device=device)
    fs_model.load_state_dict(fs_state)
    return fs_model, fs_cfg


class _FirstBatches:
    """The first ``n`` batches of a loader (its other attributes pass through)."""

    def __init__(self, loader, n: int):
        self.loader, self.n = loader, n

    def __len__(self) -> int:
        return min(len(self.loader), self.n)

    def __iter__(self):
        return itertools.islice(iter(self.loader), self.n)

    def __getattr__(self, name):
        return getattr(self.loader, name)


def _test_loaders(loaders, test_batches: Optional[int]):
    if not test_batches:
        return loaders
    return {name: _FirstBatches(loader, test_batches) for name, loader in loaders.items()}


# ---------------------------------------------------------------------------
# Pedestrian
# ---------------------------------------------------------------------------

PED_SCENES = ["zara1", "zara2", "univ", "hotel", "eth"]


def _smoke_pedestrian_first_stage_config() -> PedestrianFirstStageConfig:
    return PedestrianFirstStageConfig(dim_input=32, dim_latent=8, dim_entity=32,
                                      dim_head_cross=8, dim_head_latent=8, num_head_cross=2)


def pedestrian_first_stage(smoke: bool = False, data_root: Optional[str] = None,
                           workspace: str = "runs", seed: int = 0,
                           synthetic_scenes: Optional[int] = None, device="cuda",
                           **_) -> ExperimentRun:
    """Pedestrian stage 1 (registry.py:306-341): fp32, B=512 single frames
    of the five ETH/UCY scenes, AdamW lr 1e-3 over 2000 epochs,
    ``pos_loss`` monitored every 25 epochs on the test split (the
    reference's val, pedestrian.py:198-204)."""
    scenes = PED_SCENES[:2] if smoke else PED_SCENES
    cfg = PedestrianFirstStageConfig() if not smoke else _smoke_pedestrian_first_stage_config()
    model = build_pedestrian_first_stage(cfg, device=device,
                                         generator=torch.Generator().manual_seed(seed))
    kw = dict(root=data_root, num_entities=cfg.num_entities,
              synthetic_scenes=synthetic_scenes or (24 if smoke else 64))
    train_sets = [PedestrianDataset(scene=s, phase="train", rand_rotation=True, **kw)
                  for s in scenes]
    val_sets = {s: PedestrianDataset(scene=s, phase="test", **kw) for s in scenes}
    bs = 16 if smoke else 512
    collate = functools.partial(pad_collate, num_entities=cfg.num_entities)
    train_loader = Loader(_ConcatDataset(train_sets), bs, collate, seed=seed)
    val_loaders = {s: _eval_loader(ds, bs, collate, seed) for s, ds in val_sets.items()}
    trainer_cfg = TrainerConfig(max_epochs=2 if smoke else 2000, lr=1e-3, monitor="pos_loss",
                                val_every_n_epochs=1 if smoke else 25, seed=seed)
    tx, _ = make_optimizer(trainer_cfg, len(train_loader))
    return ExperimentRun(name="pedestrian_first_stage", config=cfg, trainer_cfg=trainer_cfg,
                         model=model, loss_fn=make_pedestrian_first_stage_loss(cfg), tx=tx,
                         train_loader=train_loader, val_loaders=val_loaders,
                         meta={"config": dataclasses.asdict(cfg), "stage": 1,
                               "domain": "pedestrian"})


def pedestrian_second_stage(smoke: bool = False, data_root: Optional[str] = None,
                            workspace: str = "runs", seed: int = 0,
                            first_stage_run: Optional[str] = None, dit_dtype=None,
                            synthetic_scenes: Optional[int] = None,
                            test_batches: Optional[int] = None,
                            first_stage: Optional[ExperimentRun] = None, device="cuda",
                            **_) -> ExperimentRun:
    """Pedestrian stage 2 (registry.py:344-417) on a frozen stage 1 (from the
    run registry, from a stage-1 run of this process, or freshly drawn in
    smoke runs): the bf16 class-conditional DiT (depth 6, hidden 128, 4
    heads, T = 20, L = 2; fp32 in smoke runs, ``dit_dtype`` overrides) at
    B=256, AdamW lr 1e-3 over 3000 epochs, the SI loss plus the aux
    pos/inter-distance losses, ``si_loss`` monitored every 25 epochs, the
    sampled val hook (min over 20 of K=20, one batch a scene), the fp32
    ``test_model``, and the test split as both val and test loaders (the
    reference's, pedestrian.py:198-204)."""
    scenes = PED_SCENES[:2] if smoke else PED_SCENES
    if first_stage_run is not None:
        fs_model, fs_cfg = _stage1_of_run(workspace, first_stage_run,
                                          PedestrianFirstStageConfig,
                                          build_pedestrian_first_stage, device)
    elif first_stage is not None:
        fs_model, fs_cfg = first_stage.model, first_stage.config
    elif smoke:
        fs_cfg = _smoke_pedestrian_first_stage_config()
        fs_model = build_pedestrian_first_stage(fs_cfg, device=device,
                                                generator=torch.Generator().manual_seed(seed))
    else:
        raise ValueError("pedestrian_second_stage requires first_stage_run")

    kw = dict(root=data_root, num_entities=fs_cfg.num_entities, first_stage=False,
              synthetic_scenes=synthetic_scenes or (12 if smoke else 64))
    train_sets = [PedestrianDataset(scene=s, phase="train", rand_rotation=True,
                                    flip_vertical=True, flip_horizontal=True, **kw)
                  for s in scenes]
    val_sets = {s: PedestrianDataset(scene=s, phase="test", **kw) for s in scenes}
    bs = 4 if smoke else 256
    collate = functools.partial(pad_collate_temporal, num_entities=fs_cfg.num_entities)
    train_loader = Loader(_ConcatDataset(train_sets), bs, collate, seed=seed)
    val_loaders = {s: _eval_loader(ds, bs, collate, seed) for s, ds in val_sets.items()}
    cfg = (PedestrianSecondStageConfig(in_dim=fs_cfg.dim_latent, class_conditional=True,
                                       scan_layers=True)
           if not smoke else
           PedestrianSecondStageConfig(in_dim=fs_cfg.dim_latent, depth=1, hidden_size=16,
                                       num_heads=2, class_conditional=True, vec_in_dim=16))
    return _min_k_second_stage("pedestrian_second_stage", "pedestrian", cfg, fs_model,
                               build_pedestrian_second_stage, train_loader, val_loaders,
                               smoke, seed, dit_dtype, device, test_batches, first_stage_run,
                               max_epochs=3000, val_every=25)


def _min_k_second_stage(name, domain, cfg, fs_model, build, train_loader, val_loaders, smoke,
                        seed, dit_dtype, device, test_batches, first_stage_run, max_epochs,
                        val_every, meta=None) -> ExperimentRun:
    """What the pedestrian and NBA stage-2 builders share: the training and
    fp32 test DiTs, the loss, the trainer config, the min-over-K val hook,
    the test split (the val loaders) as the test loaders."""
    # bf16-mixed stage 2 by default; dit_dtype overrides (sweeps, tests)
    dtype = _dtype(dit_dtype) or (torch.float32 if smoke else torch.bfloat16)
    ss = build(cfg, fs_model, dtype=dtype, device=device,
               generator=torch.Generator().manual_seed(seed + 1))
    # the fp32 rebuild for the --test pass (src/train.py:106-118 precision="32-true")
    ss_test = build(cfg, fs_model, dtype=torch.float32, device=device,
                    generator=torch.Generator().manual_seed(seed + 1))
    loss_fn = ss.make_loss(weight_si_loss=cfg.weight_si_loss, weight_pos_loss=cfg.weight_pos_loss,
                           weight_inter_dist_loss=cfg.weight_inter_dist_loss,
                           calc_additional_losses=cfg.calc_additional_losses)
    trainer_cfg = TrainerConfig(max_epochs=2 if smoke else max_epochs, lr=1e-3,
                                monitor="si_loss", val_every_n_epochs=1 if smoke else val_every,
                                seed=seed)
    tx, _ = make_optimizer(trainer_cfg, len(train_loader))
    # sampled val min-ADE/FDE (reference second_stage/pedestrian.py:148-190)
    hook = make_protocol_val_hook(ss, val_loaders, domain, k=2 if smoke else 20,
                                  num_runs=2 if smoke else 20, limit_batches=1)
    return ExperimentRun(name=name, config=cfg, trainer_cfg=trainer_cfg, model=ss.backbone,
                         loss_fn=loss_fn, tx=tx, train_loader=train_loader,
                         val_loaders=val_loaders, second_stage=ss,
                         eval_fns={"val_sample": hook},
                         test_loaders=_test_loaders(val_loaders, test_batches),
                         test_model=ss_test,
                         meta={"config": dataclasses.asdict(cfg), "stage": 2, "domain": domain,
                               **(meta or {}), "first_stage_run": first_stage_run})


# ---------------------------------------------------------------------------
# NBA
# ---------------------------------------------------------------------------

NBA_SHIFT = {"score": 47.5787, "rebound": 47.2872}
NBA_SCALE = {"score": 24.7269, "rebound": 26.5484}


def _smoke_nba_first_stage_config(scene: str) -> NBAFirstStageConfig:
    return NBAFirstStageConfig(dim_input=32, dim_latent=8, dim_entity=32, num_latents=4,
                               dim_head_cross=8, dim_head_latent=8, scale=NBA_SCALE[scene])


def _nba_root(data_root: Optional[str], scene: str) -> Optional[str]:
    # the scene's processed directory with train/test subdirs (the
    # reference's data_dir/<scene>/<mode> SocialVAE layout)
    return None if data_root is None else os.path.join(data_root, scene)


def nba_first_stage(smoke: bool = False, data_root: Optional[str] = None,
                    workspace: str = "runs", seed: int = 0, scene: str = "score",
                    synthetic_games: Optional[int] = None, device="cuda",
                    **_) -> ExperimentRun:
    """NBA stage 1 (registry.py:428-469): fp32, B=1024 single frames (a
    random frame of a random game each), team flips and rotations, AdamW lr
    4e-4 over 10,000 epochs, ``pos_loss`` monitored every 100 epochs on the
    test split (the reference's test-as-val, nba.py:233-240)."""
    cfg = (NBAFirstStageConfig(scale=NBA_SCALE[scene]) if not smoke
           else _smoke_nba_first_stage_config(scene))
    model = build_nba_first_stage(cfg, device=device,
                                  generator=torch.Generator().manual_seed(seed))
    kw = dict(root=_nba_root(data_root, scene), num_entities=cfg.num_entities,
              shift=NBA_SHIFT[scene], scale=NBA_SCALE[scene],
              synthetic_games=synthetic_games or (16 if smoke else 64))
    train = NBADataset(scene=scene, flip=True, rand_rotation=True, split="train", **kw)
    val = NBADataset(scene=scene, split="test", **kw)
    bs = 8 if smoke else 1024
    collate = functools.partial(pad_collate, num_entities=cfg.num_entities)
    train_loader = Loader(train, bs, collate, seed=seed, drop_last=False)
    val_loaders = {scene: _eval_loader(val, bs, collate, seed)}
    trainer_cfg = TrainerConfig(max_epochs=2 if smoke else 10_000, lr=4e-4, monitor="pos_loss",
                                val_every_n_epochs=1 if smoke else 100, seed=seed)
    tx, _ = make_optimizer(trainer_cfg, len(train_loader))
    return ExperimentRun(name="nba_first_stage", config=cfg, trainer_cfg=trainer_cfg,
                         model=model, loss_fn=make_nba_first_stage_loss(cfg), tx=tx,
                         train_loader=train_loader, val_loaders=val_loaders,
                         meta={"config": dataclasses.asdict(cfg), "stage": 1, "domain": "nba",
                               "scene": scene})


def nba_second_stage(smoke: bool = False, data_root: Optional[str] = None,
                     workspace: str = "runs", seed: int = 0, scene: str = "score",
                     first_stage_run: Optional[str] = None, dit_dtype=None,
                     synthetic_games: Optional[int] = None, batch_size: Optional[int] = None,
                     test_batches: Optional[int] = None,
                     first_stage: Optional[ExperimentRun] = None, device="cuda",
                     **_) -> ExperimentRun:
    """NBA stage 2 (registry.py:472-541) on a frozen stage 1: the bf16
    class-conditional DiT (depth 6, hidden 256, 16 heads, T = 20, L = 8) at
    B=1024 windows (``batch_size``), AdamW lr 1e-3 over 1000 epochs,
    ``si_loss`` monitored every 10 epochs, the sampled val hook (min over
    20 of K=20), the fp32 ``test_model`` (K=60, the first 20 and the FPC
    picks), the test split as both val and test loaders."""
    if first_stage_run is not None:
        fs_model, fs_cfg = _stage1_of_run(workspace, first_stage_run, NBAFirstStageConfig,
                                          build_nba_first_stage, device)
    elif first_stage is not None:
        fs_model, fs_cfg = first_stage.model, first_stage.config
    elif smoke:
        fs_cfg = _smoke_nba_first_stage_config(scene)
        fs_model = build_nba_first_stage(fs_cfg, device=device,
                                         generator=torch.Generator().manual_seed(seed))
    else:
        raise ValueError("nba_second_stage requires first_stage_run")

    kw = dict(root=_nba_root(data_root, scene), num_entities=fs_cfg.num_entities,
              first_stage=False, shift=NBA_SHIFT[scene], scale=NBA_SCALE[scene],
              synthetic_games=synthetic_games or (4 if smoke else 64))
    train = NBADataset(scene=scene, flip=True, rand_rotation=True, split="train", **kw)
    val = NBADataset(scene=scene, split="test", **kw)
    bs = batch_size or (4 if smoke else 1024)
    collate = functools.partial(pad_collate_temporal, num_entities=fs_cfg.num_entities)
    train_loader = Loader(train, bs, collate, seed=seed)
    val_loaders = {scene: _eval_loader(val, bs, collate, seed)}
    cfg = (NBASecondStageConfig(in_dim=fs_cfg.dim_latent, class_conditional=True,
                                scan_layers=True)
           if not smoke else
           NBASecondStageConfig(in_dim=fs_cfg.dim_latent, depth=1, hidden_size=16, num_heads=2,
                                class_conditional=True, vec_in_dim=16))
    return _min_k_second_stage("nba_second_stage", "nba", cfg, fs_model, build_nba_second_stage,
                               train_loader, val_loaders, smoke, seed, dit_dtype, device,
                               test_batches, first_stage_run, max_epochs=1000, val_every=10,
                               meta={"scene": scene})


# ---------------------------------------------------------------------------
# Peptide
# ---------------------------------------------------------------------------


def _pep_collate(samples):
    out = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    out["attention_mask"] = np.ones(out["aatype"].shape, dtype=bool)
    return out


_FRAME_HOLDOUT_REAL = ("frame_holdout is the synthetic-data validation protocol; real data "
                       "(data_root) uses the sequence-disjoint reference splits")


def _smoke_peptide_first_stage_config(scale: float = 1.0) -> PeptideFirstStageConfig:
    return PeptideFirstStageConfig(dim_input=32, dim_latent=16, dim_entity=32, num_latents=2,
                                   num_split=4, dim_head_cross=8, dim_head_latent=8,
                                   scale=scale)


def _pep_dir(data_root: Optional[str], split: str) -> Optional[str]:
    return None if data_root is None else f"{data_root}/{split}"


def peptide_first_stage(smoke: bool = False, data_root: Optional[str] = None,
                        workspace: str = "runs", seed: int = 0,
                        synthetic_peptides: Optional[int] = None,
                        synthetic_frames: Optional[int] = None, repeats: int = 1,
                        batch_size: Optional[int] = None, frame_holdout: float = 0.0,
                        synthetic_version: int = 1, scale: float = 1.0, device="cuda",
                        **_) -> ExperimentRun:
    """4AA stage 1 (registry.py:555-627): fp32, B=512 single frames, AdamW
    lr 1e-3 over 50,000 epochs, ``pos_loss`` monitored on val every 500
    epochs. ``frame_holdout`` > 0 (synthetic only) validates on the last
    fraction of the training sequences' frames instead of the disjoint
    ``valsynth`` sequences. ``scale`` divides the coordinates (the reference
    hparam; the default 1.0 is JAX's, ROADMAP Queue 1 item 3)."""
    if frame_holdout and data_root is not None:
        raise ValueError(_FRAME_HOLDOUT_REAL)
    scale = float(scale)
    cfg = (PeptideFirstStageConfig(scale=scale) if not smoke
           else _smoke_peptide_first_stage_config(scale))
    model = build_peptide_first_stage(cfg, device=device,
                                      generator=torch.Generator().manual_seed(seed))
    kw = dict(num_entities=cfg.num_entities, n_timesteps=100, scale=scale,
              synthetic_peptides=synthetic_peptides or (4 if smoke else 8),
              synthetic_frames=synthetic_frames or (120 if smoke else 1200),
              repeats=repeats, synthetic_version=synthetic_version)
    if frame_holdout:
        kw["frame_split"] = (0.0, 1.0 - frame_holdout)
    train = PeptideDataset(data_dir=_pep_dir(data_root, "train"), first_stage=True,
                           rand_rotation=True, **kw)
    val_kw = dict(kw, repeats=1)
    if frame_holdout:
        val_kw["frame_split"] = (1.0 - frame_holdout, 1.0)
        val_kw["synthetic_prefix"] = "synth"  # same sequences, held-out frames
    else:
        val_kw["synthetic_prefix"] = "valsynth"
    val = PeptideDataset(data_dir=_pep_dir(data_root, "val"), first_stage=True, **val_kw)
    bs = batch_size or (4 if smoke else 512)
    train_loader = Loader(train, bs, _pep_collate, seed=seed, drop_last=False)
    val_loaders = {"val": _eval_loader(val, bs, _pep_collate, seed)}
    trainer_cfg = TrainerConfig(max_epochs=2 if smoke else 50_000, lr=1e-3, monitor="pos_loss",
                                val_every_n_epochs=1 if smoke else 500, seed=seed)
    tx, _ = make_optimizer(trainer_cfg, len(train_loader))
    return ExperimentRun(name="peptide_first_stage", config=cfg, trainer_cfg=trainer_cfg,
                         model=model, loss_fn=make_peptide_first_stage_loss(cfg), tx=tx,
                         train_loader=train_loader, val_loaders=val_loaders,
                         meta={"config": dataclasses.asdict(cfg), "stage": 1,
                               "domain": "peptide"})


def peptide_second_stage(smoke: bool = False, data_root: Optional[str] = None,
                         workspace: str = "runs", seed: int = 0,
                         first_stage_run: Optional[str] = None, dit_dtype=None,
                         synthetic_peptides: Optional[int] = None,
                         synthetic_frames: Optional[int] = None, repeats: int = 1,
                         batch_size: Optional[int] = None, n_timesteps: Optional[int] = None,
                         frame_holdout: float = 0.0, num_heads: Optional[int] = None,
                         synthetic_version: int = 1,
                         first_stage: Optional[ExperimentRun] = None, device="cuda",
                         **_) -> ExperimentRun:
    """4AA stage 2 (registry.py:630-712) on a frozen stage 1 (from the run
    registry, from a stage-1 run of this process, or freshly drawn in smoke
    runs): the bf16 DiT (fp32 in smoke runs; ``dit_dtype`` overrides) of
    depth 7, hidden 384, 16 heads (``num_heads``), T = 1000 windows
    (``n_timesteps``), B=16 (``batch_size``), AdamW lr 1e-3 over 1500 epochs,
    grad clip 0.5, the SI loss plus the decoded geometry aux losses,
    ``si_loss`` monitored on val every 10 epochs; the ``testsynth`` test
    loaders and the fp32 ``test_model`` that ``analysis.eval_cli`` samples
    ("fp32 sampling of the bf16-trained model", configs/eval_peptide.yaml)."""
    if frame_holdout and data_root is not None:
        raise ValueError(_FRAME_HOLDOUT_REAL)
    n_t = n_timesteps or (16 if smoke else 1000)
    if first_stage_run is not None:
        fs_state, fs_cfg_dict = load_first_stage_variables(workspace, first_stage_run)
        fs_cfg = PeptideFirstStageConfig(**{
            k: v for k, v in fs_cfg_dict.get("config", fs_cfg_dict).items()
            if k in PeptideFirstStageConfig.__dataclass_fields__})
        fs_model = build_peptide_first_stage(fs_cfg, device=device)
        fs_model.load_state_dict(fs_state)
    elif first_stage is not None:
        fs_model, fs_cfg = first_stage.model, first_stage.config
    elif smoke:
        fs_cfg = _smoke_peptide_first_stage_config()
        fs_model = build_peptide_first_stage(fs_cfg, device=device,
                                             generator=torch.Generator().manual_seed(seed))
    else:
        raise ValueError("peptide_second_stage requires first_stage_run (see run registry)")

    # the datasets inherit the stage-1 lineage's coordinate normalization
    kw = dict(num_entities=fs_cfg.num_entities, n_timesteps=n_t, first_stage=False,
              scale=fs_cfg.scale, shift=fs_cfg.shift,
              synthetic_peptides=synthetic_peptides or (2 if smoke else 8),
              synthetic_frames=synthetic_frames or (60 if smoke else 2000),
              repeats=repeats, synthetic_version=synthetic_version)
    tr_kw, val_kw = dict(kw), dict(kw, repeats=1)
    if frame_holdout:  # same sequences, temporally held-out windows
        tr_kw["frame_split"] = (0.0, 1.0 - frame_holdout)
        val_kw["frame_split"] = (1.0 - frame_holdout, 1.0)
        val_kw["synthetic_prefix"] = "synth"
    else:
        val_kw["synthetic_prefix"] = "valsynth"
    train = PeptideDataset(data_dir=_pep_dir(data_root, "train"), rand_rotation=True, **tr_kw)
    val = PeptideDataset(data_dir=_pep_dir(data_root, "val"), **val_kw)
    bs = batch_size or (2 if smoke else 16)
    train_loader = Loader(train, bs, _pep_collate, seed=seed, drop_last=False)
    val_loaders = {"val": _eval_loader(val, bs, _pep_collate, seed)}

    heads = {"num_heads": num_heads} if num_heads else {}
    cfg = (PeptideSecondStageConfig(in_dim=fs_cfg.dim_latent, num_timesteps=n_t,
                                    scan_layers=True, **heads)
           if not smoke else
           PeptideSecondStageConfig(in_dim=fs_cfg.dim_latent, depth=2, hidden_size=32,
                                    num_heads=num_heads or 4, num_timesteps=n_t))
    # bf16-mixed stage 2 by default; dit_dtype overrides (sweeps, tests)
    dtype = _dtype(dit_dtype) or (torch.float32 if smoke else torch.bfloat16)
    ss = build_peptide_second_stage(cfg, fs_model, dtype=dtype, device=device,
                                    generator=torch.Generator().manual_seed(seed + 1))
    # the fp32 rebuild: eval_cli's "fp32 sampling of the bf16-trained model"
    ss_test = build_peptide_second_stage(cfg, fs_model, dtype=torch.float32, device=device,
                                         generator=torch.Generator().manual_seed(seed + 1))
    # grad clip 0.5 for peptide stage 2 (configs/experiment/peptide/second-stage.yaml:37)
    trainer_cfg = TrainerConfig(max_epochs=2 if smoke else 1500, lr=1e-3, monitor="si_loss",
                                grad_clip=0.5, val_every_n_epochs=1 if smoke else 10,
                                seed=seed)
    tx, _ = make_optimizer(trainer_cfg, len(train_loader))
    test = PeptideDataset(data_dir=_pep_dir(data_root, "test"), synthetic_prefix="testsynth",
                          **dict(kw, repeats=1))
    test_loaders = {"test": _eval_loader(test, bs, _pep_collate, seed)}
    return ExperimentRun(name="peptide_second_stage", config=cfg, trainer_cfg=trainer_cfg,
                         model=ss.backbone, loss_fn=make_peptide_second_stage_loss(ss, cfg),
                         tx=tx, train_loader=train_loader, val_loaders=val_loaders,
                         second_stage=ss, test_loaders=test_loaders, test_model=ss_test,
                         meta={"config": dataclasses.asdict(cfg), "stage": 2,
                               "domain": "peptide", "first_stage_run": first_stage_run})


EXPERIMENTS = {
    "md17_first_stage": md17_first_stage,
    "md17_second_stage": md17_second_stage,
    "pedestrian_first_stage": pedestrian_first_stage,
    "pedestrian_second_stage": pedestrian_second_stage,
    "nba_first_stage": nba_first_stage,
    "nba_second_stage": nba_second_stage,
    "peptide_first_stage": peptide_first_stage,
    "peptide_second_stage": peptide_second_stage,
}


def build_experiment(name: str, **kwargs) -> ExperimentRun:
    if name not in EXPERIMENTS:
        raise KeyError(f"unknown experiment {name!r}; available: {sorted(EXPERIMENTS)}")
    return EXPERIMENTS[name](**kwargs)
