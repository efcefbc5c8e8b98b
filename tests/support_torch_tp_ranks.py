"""Rank-side checks of tests/test_torch_port_tp.py.

Runs in each spawned gloo rank (``parallel.run_ranks``) of a data 1 x
model 2 mesh, so it imports torch and the port only: the JAX side of every
comparison runs in the test process. ``tp_checks`` reads the test's inputs
(a torch.save file), runs the tensor-parallel cases and returns plain
tensors and numbers.
"""

import os

import torch
import torch.distributed as dist


def dit_loss(model, batch, generator, train):
    """The GVP data-prediction SI loss of tests/test_tp.py on the batch's
    injected t and x0."""
    from lam_slide_tpu_torch.transport import create_transport

    out = create_transport(path_type="GVP", prediction="data").training_losses(
        model, batch["x1"], {"x_cond": batch["x_cond"], "x_cond_mask": batch["mask"]},
        generator=generator, t=batch.get("t"), x0=batch.get("x0"))
    loss = out["loss"].mean()
    return loss, {"si_loss": loss}


def tiny_dit(sd, cfg):
    from lam_slide_tpu_torch.models import LatentDiT

    model = LatentDiT(**cfg, reference_init=False, device="cpu")
    model.load_state_dict(sd)
    return model


def tiny_md17(inputs):
    """-> (second stage, loss_fn) of the multichip dry run's tiny MD17, on
    the JAX init's converted weights, its transport drawing the injected t
    and x0 (this rank's rows of them)."""
    from lam_slide_tpu_torch.parallel import rows as prow
    from lam_slide_tpu_torch.tools.multichip_dryrun import build_tiny_md17

    ss, loss_fn = build_tiny_md17()
    ss.first_stage.load_state_dict(inputs["fs_sd"])
    ss.backbone.load_state_dict(inputs["md17_sd"])
    t, x0 = inputs["md17_t"], inputs["md17_x0"]

    def sample(self, x1, generator):
        r = prow.active()
        sl = slice(None) if r is None else slice(r.offset, r.offset + r.count)
        return t[sl], x0[sl], x1

    def injected(model, batch, generator, train):
        cls = type(ss.transport)  # a frozen dataclass: patch its class for the call
        real, cls.sample = cls.sample, sample
        try:
            return loss_fn(model, batch, generator, train)
        finally:
            cls.sample = real

    return ss, injected


def tp_step(model, loss_fn, batch, trainer, mesh=None, size=None):
    """One train step of ``model`` laid out for tensor parallelism (over
    ``mesh``'s model group, or ``size`` shards in this process) -> the step's
    loss and grad norm, the whole parameters and EMA under the one-rank
    names, and this rank's parameter and AdamW-moment shapes."""
    from lam_slide_tpu_torch.parallel import gather_tree, shard_batch, shard_train_state
    from lam_slide_tpu_torch.train import create_train_state, make_train_step
    from lam_slide_tpu_torch.train.trainer import TrainerConfig, make_optimizer

    tx, _ = make_optimizer(TrainerConfig(**trainer), 1)
    state = shard_train_state(create_train_state(model, tx), mesh=mesh, size=size)
    if mesh is not None:
        batch = shard_batch(batch, mesh, full_local=True)
    state, metrics = make_train_step(loss_fn, tx, mesh=mesh)(state, batch, 0)
    params = dict(state.model.named_parameters())
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "params": {k: v.detach().clone()
                       for k, v in gather_tree(state.model, params).items()},
            "ema": {k: v.clone() for k, v in gather_tree(state.model, state.ema_params).items()},
            "shapes": {k: tuple(v.shape) for k, v in params.items()},
            "mu_shapes": {k: tuple(v.shape) for k, v in state.opt_state.mu.items()},
            "state": state}


def _checkpoint(inputs, mesh, state, ckpt_dir):
    """Save the TP state through CheckpointManager (rank 0 writes the
    gathered tensors), then restore the file into a fresh TP state."""
    from lam_slide_tpu_torch.parallel import shard_train_state
    from lam_slide_tpu_torch.train import create_train_state
    from lam_slide_tpu_torch.train.checkpoint import CheckpointManager
    from lam_slide_tpu_torch.train.trainer import TrainerConfig, make_optimizer

    ckpt = CheckpointManager(ckpt_dir, group=dist.group.WORLD)
    ckpt.save(state, {"loss": 1.0})
    tx, _ = make_optimizer(TrainerConfig(**inputs["trainer"]), 1)
    fresh = tiny_dit(inputs["dit_sd"], inputs["dit_cfg"])
    fresh_state = shard_train_state(create_train_state(fresh, tx), mesh=mesh)
    ckpt.restore(fresh_state, "last")
    return {"restored": {k: v.detach().clone() for k, v in fresh.named_parameters()},
            "saved": {k: v.detach().clone() for k, v in state.model.named_parameters()},
            "mu_restored": {k: v.clone() for k, v in fresh_state.opt_state.mu.items()},
            "mu_saved": {k: v.clone() for k, v in state.opt_state.mu.items()}}


def _fsdp_refused(inputs, mesh, run_dir) -> str:
    from lam_slide_tpu_torch.train.trainer import Trainer, TrainerConfig

    model = tiny_dit(inputs["dit_sd"], inputs["dit_cfg"])
    trainer = Trainer(TrainerConfig(max_epochs=1, fsdp=True), dit_loss, run_dir, quiet=True,
                      mesh=mesh)
    try:
        trainer.fit(model, [inputs["dit_batch"]])
    except ValueError as e:
        return str(e)
    return ""


def tp_checks(rank: int, path: str) -> dict:
    from lam_slide_tpu_torch.parallel import MeshSpec, make_mesh

    inputs = torch.load(path, weights_only=False)
    mesh = make_mesh(MeshSpec(data=1, model=2))
    out = {"model_rank": mesh.get_local_rank("model")}
    dit = tp_step(tiny_dit(inputs["dit_sd"], inputs["dit_cfg"]), dit_loss, inputs["dit_batch"],
                  inputs["trainer"], mesh=mesh)
    state = dit.pop("state")
    out["dit"] = dit
    ss, loss_fn = tiny_md17(inputs)
    batch = {k: torch.as_tensor(v) for k, v in inputs["md17_batch"].items()}
    md17 = tp_step(ss.backbone, loss_fn, batch, inputs["trainer"], mesh=mesh)
    md17.pop("state")
    out["md17"] = md17
    work = os.path.join(os.path.dirname(path), "ckpt")
    out["checkpoint"] = _checkpoint(inputs, mesh, state, work)
    out["fsdp"] = _fsdp_refused(inputs, mesh, os.path.join(os.path.dirname(path),
                                                           f"fsdp{rank}"))
    return out
