"""Training orchestration (counterpart of ``lam_slide_tpu/train/trainer.py``):
the Lightning-Trainer replacement.

One plain-Python loop drives the train step: epochs -> batches ->
``step(state, batch, seed)``, with per-epoch validation on EMA weights,
best/last checkpointing keyed on a monitored metric, JSONL metric logging,
the LR schedule (warmup-cosine computed from steps_per_epoch up front —
replacing the reference's ConfigLRScheduler callback,
src/callbacks/config_lr_scheduler.py), optional gradient clipping, and
resume. With a ``mesh`` (parallel/mesh.py) the loop runs data parallel
over its ``data`` axis, one process a rank: each rank steps on its rows of
every batch (``shard_batch``; a loader with a ``process_shard`` already
feeds them), the grads are averaged across the ranks, ``fsdp=True`` shards
the parameters, EMA and AdamW moments with FSDP2 (parallel/fsdp.py), a
model axis above 1 splits the DiT blocks over the model group
(parallel/tp.py; the model ranks of a data rank step on the same rows),
the epoch's metric means are averaged over the ranks once, rank 0 writes
the metric stream and the checkpoints (whole tensors, so a checkpoint of a
data-parallel, FSDP or tensor-parallel run loads in a one-card run) and
every rank reads them back on a resume.

Metrics stay on the device: each step's metrics are kept as tensors, and
the loop waits for the device once every ``log_every_steps`` steps (so the
host cannot run ahead by more) and once at the end of an epoch, where one
``torch.stack(...).cpu()`` brings every metric of the epoch to the host.
"""

import json
import os
import shutil
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from lam_slide_tpu_torch.data.loader import device_batch
from lam_slide_tpu_torch.parallel.fsdp import shard_train_state_fsdp, sharded_share
from lam_slide_tpu_torch.parallel import tp as _tp
from lam_slide_tpu_torch.parallel.mesh import (
    LocalBatch,
    broadcast_module,
    data_group,
    data_size,
    model_size,
    shard_batch,
)
from lam_slide_tpu_torch.nn.schedules import linear_warmup_cosine
from lam_slide_tpu_torch.train.checkpoint import CheckpointManager
from lam_slide_tpu_torch.train.optim import AdamW
from lam_slide_tpu_torch.train.state import TrainState, create_train_state
from lam_slide_tpu_torch.train.steps import make_eval_step, make_train_step
from lam_slide_tpu_torch.utils.profiling import StepTimer


@dataclass
class TrainerConfig:
    max_epochs: int = 10
    lr: float = 1e-3
    warmup_epochs: int = 0
    min_lr: float = 1e-7
    weight_decay: float = 0.01
    ema_decay: Optional[float] = 0.999
    grad_clip: Optional[float] = None
    grad_accum: int = 1  # microbatches per optimizer step (see steps.py)
    monitor: str = "loss"  # metric key within val metrics
    monitor_mode: str = "min"
    val_every_n_epochs: int = 1
    # 'last' checkpoint cadence on non-val epochs (val epochs always save,
    # they carry the monitored metric)
    ckpt_every_n_epochs: int = 1
    limit_val_batches: int = 0  # 0 = all (reference limit_val_batches)
    log_every_steps: int = 50
    # fully-sharded data parallelism over the mesh's data axis
    # (parallel/fsdp.py); without a mesh there is nothing to shard
    fsdp: bool = False
    seed: int = 0


def make_optimizer(cfg: TrainerConfig,
                   steps_per_epoch: int) -> Tuple[AdamW, Callable[[int], float]]:
    """-> (optimizer, schedule). AdamW + per-step warmup-cosine (reference
    AdamW + LinearWarmupCosineAnnealingLR stepped per grad step), with
    global-norm clipping first when ``cfg.grad_clip`` is set; the schedule is
    returned so the trainer can log the LR (the reference's
    LearningRateMonitor callback)."""
    schedule = linear_warmup_cosine(cfg.lr, cfg.warmup_epochs, cfg.max_epochs,
                                    steps_per_epoch, cfg.min_lr)
    return AdamW(schedule, weight_decay=cfg.weight_decay, clip_norm=cfg.grad_clip), schedule


class MetricLogger:
    """JSONL + stdout metric stream, fanning every record out to pluggable
    ``MetricSink``s (train/sinks.py) — the interface a user points at wandb
    or TensorBoard (reference configs/logger/wandb.yaml,
    src/utils/logging_utils.py:12-65)."""

    def __init__(self, run_dir: str, quiet: bool = False, sinks=()):
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self.quiet = quiet
        self.sinks = list(sinks)

    def log_hparams(self, hparams: Dict[str, Any]):
        for sink in self.sinks:
            sink.log_hparams(hparams)

    def log(self, record: Dict[str, Any]):
        if self._f.closed:  # fit() reuse after a close
            self._f = open(self.path, "a")
        record = {
            k: (float(v) if hasattr(v, "item") or isinstance(v, (int, float)) else v)
            for k, v in record.items()
        }
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()
        for sink in self.sinks:
            sink.log(record)
        if not self.quiet:
            parts = [f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in record.items()]
            print("  " + " ".join(parts), flush=True)

    def backup(self):
        """Copy a non-empty existing stream to metrics.jsonl.bak; return the
        backup path (None when there was nothing to save)."""
        if not (os.path.exists(self.path) and os.path.getsize(self.path)):
            return None
        bak = self.path + ".bak"
        shutil.copyfile(self.path, bak)
        return bak

    def reset(self):
        """Truncate the JSONL stream (fresh fit into a reused run dir)."""
        self._f.close()
        self._f = open(self.path, "w")

    def close(self):
        self._f.close()
        # external sinks are per fit: a finished wandb run rejects further
        # log() calls, so drop them; reuse reopens only the JSONL stream
        for sink in self.sinks:
            sink.close()
        self.sinks = []


def _mean_metrics(acc: Dict[str, list], group=None) -> Dict[str, float]:
    """Per-key means of lists of 0-dim device tensors, brought to the host in
    one transfer (the float32 means np.mean takes of the JAX values); over a
    data-parallel ``group``, then averaged over its ranks in one all-reduce."""
    if not acc:
        return {}
    keys = list(acc)
    host = torch.stack([torch.stack([v.float() for v in acc[k]]) for k in keys]).cpu().numpy()
    means = np.asarray([np.mean(row) for row in host], dtype=np.float32)
    if group is not None:
        device = acc[keys[0]][0].device
        reduced = torch.from_numpy(means).to(device)
        dist.all_reduce(reduced, group=group)
        means = (reduced / dist.get_world_size(group)).cpu().numpy()
    return {k: float(v) for k, v in zip(keys, means)}


class _NullLogger:
    """The metric stream of a rank other than 0: rank 0 writes it."""

    def log_hparams(self, hparams):
        pass

    def log(self, record):
        pass

    def backup(self):
        return None

    def reset(self):
        pass

    def close(self):
        pass


def _wait(t: Optional[torch.Tensor]) -> None:
    """Wait for the device work that produces ``t`` (no host copy)."""
    if t is not None and t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


class Trainer:
    """fit() drives train/val/checkpoint; the test protocols live in
    composites/testing.py."""

    def __init__(self, cfg: TrainerConfig, loss_fn: Callable, run_dir: str,
                 eval_fns: Optional[Mapping[str, Callable]] = None, quiet: bool = False,
                 sinks=(), mesh=None):
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.run_dir = os.path.abspath(run_dir)
        self.eval_fns = dict(eval_fns or {})
        self.mesh = mesh
        self.group = None if mesh is None else data_group(mesh)
        self.is_main = mesh is None or dist.get_rank() == 0
        self.logger = (MetricLogger(self.run_dir, quiet=quiet, sinks=sinks) if self.is_main
                       else _NullLogger())
        self.quiet = quiet or not self.is_main

    def init_state(self, model: nn.Module, steps_per_epoch: int,
                   constants: Optional[Dict[str, Any]] = None):
        tx, self._schedule = make_optimizer(self.cfg, steps_per_epoch)
        state = create_train_state(model, tx, ema=self.cfg.ema_decay is not None,
                                   constants=constants)
        return state, tx

    def fit(self, model: nn.Module, train_loader,
            val_loaders: Optional[Mapping[str, Iterable]] = None, resume: bool = False,
            constants: Optional[Dict[str, Any]] = None) -> TrainState:
        """Train ``model``'s parameters in place. ``constants`` is the
        non-trainable state the checkpoints carry beside them (stage 2: the
        frozen first stage's state dict under ``"first_stage"``). Batches
        move to the model's device."""
        cfg = self.cfg
        self.device = next(model.parameters()).device
        steps_per_epoch = max(len(train_loader), 1)
        if self.group is not None:
            broadcast_module(model, self.mesh)  # every rank starts from rank 0's weights
        state, tx = self.init_state(model, steps_per_epoch, constants)

        # every rank takes part in a save (the gathers), rank 0 writes
        ckpt = CheckpointManager(self.run_dir, monitor=cfg.monitor, mode=cfg.monitor_mode,
                                 group=None if self.mesh is None else dist.group.WORLD)
        start_epoch = 0
        if resume and ckpt.has("last"):
            ckpt.restore(state, "last")
            start_epoch = state.step // steps_per_epoch
            if not self.quiet:
                print(f"resumed from step {state.step} (epoch {start_epoch})")
        else:
            # a fresh fit into a reused run dir truncates the metric stream,
            # so the curve is one run's; a --resume that finds no 'last'
            # lands here too: warn and keep the prior stream as .bak
            if resume:
                backup = self.logger.backup()
                print("WARNING: --resume found no 'last' checkpoint in "
                      f"{self.run_dir}; starting fresh"
                      + (f" (prior metrics saved to {backup})" if backup else ""))
            self.logger.reset()

        # sharding after a possible resume, so a restored state gets laid out
        tp = self.mesh is not None and model_size(self.mesh) > 1
        fsdp = cfg.fsdp and self.mesh is not None
        if tp and fsdp:  # lam_slide_tpu/train/trainer.py:200-202
            raise ValueError("fsdp composes with the data axis only; "
                             "use either --model-axis or fsdp")
        if tp:
            state = _tp.shard_train_state(state, self.mesh)
        elif fsdp:
            state = shard_train_state_fsdp(state, self.mesh)
            share = sharded_share(state.model, data_size(self.mesh))
            if not self.quiet:
                print(f"fsdp: {share['sharded_bytes']}/{share['total_bytes']} param bytes "
                      f"sharded over data ({share['share']:.3f}; JAX's rule "
                      f"{share['jax_rule_share']:.3f})")
        train_step = make_train_step(self.loss_fn, tx, ema_decay=cfg.ema_decay,
                                     grad_accum=cfg.grad_accum, mesh=self.mesh)
        eval_step = make_eval_step(self.loss_fn, mesh=self.mesh)
        n_params = _tp.global_param_count(state.model)
        if not self.quiet:
            print(f"params: {n_params:,}  steps/epoch: {steps_per_epoch}")
        # hyperparameter logging to sinks (reference log_hyperparameters,
        # src/utils/logging_utils.py:12-65: config + model/params counts)
        self.logger.log_hparams({
            "params": n_params, "steps_per_epoch": steps_per_epoch,
            "run_dir": self.run_dir, **{f"trainer/{k}": v for k, v in vars(cfg).items()
                                        if isinstance(v, (int, float, str, bool, type(None)))},
        })

        timer = StepTimer()
        try:
            state = self._fit_loop(state, train_loader, val_loaders, train_step, eval_step,
                                   ckpt, start_epoch, timer)
        except BaseException as e:
            # task_wrapper semantics (src/utils/utils.py:46-98): record the
            # failure and keep the last state, so a failed job can resume
            self.logger.log({"split": "error", "error": f"{type(e).__name__}: {e}"[:500],
                             "step": state.step})
            if self.mesh is None or self.mesh.size() == 1:  # one rank cannot gather
                try:
                    ckpt.save(state)
                except Exception:
                    pass  # the per-epoch 'last' checkpoint already covers resume
            raise
        finally:
            self.logger.close()
        return state

    def _fit_loop(self, state, train_loader, val_loaders, train_step, eval_step, ckpt,
                  start_epoch, timer):
        cfg = self.cfg
        for epoch in range(start_epoch, cfg.max_epochs):
            t0 = time.time()
            acc: Dict[str, list] = {}
            n_steps = 0
            last_loss = None
            for batch in train_loader:
                state, metrics = train_step(state, self._put(batch, train_loader), cfg.seed)
                for k, v in metrics.items():
                    acc.setdefault(k, []).append(v)
                last_loss = metrics.get("loss")
                n_steps += 1
                if cfg.log_every_steps and n_steps % cfg.log_every_steps == 0:
                    _wait(last_loss)
            _wait(last_loss)  # epoch wall time = device time
            epoch_s = time.time() - t0
            train_metrics = _mean_metrics(acc, self.group)
            timer.record_epoch(epoch_s, n_steps)
            record = {"epoch": epoch, "split": "train", "time_s": round(epoch_s, 2),
                      "step_ms": round(epoch_s / max(n_steps, 1) * 1e3, 2),
                      "train/lr": float(self._schedule(state.step))}
            record.update({f"train/{k}": v for k, v in train_metrics.items()})
            self.logger.log(record)

            if val_loaders and (epoch + 1) % cfg.val_every_n_epochs == 0:
                val_metrics = self.validate(state, val_loaders, eval_step, epoch)
                # in-training evaluation hooks (the reference's sampling
                # callbacks): each fn gets (state, epoch) and returns a
                # metric dict
                for name, fn in self.eval_fns.items():
                    extra = fn(state, epoch)
                    if extra:
                        rec = {"epoch": epoch, "split": f"hook/{name}"}
                        rec.update({f"{name}/{k}": float(v) for k, v in extra.items()})
                        self.logger.log(rec)
                ckpt.save(state, val_metrics)
            elif ((epoch + 1) % cfg.ckpt_every_n_epochs == 0
                  or epoch == cfg.max_epochs - 1):
                ckpt.save(state)
        return state

    def validate(self, state, val_loaders, eval_step, epoch) -> Dict[str, float]:
        all_means: Dict[str, list] = {}
        for name, loader in val_loaders.items():
            acc: Dict[str, list] = {}
            for bi, batch in enumerate(loader):
                if self.cfg.limit_val_batches and bi >= self.cfg.limit_val_batches:
                    break
                metrics = eval_step(state, self._put(batch, loader), self.cfg.seed)
                for k, v in metrics.items():
                    acc.setdefault(k, []).append(v)  # device tensors, no sync
            means = _mean_metrics(acc, self.group)
            record = {"epoch": epoch, "split": f"val/{name}"}
            record.update({f"val/{name}/{k}": v for k, v in means.items()})
            self.logger.log(record)
            for k, v in means.items():
                all_means.setdefault(k, []).append(v)
        return {k: float(np.mean(v)) for k, v in all_means.items()}

    def _put(self, batch: Mapping[str, Any], loader=None) -> Dict[str, torch.Tensor]:
        """A loader batch (numpy arrays or tensors) on the model's device;
        over a mesh, this rank's rows of it (``shard_batch``: a loader with a
        ``process_shard`` hands over this rank's rows, any other the whole
        batch)."""
        rows = None
        if self.mesh is not None:
            batch = shard_batch(batch, self.mesh,
                                full_local=getattr(loader, "process_shard", None) is None)
            rows = batch.rows
        if all(isinstance(v, torch.Tensor) for v in batch.values()):
            out = {k: v.to(self.device, non_blocking=True) for k, v in batch.items()}
        else:
            out = device_batch(batch, self.device)
        if self.mesh is None:
            return out
        out = LocalBatch(out)
        out.rows = rows
        return out
