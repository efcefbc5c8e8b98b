"""Checkpointing and the local run registry (counterpart of
``lam_slide_tpu/train/checkpoint.py``).

Replaces two reference subsystems:

* Lightning ``ModelCheckpoint`` (+ EMA injected into the checkpoint dict,
  lightning_base.py:109-119): here one ``torch.save`` file holds
  ``{step, params, ema_params, opt_state, constants}`` with best/last
  retention keyed on a monitored metric. ``params`` is the model's whole
  state dict (its buffers too), ``ema_params`` the EMA of its parameters
  (or None), ``opt_state`` AdamW's ``{count, mu, nu}`` and ``constants``
  the state's constants (stage 2: the frozen first stage's state dict, so
  a test from the checkpoint needs nothing but the run directory). Files
  are written to a temporary name and moved into place, so a reader never
  sees half a checkpoint. ``meta.json`` has the JAX package's fields.
  In a multi-rank run (``group``) every rank forms the payload, whole
  tensors gathered from FSDP2's shards and from tensor parallelism's
  (parallel/tp.py, under the one-rank names), rank 0 of the group writes it
  and the others wait at a barrier, so every rank can read it back. A
  checkpoint is restored into a state of whole tensors, which the trainer
  then lays out, so any run resumes from any other's.
  Orbax checkpoints of the JAX package are not read.
* The wandb run-ID lineage between stages (src/utils/utils.py:180-199):
  a plain JSON registry under the workspace root maps run_id -> {run_dir,
  config}, in the JAX package's schema and behind the same fcntl lock, so
  stage lineage reads the same in both packages.
"""

import json
import os
import shutil
import time
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from lam_slide_tpu_torch.parallel.fsdp import full, reshard, uses_fsdp
from lam_slide_tpu_torch.parallel.tp import gather_tree, shard_tree

from lam_slide_tpu_torch.train.optim import AdamWState
from lam_slide_tpu_torch.train.state import TrainState


def _atomic_save(payload: Any, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _whole(model, tree):
    if tree is None:
        return None
    return gather_tree(model, {k: full(v).detach() for k, v in tree.items()})


def checkpoint_payload(state: TrainState) -> Dict[str, Any]:
    """The saved dict of a train state (tensors on their device; a sharded
    DTensor or a tensor-parallel block as its whole tensors, which every
    rank must call for)."""
    if uses_fsdp(state.model):
        reshard(state.model)
    opt = state.opt_state
    model = state.model
    return {"step": int(state.step),
            "params": _whole(model, model.state_dict()),
            "ema_params": _whole(model, state.ema_params),
            "opt_state": {"count": opt.count, "mu": _whole(model, opt.mu),
                          "nu": _whole(model, opt.nu)},
            "constants": state.constants}


class CheckpointManager:
    """best/last checkpoint retention on a monitored metric (mode 'min'|'max')."""

    def __init__(self, run_dir: str, monitor: str = "loss", mode: str = "min", group=None):
        self.run_dir = os.path.abspath(run_dir)
        self.ckpt_dir = os.path.join(self.run_dir, "checkpoints")
        self.group = group
        self.writer = group is None or dist.get_rank(group) == 0
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.best_metric: Optional[float] = None
        self._load_meta()

    def _meta_path(self):
        return os.path.join(self.ckpt_dir, "meta.json")

    def path(self, which: str) -> str:
        return os.path.join(self.ckpt_dir, f"{which}.pt")

    def _load_meta(self):
        if os.path.exists(self._meta_path()):
            with open(self._meta_path()) as f:
                meta = json.load(f)
            self.best_metric = meta.get("best_metric")

    def _save_meta(self, extra: Dict[str, Any]):
        meta = {"monitor": self.monitor, "mode": self.mode, "best_metric": self.best_metric}
        meta.update(extra)
        tmp = self._meta_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2)
        os.replace(tmp, self._meta_path())

    def _is_better(self, value: float) -> bool:
        if self.best_metric is None:
            return True
        return value < self.best_metric if self.mode == "min" else value > self.best_metric

    def save(self, state: TrainState, metrics: Optional[Dict[str, float]] = None):
        """Save 'last'; promote it to 'best' when the monitored metric improves."""
        step = int(state.step)
        payload = checkpoint_payload(state)
        extra = {"last_step": step}
        value = None if metrics is None else metrics.get(self.monitor)
        better = value is not None and self._is_better(float(value))
        if better:
            self.best_metric = float(value)
            extra["best_step"] = step
        if self.writer:
            _atomic_save(payload, self.path("last"))
            if better:
                tmp = f"{self.path('best')}.{os.getpid()}.tmp"
                shutil.copyfile(self.path("last"), tmp)
                os.replace(tmp, self.path("best"))
            self._save_meta(extra)
        if self.group is not None:
            dist.barrier(group=self.group)

    def restore(self, state: TrainState, which: str = "last") -> TrainState:
        """Load a checkpoint into ``state`` in place (the model's state dict,
        the EMA, the optimizer state, the step and the constants); returns it.
        A tensor-parallel state takes its slices of the whole tensors."""
        if not self.has(which):
            raise FileNotFoundError(f"no '{which}' checkpoint under {self.ckpt_dir}")
        device = next(state.model.parameters()).device
        raw = torch.load(self.path(which), map_location=device, weights_only=True)
        model = state.model
        state.model.load_state_dict(shard_tree(model, raw["params"]))
        if state.ema_params is not None and raw["ema_params"] is not None:
            ema = shard_tree(model, raw["ema_params"])
            for k, v in state.ema_params.items():
                v.copy_(ema[k])
        opt = raw["opt_state"]
        state.opt_state = AdamWState(count=int(opt["count"]), mu=shard_tree(model, opt["mu"]),
                                     nu=shard_tree(model, opt["nu"]))
        state.step = int(raw["step"])
        state.constants = raw["constants"]
        return state

    def has(self, which: str = "last") -> bool:
        return os.path.exists(self.path(which))


# ---------------------------------------------------------------------------
# Run registry (offline wandb-lineage replacement)
# ---------------------------------------------------------------------------


def _registry_path(workspace: str) -> str:
    return os.path.join(workspace, "runs.json")


def register_run(workspace: str, run_id: str, run_dir: str,
                 config: Optional[Dict[str, Any]] = None):
    """Record a run so later stages can resolve it by ID (utils.py:180-199).

    The read-modify-write is guarded by an fcntl lock so parallel launchers
    can register concurrently.
    """
    import fcntl

    os.makedirs(workspace, exist_ok=True)
    path = _registry_path(workspace)
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        registry = {}
        if os.path.exists(path):
            with open(path) as f:
                registry = json.load(f)
        registry[run_id] = {
            "run_dir": os.path.abspath(run_dir),
            "config": config or {},
            "time": time.time(),
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(registry, f, indent=2)
        os.replace(tmp, path)


def resolve_run(workspace: str, run_id: str) -> Dict[str, Any]:
    """run_id -> {run_dir, config}; raises KeyError when unknown."""
    path = _registry_path(workspace)
    if not os.path.exists(path):
        raise KeyError(f"no run registry at {path}")
    with open(path) as f:
        registry = json.load(f)
    if run_id not in registry:
        raise KeyError(f"run_id {run_id!r} not in registry {path}")
    return registry[run_id]
