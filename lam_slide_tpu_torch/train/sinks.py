"""Pluggable metric sinks (counterpart of ``lam_slide_tpu/train/sinks.py``,
copied: it holds no JAX) — the external experiment-tracking interface.

The reference logs through a wandb Lightning logger with hyperparameter and
gradient watching (configs/logger/wandb.yaml, src/utils/logging_utils.py:
12-65, src/train.py:71-72). Here the trainer's JSONL stream stays the
canonical record (offline, dependency-free), and every record additionally
fans out to any number of ``MetricSink``s — so a user can point the same
stream at wandb, TensorBoard, or an arbitrary callable without touching the
training loop:

    Trainer(cfg, loss_fn, run_dir, sinks=[TensorBoardSink(run_dir)])

Sinks receive the exact dicts written to metrics.jsonl (keys like
``train/loss``, ``val/<name>/pos_loss``, ``epoch``, ``step_ms``) plus a
one-time ``log_hparams`` call with run metadata (param counts, config) —
the information the reference's ``log_hyperparameters`` collected.
Adapter imports are lazy: neither wandb nor tensorboard is a dependency.
"""

from typing import Any, Callable, Dict, Optional

__all__ = ["MetricSink", "CallableSink", "TensorBoardSink", "WandbSink"]


class MetricSink:
    """Interface: override any subset; all methods are optional no-ops."""

    def log_hparams(self, hparams: Dict[str, Any]) -> None:  # noqa: D102
        pass

    def log(self, record: Dict[str, Any]) -> None:  # noqa: D102
        pass

    def close(self) -> None:  # noqa: D102
        pass


class CallableSink(MetricSink):
    """Route records to a plain function ``fn(record)``."""

    def __init__(self, fn: Callable[[Dict[str, Any]], None],
                 hparams_fn: Optional[Callable[[Dict[str, Any]], None]] = None):
        self._fn = fn
        self._hparams_fn = hparams_fn

    def log(self, record: Dict[str, Any]) -> None:
        self._fn(record)

    def log_hparams(self, hparams: Dict[str, Any]) -> None:
        if self._hparams_fn is not None:
            self._hparams_fn(hparams)


def _numeric_items(record: Dict[str, Any]):
    for k, v in record.items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        yield k, float(v)


class TensorBoardSink(MetricSink):
    """Scalar stream into TensorBoard event files.

    Uses ``torch.utils.tensorboard``, which needs the ``tensorboard``
    package: without it, building the sink raises ImportError. Steps prefer the global ``step``
    key, falling back to ``epoch``.
    """

    def __init__(self, log_dir: str):
        from torch.utils.tensorboard import SummaryWriter

        self._writer = SummaryWriter(log_dir=log_dir)
        self._fallback_step = 0

    def log(self, record: Dict[str, Any]) -> None:
        step = record.get("step", record.get("epoch"))
        if step is None:
            step = self._fallback_step
            self._fallback_step += 1
        split = record.get("split", "")
        for k, v in _numeric_items(record):
            if k in ("epoch", "step"):
                continue
            tag = k if "/" in k else (f"{split}/{k}" if split else k)
            self._writer.add_scalar(tag, v, global_step=int(step))

    def log_hparams(self, hparams: Dict[str, Any]) -> None:
        self._writer.add_text("hparams", repr(hparams))

    def close(self) -> None:
        self._writer.flush()
        self._writer.close()


class WandbSink(MetricSink):
    """wandb run mirroring the reference logger (configs/logger/wandb.yaml).

    Lazy import: constructing raises ImportError when wandb is not
    installed.
    """

    def __init__(self, project: str, name: Optional[str] = None,
                 entity: Optional[str] = None, **init_kwargs):
        try:
            import wandb
        except ImportError as e:
            raise ImportError(
                "WandbSink requires the 'wandb' package; the JSONL stream works "
                "without it") from e
        self._wandb = wandb
        self._run = wandb.init(project=project, name=name, entity=entity,
                               **init_kwargs)

    def log(self, record: Dict[str, Any]) -> None:
        step = record.get("step")
        payload = {k: v for k, v in _numeric_items(record)
                   if k not in ("step",)}
        self._run.log(payload, step=None if step is None else int(step))

    def log_hparams(self, hparams: Dict[str, Any]) -> None:
        self._run.config.update(hparams, allow_val_change=True)

    def close(self) -> None:
        self._run.finish()
