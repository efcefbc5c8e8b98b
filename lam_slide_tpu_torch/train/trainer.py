"""Trainer configuration and optimizer factory (counterpart of
``TrainerConfig`` and ``make_optimizer`` in ``lam_slide_tpu/train/trainer.py``,
:30-68). The training loop itself (``Trainer``) is not ported yet; the
config holds the fields that the optimizer and the train step read, and
the loop's own fields (validation, checkpointing, logging) come with it.
"""

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

from lam_slide_tpu_torch.nn.schedules import linear_warmup_cosine
from lam_slide_tpu_torch.train.optim import AdamW


@dataclass
class TrainerConfig:
    max_epochs: int = 10
    lr: float = 1e-3
    warmup_epochs: int = 0
    min_lr: float = 1e-7
    weight_decay: float = 0.01
    ema_decay: float = 0.999
    grad_clip: Optional[float] = None


def make_optimizer(cfg: TrainerConfig,
                   steps_per_epoch: int) -> Tuple[AdamW, Callable[[int], float]]:
    """-> (optimizer, schedule). AdamW + per-step warmup-cosine (reference
    AdamW + LinearWarmupCosineAnnealingLR stepped per grad step), with
    global-norm clipping first when ``cfg.grad_clip`` is set; the schedule is
    returned so that a loop can log the LR."""
    schedule = linear_warmup_cosine(cfg.lr, cfg.warmup_epochs, cfg.max_epochs,
                                    steps_per_epoch, cfg.min_lr)
    return AdamW(schedule, weight_decay=cfg.weight_decay, clip_norm=cfg.grad_clip), schedule
