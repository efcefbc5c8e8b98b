"""Learning-rate schedules (counterpart of ``lam_slide_tpu/nn/schedules.py``,
reference src/modules/schedulers.py).

Each factory returns a plain function of the optimizer step (0 for the
first update) that gives the learning rate as a Python float; like the JAX
versions they count the step from 1 inside.
"""

import math
from typing import Callable


def linear_warmup_cosine(base_lr: float, warmup_epochs: int, max_epochs: int,
                         steps_per_epoch: int, min_lr: float = 0.0) -> Callable[[int], float]:
    """LinearWarmupCosineAnnealingLR semantics (schedulers.py:6-41).

    Step counter is the optimizer step; warmup_epochs == 0 -> pure cosine.
    """
    warmup_steps = warmup_epochs * steps_per_epoch
    max_steps = max(max_epochs * steps_per_epoch, 1)

    def schedule(step: int) -> float:
        step = float(step) + 1.0
        if step <= warmup_steps:
            return base_lr * step / max(warmup_steps, 1)
        progress = min(max((step - warmup_steps) / max(max_steps - warmup_steps, 1), 0.0), 1.0)
        return min_lr + 0.5 * (base_lr - min_lr) * (1.0 + math.cos(math.pi * progress))

    return schedule


def warmup_cosine_per_epoch(base_lr: float, warmup_epochs: int, total_epochs: int,
                            steps_per_epoch: int, eta_min: float = 0.0) -> Callable[[int], float]:
    """Per-epoch variant (reference WarmupCosineAnnealingLR, schedulers.py:44-70):
    LR changes once per epoch, linear warmup then cosine to eta_min."""

    def schedule(step: int) -> float:
        epoch = math.floor(float(step) / max(steps_per_epoch, 1))
        if epoch < warmup_epochs:
            return base_lr * (epoch + 1.0) / max(warmup_epochs, 1)
        progress = (epoch - warmup_epochs) / max(total_epochs - warmup_epochs, 1)
        progress = min(max(progress, 0.0), 1.0)
        return eta_min + 0.5 * (base_lr - eta_min) * (1.0 + math.cos(math.pi * progress))

    return schedule
