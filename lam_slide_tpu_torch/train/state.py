"""Training state (counterpart of ``lam_slide_tpu/train/state.py``).

JAX keeps ``{step, params, ema_params, opt_state, constants}`` as one
immutable pytree. Here the parameters live in the model (``nn.Module``) and
the train step updates them, the optimizer state and the EMA in place;
evaluation applies the model to ``ema_params`` with
``torch.func.functional_call`` instead of swapping weights. ``ema_params``
is None when the run keeps no EMA (``ema_decay=None``), as in JAX.
``constants`` holds the non-trainable state the loss reads from outside
the model (stage 2: the frozen first stage's state dict under
``"first_stage"``); the checkpoint saves it beside the rest.
"""

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from lam_slide_tpu_torch.nn.ema import ema_init


@dataclass
class TrainState:
    step: int
    model: nn.Module
    ema_params: Optional[Dict[str, torch.Tensor]]
    opt_state: Any
    constants: Optional[Dict[str, Any]] = None

    @property
    def params(self) -> Dict[str, nn.Parameter]:
        return dict(self.model.named_parameters())


def create_train_state(model: nn.Module, tx, ema: bool = True,
                       constants: Optional[Dict[str, Any]] = None) -> TrainState:
    """Wrap ``model``: its parameters are trained in place; the EMA (when
    ``ema``) starts as a copy of them and the optimizer state from
    ``tx.init``."""
    params = dict(model.named_parameters())
    return TrainState(step=0, model=model, ema_params=ema_init(params) if ema else None,
                      opt_state=tx.init(params), constants=constants)


def param_count(params: Mapping[str, torch.Tensor]) -> int:
    return sum(int(p.numel()) for p in params.values())
