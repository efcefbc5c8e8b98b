"""Exponential moving average of parameters (counterpart of
``lam_slide_tpu/nn/ema.py``, reference src/modules/ema.py:44-61).

The EMA is a dict of fp32 tensors keyed like ``named_parameters()``; the
model is evaluated on it with ``torch.func.functional_call``, so no weights
are swapped in and out. ``ema_update`` works in place to hold one copy.
"""

from typing import Dict, Mapping

import torch

from lam_slide_tpu_torch.parallel.fsdp import local


def ema_init(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Detached copies of the parameters."""
    return {name: p.detach().clone() for name, p in params.items()}


@torch.no_grad()
def ema_update(ema_params: Dict[str, torch.Tensor], params: Mapping[str, torch.Tensor],
               decay: float) -> Dict[str, torch.Tensor]:
    """copy = copy - (1 - decay) * (copy - param), in place; returns ema_params.

    JAX's formula (ema.py:19-22), with 1 - decay taken in fp32 as the JAX
    package takes it.
    """
    rate = (1.0 - torch.tensor(decay, dtype=torch.float32)).item()
    for name, e in ema_params.items():
        e, p = local(e), local(params[name])  # DTensors (FSDP2): shard by shard
        e.sub_((e - p.to(e.dtype)).mul_(rate))
    return ema_params
