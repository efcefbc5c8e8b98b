"""AdamW with optax's semantics, and optax's global-norm clipping.

Counterpart of ``optax.chain(optax.clip_by_global_norm(clip),
optax.adamw(schedule, weight_decay=wd))``, the optimizer the JAX trainer
builds (train/trainer.py:57-68). Parameters and gradients are dicts keyed
like ``named_parameters()``; ``AdamW.step`` updates the parameters and its
state in place, where optax returns new trees. Per update:

    g    <- g · max_norm / ‖g‖   when clipping is on and ‖g‖ >= max_norm
    mu   <- b1 · mu + (1 − b1) · g;   nu <- b2 · nu + (1 − b2) · g²
    p    <- p − lr(count) · (mu / (1 − b1^t) / (√(nu / (1 − b2^t)) + eps) + wd · p)

with t = count + 1 and decoupled weight decay on every parameter. FSDP2's
DTensor parameters, grads and moments are updated shard by shard, as are
tensor parallelism's slices (parallel/tp.py): the update is elementwise,
and the clip's norm counts each slice once and each replicated tensor once.
``torch.optim.AdamW`` applies the decay before the Adam step and
``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm, so neither is
used.
"""

from dataclasses import dataclass
from typing import Callable, Collection, Dict, Mapping, Optional

import torch
import torch.distributed as dist

from lam_slide_tpu_torch.parallel import fsdp as _fsdp


def global_norm(tensors: Mapping[str, torch.Tensor], model_sharded: Collection[str] = (),
                model_group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``),
    an fp32 0-dim tensor on the tensors' device. Shards of DTensors (FSDP2's
    grads) count once over their mesh: their local sums of squares are
    all-reduced, so every rank clips by the same norm. So do the tensors
    named in ``model_sharded``, tensor-parallel slices spread over
    ``model_group`` (parallel/tp.py ``sharded_names``), while every other
    tensor, whole on each rank of that group, counts once."""
    whole, parts, tp_parts, mesh = [], [], [], None
    for name, t in tensors.items():
        if _fsdp.is_sharded(t):
            parts.append(_fsdp.local(t).float().square().sum())
            mesh = t.device_mesh
        elif name in model_sharded and model_group is not None:
            tp_parts.append(t.float().square().sum())
        else:
            whole.append(_fsdp.local(t).float().square().sum())
    total = torch.stack(whole).sum() if whole else None
    for sums, group in ((parts, None if mesh is None else mesh.get_group(0)),
                        (tp_parts, model_group)):
        if sums:
            shared = torch.stack(sums).sum()
            dist.all_reduce(shared, group=group)
            total = shared if total is None else total + shared
    return total.sqrt()


@dataclass
class AdamWState:
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


# optax.adamw's defaults, which the JAX trainer keeps
B1, B2, EPS = 0.9, 0.999, 1e-8


class AdamW:
    """optax.adamw(learning_rate, weight_decay=weight_decay), preceded by
    optax.clip_by_global_norm(clip_norm) when ``clip_norm`` is set."""

    def __init__(self, learning_rate: Callable[[int], float], weight_decay: float,
                 clip_norm: Optional[float] = None):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamWState:
        zeros = {name: torch.zeros_like(p, memory_format=torch.preserve_format)
                 for name, p in params.items()}
        return AdamWState(count=0, mu=zeros, nu={k: torch.zeros_like(v) for k, v in zeros.items()})

    @torch.no_grad()
    def step(self, params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
             state: AdamWState, grad_norm: torch.Tensor) -> None:
        """One update of ``params`` and ``state`` in place; ``grad_norm`` is
        ``global_norm(grads)``, which the train step also reports."""
        if self.clip_norm is not None:
            keep = grad_norm < self.clip_norm
            grads = {k: torch.where(keep, g, g / grad_norm * self.clip_norm)
                     for k, g in grads.items()}
        lr = self.learning_rate(state.count)
        t = state.count + 1
        # bias corrections in fp32, as optax takes decay ** count
        bc1, bc2 = ((1.0 - torch.tensor(b, dtype=torch.float32) ** t).item() for b in (B1, B2))
        for name, p in params.items():
            # DTensors (FSDP2) update their local shards in place
            p, g, mu, nu = (_fsdp.local(t) for t in (p, grads[name], state.mu[name],
                                                      state.nu[name]))
            mu.mul_(B1).add_(g, alpha=1.0 - B1)
            nu.mul_(B2).addcmul_(g, g, value=1.0 - B2)
            update = (mu / bc1) / ((nu / bc2).sqrt_() + EPS)
            p.sub_(update.add_(p, alpha=self.weight_decay).mul_(lr))
        state.count = t
