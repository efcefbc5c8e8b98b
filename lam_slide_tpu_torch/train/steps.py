"""Train and eval step factories (counterpart of ``lam_slide_tpu/train/steps.py``).

One ``train_step`` runs forward, backward, the optimizer update and the EMA
(the reference spreads these over Lightning hooks: training_step ->
backward -> optimizer -> on_before_zero_grad EMA; lightning_base.py:78-80).
PyTorch runs eagerly, so there is no jit and no donation: the step updates
the state in place and returns it. Metrics stay on the device.

``loss_fn`` contract:
    loss_fn(model, batch, generator, train) -> (loss, metrics_dict)
where ``model`` is called like the ``nn.Module`` (the state's model in
training, the model on the EMA weights in evaluation) and ``generator`` is
a ``torch.Generator`` on the batch's device.
"""

from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
from torch.func import functional_call

from lam_slide_tpu_torch.nn.ema import ema_update
from lam_slide_tpu_torch.train.optim import global_norm
from lam_slide_tpu_torch.train.state import TrainState


def fold_in(seed: int, data: int) -> int:
    """A 63-bit seed for the stream of (seed, data), distinct per pair: the
    role of ``jax.random.fold_in`` (the two give different numbers)."""
    return int(np.random.SeedSequence([seed, data]).generate_state(1, np.uint64)[0] >> 1)


def _generator(seed: int, batch: Mapping[str, torch.Tensor]) -> torch.Generator:
    device = next(iter(batch.values())).device
    return torch.Generator(device=device).manual_seed(seed)


def make_train_step(loss_fn: Callable, tx, ema_decay: Optional[float] = 0.999,
                    grad_accum: int = 1) -> Callable:
    """Build ``step(state, batch, seed) -> (state, metrics)``.

    RNG: the caller passes one base seed; it is folded with the step counter
    so every step draws a deterministic, distinct stream (steps.py:61).

    ``grad_accum > 1``: the batch is split along its leading axis into that
    many microbatches, each with its own stream (the step's seed folded with
    the microbatch index); their grads, losses and metrics are summed and
    averaged before ONE optimizer/EMA update, as JAX's ``lax.scan`` does.

    ``ema_decay=None``, or a state without an EMA, skips the EMA update
    (steps.py:105-106).

    metrics: the loss_fn's metrics, plus ``loss`` and ``grad_norm`` (the
    global norm of the unclipped grads), as device tensors.
    """

    def step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int):
        seed = fold_in(seed, state.step)
        params = state.params
        for p in params.values():
            p.grad = None
        if grad_accum > 1:
            size = next(iter(batch.values())).shape[0] // grad_accum
            loss, metrics = 0.0, {}
            for i in range(grad_accum):
                micro = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                mb_loss, mb_metrics = loss_fn(state.model, micro,
                                              _generator(fold_in(seed, i), micro), True)
                mb_loss.backward()
                loss = loss + mb_loss.detach()
                for k, v in mb_metrics.items():
                    metrics[k] = metrics.get(k, 0.0) + v.detach()
        else:
            loss, metrics = loss_fn(state.model, batch, _generator(seed, batch), True)
            loss.backward()
            loss = loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
        grads = {k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in params.items()}
        if grad_accum > 1:
            inv = 1.0 / grad_accum
            grads = {k: g * inv for k, g in grads.items()}
            loss = loss * inv
            metrics = {k: v * inv for k, v in metrics.items()}
        grad_norm = global_norm(grads)
        tx.step(params, grads, state.opt_state, grad_norm)
        if state.ema_params is not None and ema_decay is not None:
            ema_update(state.ema_params, params, ema_decay)
        for p in params.values():
            p.grad = None
        state.step += 1
        return state, {**metrics, "loss": loss, "grad_norm": grad_norm}

    return step


def make_eval_step(loss_fn: Callable, use_ema: bool = True) -> Callable:
    """Build ``step(state, batch, seed) -> metrics`` on the EMA weights, or
    on the parameters when ``use_ema`` is False or the state keeps no EMA
    (steps.py:155).

    Mirrors the reference's EMA swap-in for validation
    (lightning_base.py:87-96) without the swap: the model is applied to
    ``state.ema_params`` through ``torch.func.functional_call``.
    """

    def step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int):
        def on_ema(*args, **kwargs):
            return functional_call(state.model, state.ema_params, args, kwargs)

        model = on_ema if use_ema and state.ema_params is not None else state.model

        with torch.no_grad():
            loss, metrics = loss_fn(model, batch, _generator(seed, batch), False)
        return {**metrics, "loss": loss}

    return step
