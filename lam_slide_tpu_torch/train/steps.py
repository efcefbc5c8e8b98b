"""Train and eval step factories (counterpart of ``lam_slide_tpu/train/steps.py``).

One ``train_step`` runs forward, backward, the optimizer update and the EMA
(the reference spreads these over Lightning hooks: training_step ->
backward -> optimizer -> on_before_zero_grad EMA; lightning_base.py:78-80).
PyTorch runs eagerly, so there is no jit and no donation: the step updates
the state in place and returns it. Metrics stay on the device.

Over a mesh (parallel/mesh.py) each rank runs the loss on its rows of the
global batch (a ``LocalBatch``) inside ``parallel.rows.use_rows``, so it
draws what a one-rank step draws for those rows and its masked means take
the global mask mass; the grads are then averaged over the ``data`` axis,
by one all-reduce of flat per-dtype buffers after the last microbatch, or,
for a model sharded by FSDP2 (parallel/fsdp.py), by its reduce-scatter.
Under tensor parallelism (parallel/tp.py) the model ranks of a data rank
run the same rows; the grads are averaged over the data group alone (the
model group's sums ran inside the blocks), and the clip's global norm sums
the slices' squares over the model group.
The loss and metrics a step returns are this rank's terms, whose mean over
the ranks is the global batch's value; the trainer reduces them once an
epoch.

``loss_fn`` contract:
    loss_fn(model, batch, generator, train) -> (loss, metrics_dict)
where ``model`` is called like the ``nn.Module`` (the state's model in
training, the model on the EMA weights in evaluation) and ``generator`` is
a ``torch.Generator`` on the batch's device.
"""

import contextlib
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
from torch.func import functional_call

from lam_slide_tpu_torch.nn.ema import ema_update
from lam_slide_tpu_torch.parallel import fsdp as _fsdp
from lam_slide_tpu_torch.parallel import tp as _tp
from lam_slide_tpu_torch.parallel.mesh import data_group
from lam_slide_tpu_torch.parallel.rows import Rows, use_rows
from lam_slide_tpu_torch.train.optim import global_norm
from lam_slide_tpu_torch.train.state import TrainState


def fold_in(seed: int, data: int) -> int:
    """A 63-bit seed for the stream of (seed, data), distinct per pair: the
    role of ``jax.random.fold_in`` (the two give different numbers)."""
    return int(np.random.SeedSequence([seed, data]).generate_state(1, np.uint64)[0] >> 1)


def _generator(seed: int, batch: Mapping[str, torch.Tensor]) -> torch.Generator:
    device = next(iter(batch.values())).device
    return torch.Generator(device=device).manual_seed(seed)


def all_reduce_mean(tensors, group) -> None:
    """Average ``tensors`` over ``group`` in place: one all-reduce of a
    flat buffer per dtype."""
    size = dist.get_world_size(group)
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = _flatten_dense_tensors(ts)
        dist.all_reduce(flat, group=group)
        flat.div_(size)
        for t, r in zip(ts, _unflatten_dense_tensors(flat, ts)):
            t.copy_(r)


def _micro_rows(rows: Optional[Rows], accum: int) -> Optional[Rows]:
    """Each rank's microbatch i is its i-th slice; the union over the ranks
    is the global microbatch i, of which this rank holds the r-th slice."""
    if rows is None or accum == 1:
        return rows
    return Rows(rows.offset // accum, rows.count // accum, rows.total // accum, rows.group,
                rows.size)


def make_train_step(loss_fn: Callable, tx, ema_decay: Optional[float] = 0.999,
                    grad_accum: int = 1, mesh=None) -> Callable:
    """Build ``step(state, batch, seed) -> (state, metrics)``.

    RNG: the caller passes one base seed; it is folded with the step counter
    so every step draws a deterministic, distinct stream (steps.py:61).

    ``grad_accum > 1``: the batch is split along its leading axis into that
    many microbatches, each with its own stream (the step's seed folded with
    the microbatch index); their grads, losses and metrics are summed and
    averaged before ONE optimizer/EMA update, as JAX's ``lax.scan`` does.
    Over a mesh the grads are reduced once, after the last microbatch.

    ``mesh``: the ``DeviceMesh`` of a data-parallel run; the batch is a
    ``LocalBatch`` from ``parallel.shard_batch`` (a plain dict is taken as
    whole on every rank).

    ``ema_decay=None``, or a state without an EMA, skips the EMA update
    (steps.py:105-106).

    metrics: the loss_fn's metrics, plus ``loss`` and ``grad_norm`` (the
    global norm of the unclipped grads), as device tensors.
    """
    group = None if mesh is None else data_group(mesh)

    def step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int):
        seed = fold_in(seed, state.step)
        sharded = _fsdp.uses_fsdp(state.model)
        if sharded:
            _fsdp.reshard(state.model)
        params = state.params
        rows = getattr(batch, "rows", None) if group is not None else None
        for p in params.values():
            p.grad = None
        if grad_accum > 1:
            size = next(iter(batch.values())).shape[0] // grad_accum
            loss, metrics = 0.0, {}
            with use_rows(_micro_rows(rows, grad_accum)):
                for i in range(grad_accum):
                    if sharded:
                        state.model.set_requires_gradient_sync(i == grad_accum - 1)
                    micro = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                    mb_loss, mb_metrics = loss_fn(state.model, micro,
                                                  _generator(fold_in(seed, i), micro), True)
                    mb_loss.backward()
                    loss = loss + mb_loss.detach()
                    for k, v in mb_metrics.items():
                        metrics[k] = metrics.get(k, 0.0) + v.detach()
        else:
            with use_rows(rows):
                loss, metrics = loss_fn(state.model, batch, _generator(seed, batch), True)
            loss.backward()
            loss = loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
        grads = {k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in params.items()}
        if group is not None and not sharded:
            all_reduce_mean(list(grads.values()), group)
        if grad_accum > 1:
            inv = 1.0 / grad_accum
            grads = {k: g * inv for k, g in grads.items()}
            loss = loss * inv
            metrics = {k: v * inv for k, v in metrics.items()}
        grad_norm = global_norm(grads, *_tp.sharded_names(state.model))
        tx.step(params, grads, state.opt_state, grad_norm)
        if state.ema_params is not None and ema_decay is not None:
            ema_update(state.ema_params, params, ema_decay)
        for p in params.values():
            p.grad = None
        state.step += 1
        return state, {**metrics, "loss": loss, "grad_norm": grad_norm}

    return step


@contextlib.contextmanager
def on_weights(model: torch.nn.Module, weights: Optional[Mapping[str, torch.Tensor]]):
    """Yield a callable that runs ``model`` on ``weights`` (a dict keyed
    like ``named_parameters()``; None: its own). A plain model goes through
    ``torch.func.functional_call``; a model sharded by FSDP2 (whose forward
    gathers its own shards) has the weights' shards copied into its
    parameters for the block and its own copied back after it."""
    if weights is None:
        yield model
        return
    if not _fsdp.uses_fsdp(model):
        yield lambda *args, **kwargs: functional_call(model, weights, args, kwargs)
        return
    _fsdp.reshard(model)
    params = dict(model.named_parameters())
    with torch.no_grad():
        saved = {k: _fsdp.local(p).clone() for k, p in params.items()}
        for k, p in params.items():
            _fsdp.local(p).copy_(_fsdp.local(weights[k]))
    try:
        yield model
    finally:
        _fsdp.reshard(model)
        with torch.no_grad():
            for k, p in params.items():
                _fsdp.local(p).copy_(saved[k])


def make_eval_step(loss_fn: Callable, use_ema: bool = True, mesh=None) -> Callable:
    """Build ``step(state, batch, seed) -> metrics`` on the EMA weights, or
    on the parameters when ``use_ema`` is False or the state keeps no EMA
    (steps.py:155).

    Mirrors the reference's EMA swap-in for validation
    (lightning_base.py:87-96): ``on_weights`` applies the model to
    ``state.ema_params``. Over a mesh each rank evaluates its rows, as the
    train step does.
    """
    group = None if mesh is None else data_group(mesh)

    def step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int):
        weights = state.ema_params if use_ema else None
        rows = getattr(batch, "rows", None) if group is not None else None
        with torch.no_grad(), on_weights(state.model, weights) as model, use_rows(rows):
            loss, metrics = loss_fn(model, batch, _generator(seed, batch), False)
        return {**metrics, "loss": loss}

    return step
