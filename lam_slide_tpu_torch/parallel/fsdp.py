"""Fully-sharded data parallelism over the ``data`` axis (counterpart of
``lam_slide_tpu/parallel/fsdp.py``).

JAX states the ZeRO-3 layout as PartitionSpecs (``fsdp_spec``: each leaf of
at least ``MIN_SHARD_ELEMENTS`` elements sharded on its largest divisible
dim) and lets GSPMD insert the all-gathers. The port uses FSDP2's
``fully_shard``: each block of the model (every element of a block list:
the DiT's layers, the encoder's and decoder's attention blocks) is one
unit, the root module takes the rest. Every parameter becomes a DTensor
sharded on dim 0 over ``data``; the forward all-gathers a unit's weights
just before it runs and frees them after, and the backward
reduce-scatters the grads (averaged over the ranks). The EMA and the AdamW
moments are laid out like their parameters, so they are sharded too; the
frozen first stage is not a parameter of the trained model and stays
whole on every rank (the JAX state's replicated constants).

``fsdp_spec`` is copied for the layout report: ``sharded_share`` gives the
share of parameter bytes FSDP2 shards and the share JAX's rule would.

The kernels see the gathered weights as plain tensors. One of them keeps a
re-laid copy of its weights between calls (K8-fp32's outer-product
operands, ``ops.fused_spatial_block._tiled_operands``), keyed on the
weight's storage and version. FSDP2 writes each all-gather into the same
parameter with its version counter preserved, so after a step that
changes the weights that key would still match. ``shard_model`` registers
a forward pre-hook on every unit that drops that cache before the unit
runs.
"""

import warnings
from typing import Dict, List, Tuple

import torch
from torch import nn

# Leaves below this many elements replicate under JAX's rule (fsdp.py:39-43).
MIN_SHARD_ELEMENTS = 4096


def fsdp_spec(shape: Tuple[int, ...], data_size: int,
              min_size: int = MIN_SHARD_ELEMENTS) -> tuple:
    """JAX's PartitionSpec for a leaf of ``shape`` as a tuple: "data" on the
    largest data_size-divisible dim, None elsewhere; () replicates."""
    ndim = len(shape)
    if data_size <= 1 or ndim == 0:
        return ()
    size = 1
    for n in shape:
        size *= n
    if size < min_size:
        return ()
    for i in sorted(range(ndim), key=lambda i: (-shape[i], i)):
        if shape[i] >= data_size and shape[i] % data_size == 0:
            spec = [None] * ndim
            spec[i] = "data"
            return tuple(spec)
    return ()


def block_units(model: nn.Module) -> List[nn.Module]:
    """The modules ``shard_model`` makes FSDP units below the root: the
    elements of every ``nn.ModuleList`` that are called as modules (lists
    nested in a list, such as Encoder2's (cross, self) pairs, are entered)."""
    units: List[nn.Module] = []

    def visit(module: nn.Module):
        for child in module.children():
            if isinstance(child, nn.ModuleList):
                for item in child:
                    if isinstance(item, (nn.ModuleList, nn.ModuleDict)):
                        visit(item)
                    elif any(True for _ in item.parameters()):
                        units.append(item)
            else:
                visit(child)

    visit(model)
    return units


def _drop_weight_cache(module, args):
    from lam_slide_tpu_torch.ops import fused_spatial_block

    fused_spatial_block.clear_weight_cache()


def shard_model(model: nn.Module, mesh) -> nn.Module:
    """``fully_shard`` each block of ``model`` and then the root over the
    mesh's ``data`` axis, in place; returns the model."""
    from torch.distributed.fsdp import fully_shard

    # the DiT layers return a chunk of their modulation (a view) as the next
    # layer's gate; nothing writes it in place, which is what FSDP2 warns of
    warnings.filterwarnings("ignore", message="FSDP2-wrapped module .* returned a view tensor")
    data_mesh = mesh["data"]
    units = block_units(model)
    for unit in units:
        fully_shard(unit, mesh=data_mesh)
    fully_shard(model, mesh=data_mesh)
    for unit in (*units, model):
        unit.register_forward_pre_hook(_drop_weight_cache)
    return model


def is_sharded(t) -> bool:
    from torch.distributed.tensor import DTensor, Shard

    return isinstance(t, DTensor) and any(isinstance(p, Shard) for p in t.placements)


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (writes go to the DTensor), else ``t``."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def like(param: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """``full`` (a whole tensor, the same on every rank) laid out like
    ``param``: a DTensor with param's mesh and placements, or ``full``."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if not isinstance(param, DTensor):
        return full
    return distribute_tensor(full.to(param.device), param.device_mesh, param.placements)


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor (a collective: every rank calls it),
    else ``t``."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def shard_train_state_fsdp(state, mesh):
    """Shard a ``TrainState``'s model with ``shard_model``, then lay its EMA
    and AdamW moments out like the parameters (built or restored whole
    before, as JAX lays out a restored state); the constants stay whole.
    Returns the state."""
    shard_model(state.model, mesh)
    params = state.params
    if state.ema_params is not None:
        state.ema_params = {k: like(params[k], v) for k, v in state.ema_params.items()}
    opt = state.opt_state
    opt.mu = {k: like(params[k], v) for k, v in opt.mu.items()}
    opt.nu = {k: like(params[k], v) for k, v in opt.nu.items()}
    return state


def sharded_share(model: nn.Module, data_size: int) -> Dict[str, float]:
    """{"sharded_bytes", "total_bytes", "share", "jax_rule_share"}: the
    parameter bytes FSDP2 shards over ``data`` (of all of them) and the
    share JAX's ``fsdp_spec`` shards at the same data size."""
    total = sharded = jax_rule = 0
    for p in model.parameters():
        nbytes = p.numel() * p.element_size()
        total += nbytes
        sharded += nbytes * is_sharded(p)
        jax_rule += nbytes * bool(fsdp_spec(tuple(p.shape), data_size))
    return {"sharded_bytes": sharded, "total_bytes": total, "share": sharded / max(total, 1),
            "jax_rule_share": jax_rule / max(total, 1)}


def uses_fsdp(model) -> bool:
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


def reshard(model: nn.Module) -> None:
    """Put every unit of an FSDP2 model back to its sharded parameters (a
    forward without a backward leaves the root's gathered), so
    ``named_parameters()`` gives the DTensor shards the optimizer, the EMA
    and the checkpoints work on."""
    from torch.distributed.fsdp import FSDPModule

    for m in model.modules():
        if isinstance(m, FSDPModule):
            m.reshard()
