"""Tensor parallelism over the mesh's ``model`` axis (counterpart of
``lam_slide_tpu/parallel/tp.py``).

JAX states a column-parallel ``linear1`` and a row-parallel ``linear2`` as
PartitionSpecs (``dit_tp_spec``) and lets GSPMD cut the fused
``[q|k|v|mlp]`` columns contiguously and reshard them. The port lays the
blocks out the Megatron way, so that every rank runs the block's kernels
on whole heads: in each ``ParallelMLPAttention`` of H heads of width dh,
hidden width D and MLP width M, rank r of ``tp`` holds

* the q, k and v rows of heads ``[r H/tp, (r+1) H/tp)`` and the MLP rows
  ``[r M/tp, (r+1) M/tp)`` of ``linear1.weight`` and ``linear1.bias``, in
  that order (``[3 Da + Mr, D]`` with Da = D/tp, Mr = M/tp);
* the matching columns of ``linear2.weight`` (``[D, Da + Mr]``);

each a contiguous tensor of its own (K8 and TMA want them so), under
``<block>.shards.<i>.linear1.{weight,bias}`` and
``<block>.shards.<i>.linear2.weight``. ``linear2.bias``, the QK-norm
scales, the modulations, the embedders and the output layer stay whole on
every rank. A block whose H or M the model axis does not divide stays
whole and replicated, with no collective (the port's form of JAX's
fallback for a leaf that does not divide).

The block's forward (models/latent_dit.py): the input and the QK-norm
scales, whole on every rank, enter the shards through ``TPComm.enter``
(the identity; in the backward their grads summed over the model group,
each rank's shards giving back their heads' part), each shard computes its fp32 partial of linear2
without b2 and unrounded, ``TPComm.reduce`` adds the partials (one fp32
all-reduce over the model group), then one cast to the compute dtype and
``+ b2``: the rounding points of the unsharded block. A process holds one
shard a block over a process group (``over_group``), or all of them
(``in_process``: a card cannot host two NCCL ranks, so one process runs
tp 2-4 on one card and sums the partials itself).

``shard_train_state`` lays out a ``TrainState`` (parameters, EMA, AdamW
moments) after a build or a restore of whole tensors; ``gather_tree`` and
``gather_state_dict`` give the whole tensors back under the one-rank
names, which is what checkpoints hold, so a tensor-parallel run resumes
from a one-rank checkpoint and the other way round.
"""

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

# the parameters a block shards, by their name within the block
SHARDED = ("linear1.weight", "linear1.bias", "linear2.weight")


def dit_tp_spec(name: str, shape: Sequence[int], model_size: int, num_heads: int,
                hidden: int) -> tuple:
    """The layout of one parameter of a DiT (its name in
    ``named_parameters()``, the one-rank name) as a tuple like JAX's
    PartitionSpec: "model" on the dim split over the model axis, None
    elsewhere; () replicates. ``num_heads`` and ``hidden`` are the block's.
    Only a block's ``linear1`` (dim 0 of the weight and of the bias, the
    head-aligned rows) and ``linear2.weight`` (dim 1) are split, and only
    where ``model_size`` divides the heads and the MLP width."""
    if model_size <= 1 or not name.endswith(SHARDED):
        return ()
    parts = name.split(".")
    if len(parts) < 3 or parts[-3] not in ("spatial_block", "temporal_block"):
        return ()
    if name.endswith("linear1.weight") or name.endswith("linear1.bias"):
        mlp = shape[0] - 3 * hidden
    else:
        mlp = shape[1] - hidden
    if mlp <= 0 or not divides(num_heads, mlp, model_size):
        return ()
    if name.endswith("linear2.weight"):
        return (None, "model")
    return ("model",) + (None,) * (len(shape) - 1)


def divides(num_heads: int, mlp: int, model_size: int) -> bool:
    """Whether a block of ``num_heads`` heads and MLP width ``mlp`` splits
    over ``model_size`` ranks (else it stays whole on every rank)."""
    return model_size > 1 and num_heads % model_size == 0 and mlp % model_size == 0


# ---------------------------------------------------------------------------
# the head-aligned slices
# ---------------------------------------------------------------------------


def slice_linear1(t: torch.Tensor, d: int, m: int, tp: int, r: int) -> torch.Tensor:
    """Rank r's rows of linear1's weight ``[3D+M, D]`` or bias ``[3D+M]``:
    its heads' q, k and v rows, then its MLP rows (a new contiguous tensor)."""
    da, mr = d // tp, m // tp
    parts = [t[p * d + r * da:p * d + (r + 1) * da] for p in range(3)]
    return torch.cat(parts + [t[3 * d + r * mr:3 * d + (r + 1) * mr]]).contiguous()


def slice_linear2(t: torch.Tensor, d: int, m: int, tp: int, r: int) -> torch.Tensor:
    """Rank r's columns of linear2's weight ``[D, D+M]``: its heads' attention
    columns, then its MLP columns."""
    da, mr = d // tp, m // tp
    return torch.cat([t[:, r * da:(r + 1) * da], t[:, d + r * mr:d + (r + 1) * mr]],
                     dim=1).contiguous()


def join_linear1(shards: Sequence[torch.Tensor], d: int) -> torch.Tensor:
    """The whole linear1 weight or bias from the ranks' slices, in rank order."""
    da = d // len(shards)
    parts = [s[p * da:(p + 1) * da] for p in range(3) for s in shards]
    return torch.cat(parts + [s[3 * da:] for s in shards])


def join_linear2(shards: Sequence[torch.Tensor], d: int) -> torch.Tensor:
    """The whole linear2 weight from the ranks' slices, in rank order."""
    da = d // len(shards)
    return torch.cat([s[:, :da] for s in shards] + [s[:, da:] for s in shards], dim=1)


SLICE = {"linear1.weight": slice_linear1, "linear1.bias": slice_linear1,
         "linear2.weight": slice_linear2}


def _join(suffix: str, shards: Sequence[torch.Tensor], d: int) -> torch.Tensor:
    return (join_linear2 if suffix == "linear2.weight" else join_linear1)(shards, d)


# ---------------------------------------------------------------------------
# the model group's two collectives
# ---------------------------------------------------------------------------


class _Enter(torch.autograd.Function):
    """The block input: the identity forward; the input grad summed over the
    model group backward (each rank's shard contributes its own part)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    """The block output: the ranks' fp32 partials summed over the model
    group forward; the identity backward (every rank goes on with the same
    sum, so each partial's grad is the sum's)."""

    @staticmethod
    def forward(ctx, partial, group):
        out = partial.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class TPComm:
    """How a block's shards meet: ``size`` ranks, of which this process
    holds those in ``ranks``; ``group`` the model group (None in process)."""

    def __init__(self, size: int, ranks: Sequence[int], group=None):
        self.size, self.ranks, self.group = size, tuple(ranks), group

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.group is None else _Enter.apply(x, self.group)

    def reduce(self, partials: List[torch.Tensor]) -> torch.Tensor:
        """The sum of all ranks' partials, from this process's."""
        if self.group is None:
            out = partials[0]
            for p in partials[1:]:
                out = out + p
            return out
        (partial,) = partials
        return _Reduce.apply(partial, self.group)


def in_process(size: int) -> TPComm:
    """All ``size`` shards of every block in this process."""
    return TPComm(size, range(size))


def over_group(mesh) -> TPComm:
    """This rank's shard of every block, over the mesh's model group."""
    from lam_slide_tpu_torch.parallel.mesh import model_group, model_rank, model_size

    return TPComm(model_size(mesh), (model_rank(mesh),), model_group(mesh))


# ---------------------------------------------------------------------------
# sharding a model and its trees
# ---------------------------------------------------------------------------


class _Linear(nn.Module):
    """A shard's weight (and bias) in nn.Linear layout."""

    def __init__(self, weight: Optional[torch.Tensor], bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.weight = None if weight is None else nn.Parameter(weight)
        self.bias = None if bias is None else nn.Parameter(bias)


class Shard(nn.Module):
    """A rank's slice of a block: ``linear1`` (weight, bias) and ``linear2``
    (weight)."""

    def __init__(self, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor):
        super().__init__()
        self.linear1 = _Linear(w1, b1)
        self.linear2 = _Linear(w2)


def tp_blocks(model: nn.Module) -> List[Tuple[str, nn.Module]]:
    """(name, module) of every ParallelMLPAttention of ``model``."""
    from lam_slide_tpu_torch.models.latent_dit import ParallelMLPAttention

    return [(n, m) for n, m in model.named_modules() if isinstance(m, ParallelMLPAttention)]


def _prefix(name: str) -> str:
    return f"{name}." if name else ""


def shard_model(model: nn.Module, comm: TPComm) -> nn.Module:
    """Split every block of ``model`` whose heads and MLP width ``comm.size``
    divides, in place: its whole ``linear1`` and ``linear2.weight`` give way
    to the shards of ``comm.ranks``. Returns the model."""
    with torch.no_grad():
        for _, block in tp_blocks(model):
            if block.tp is not None:
                raise ValueError("shard_model: the model is sharded already")
            d, m = block.hidden_size, block.mlp_hidden
            if not divides(block.num_heads, m, comm.size):
                continue
            w1, b1 = block.linear1.weight, block.linear1.bias
            w2 = block.linear2.weight
            tp = comm.size
            block.shards = nn.ModuleList(
                Shard(slice_linear1(w1, d, m, tp, r), slice_linear1(b1, d, m, tp, r),
                      slice_linear2(w2, d, m, tp, r))
                for r in comm.ranks)
            del block.linear1
            block.linear2 = _Linear(None, block.linear2.bias)  # b2 stays whole
            block.tp = comm
    return model


def _sharded_blocks(model: nn.Module):
    return [(_prefix(n), b) for n, b in tp_blocks(model) if b.tp is not None]


def shard_tree(model: nn.Module, tree: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A tree of whole tensors under the one-rank names (parameters, their
    EMA or AdamW moments) laid out like ``model``'s sharded parameters."""
    out = dict(tree)
    for pre, block in _sharded_blocks(model):
        d, m, comm = block.hidden_size, block.mlp_hidden, block.tp
        for suffix, cut in SLICE.items():
            whole = out.pop(pre + suffix)
            for i, r in enumerate(comm.ranks):
                out[f"{pre}shards.{i}.{suffix}"] = cut(whole, d, m, comm.size, r)
    return out


def gather_tree(model: nn.Module, tree: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The whole tensors, under the one-rank names, of a tree laid out like
    ``model``'s sharded parameters (its parameters, EMA, AdamW moments or
    state dict). Over a process group every rank of the model group must
    call it (an all-gather a sharded tensor)."""
    out = dict(tree)
    for pre, block in _sharded_blocks(model):
        comm = block.tp
        for suffix in SHARDED:
            local = [out.pop(f"{pre}shards.{i}.{suffix}") for i in range(len(comm.ranks))]
            if comm.group is not None:
                (mine,) = local
                local = [torch.empty_like(mine) for _ in range(comm.size)]
                dist.all_gather(local, mine.detach().contiguous(), group=comm.group)
            out[pre + suffix] = _join(suffix, local, block.hidden_size)
    return out


def gather_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with its sharded blocks whole: the one-rank
    state dict."""
    return gather_tree(model, model.state_dict())


def sharded_names(model: nn.Module) -> Tuple[set, Optional[object]]:
    """(the names of the parameters that are shards, the model group they
    are spread over, or None where this process holds every shard)."""
    names, group = set(), None
    for pre, block in _sharded_blocks(model):
        group = block.tp.group
        names.update(f"{pre}shards.{i}.{s}" for i in range(len(block.tp.ranks))
                     for s in SHARDED)
    return names, group


def global_param_count(model: nn.Module) -> int:
    """The parameters of the whole model: those of the one-rank model,
    whatever this process holds of the shards."""
    total = 0
    sharded, group = sharded_names(model)
    for name, p in model.named_parameters():
        size = int(p.numel())
        if name in sharded and group is not None:
            size *= dist.get_world_size(group)
        total += size
    return total


def shard_train_state(state, mesh=None, size: Optional[int] = None):
    """Lay a ``TrainState`` of whole tensors out for tensor parallelism, in
    place: over ``mesh``'s model group (this rank's shards), or with
    ``size`` shards of every block in this process. The EMA and the AdamW
    moments take their parameters' layout; the constants and the step stay.
    Returns the state."""
    if (mesh is None) == (size is None):
        raise ValueError("shard_train_state: pass a mesh or a size")
    comm = over_group(mesh) if mesh is not None else in_process(size)
    if comm.size <= 1:
        return state
    shard_model(state.model, comm)
    if state.ema_params is not None:
        state.ema_params = shard_tree(state.model, state.ema_params)
    opt = state.opt_state
    opt.mu = shard_tree(state.model, opt.mu)
    opt.nu = shard_tree(state.model, opt.nu)
    return state
