"""This rank's rows of a data-parallel global batch, and the two things a
rank must do for its step to equal the one-rank step on the whole batch.

JAX runs one program over the global batch and GSPMD partitions it, so its
random draws have the global batch's shape and its masked means divide by
the global mask mass. Here each rank runs the loss on its own rows. Inside
``use_rows(rows)``:

* ``randn`` / ``rand`` / ``randint`` draw the global batch's shape from the
  (same-seeded) generator and keep this rank's rows, so every rank draws
  what a one-rank step draws for them (t, x0, the dropout masks) and the
  generators of all ranks stay in step;
* ``batch_mean`` takes a mean over the global batch (dopri5's error
  norm, so every rank takes the same steps);
* ``mask_denominator(count)`` all-reduces a masked mean's mask mass over
  the data group and returns clamp(global, 1) / P, so that the mean over
  the P ranks of their local terms (what the data-parallel step takes, as
  it averages the grads) is the global masked mean, whatever the ranks'
  valid counts.

The two reductions run over ``rows.group`` even when it holds one rank, so
a one-rank group runs the code a larger one runs. Outside the context every
function is its plain torch form.
"""

import contextlib
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Rows:
    """Rows ``[offset, offset + count)`` of a global batch of ``total`` rows,
    spread in equal contiguous slices over the ``size`` ranks of ``group``."""

    offset: int
    count: int
    total: int
    group: Optional[object] = None
    size: int = 1


_active: Optional[Rows] = None


@contextlib.contextmanager
def use_rows(rows: Optional[Rows]):
    """Draws and masked means inside the block follow ``rows`` (None: the
    batch is whole on this rank)."""
    global _active
    prev, _active = _active, rows
    try:
        yield
    finally:
        _active = prev


def active() -> Optional[Rows]:
    return _active


def _draw(fn, shape: Sequence[int], batch_dim: int, **kw) -> torch.Tensor:
    rows = _active
    shape = list(shape)
    if rows is None or rows.total == rows.count:
        return fn(shape, **kw)
    n = shape[batch_dim]
    if n % rows.count:
        raise ValueError(f"a draw of shape {tuple(shape)} has {n} rows on axis {batch_dim}, "
                         f"not a multiple of this rank's {rows.count} batch rows")
    per = n // rows.count
    shape[batch_dim] = per * rows.total
    out = fn(shape, **kw).narrow(batch_dim, rows.offset * per, n)
    return out if batch_dim == 0 else out.contiguous()


def randn(shape: Sequence[int], generator: Optional[torch.Generator], batch_dim: int = 0,
          **kw) -> torch.Tensor:
    """``torch.randn(shape, generator=generator, **kw)``; under ``use_rows``
    this rank's rows (axis ``batch_dim``, batch-major) of the global draw."""
    return _draw(lambda s, **k: torch.randn(s, generator=generator, **k), shape, batch_dim, **kw)


def rand(shape: Sequence[int], generator: Optional[torch.Generator], batch_dim: int = 0,
         **kw) -> torch.Tensor:
    """``torch.rand``, as ``randn``."""
    return _draw(lambda s, **k: torch.rand(s, generator=generator, **k), shape, batch_dim, **kw)


def randint(low: int, high: int, shape: Sequence[int], generator: Optional[torch.Generator],
            batch_dim: int = 0, **kw) -> torch.Tensor:
    """``torch.randint``, as ``randn``."""
    return _draw(lambda s, **k: torch.randint(low, high, s, generator=generator, **k), shape,
                 batch_dim, **kw)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """A detached copy of ``t`` summed over ``group`` (no autograd)."""
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def batch_mean(t: torch.Tensor) -> torch.Tensor:
    """``t.mean()`` over a tensor with this rank's rows; under ``use_rows``
    over a sharded batch, the mean over the global batch (an all-reduce),
    the same on every rank: dopri5's error norm, so every rank takes the
    steps a one-rank solve of the whole batch takes."""
    rows = _active
    if rows is None or rows.group is None:
        return t.mean()
    return all_reduce_sum(t.sum(), rows.group) / (t.numel() * rows.size)


def mask_denominator(count: torch.Tensor) -> torch.Tensor:
    """clamp(count, 1) for a masked mean's mask mass ``count``; under
    ``use_rows`` over a sharded batch, clamp(sum of the ranks' counts, 1) / P."""
    rows = _active
    if rows is None or rows.group is None:
        return torch.clamp(count, min=1.0)
    return torch.clamp(all_reduce_sum(count, rows.group), min=1.0) / rows.size
