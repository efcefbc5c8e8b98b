"""Dense layers as flax ``nn.Dense`` computes them: ``torch.nn.Linear``
parameters (``[out, in]`` weights, the reference's state_dict layout), cast
to the compute dtype at each use."""

import torch
from torch import nn

from lam_slide_tpu_torch.nn import initializers as inits


def dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)``: x @ W in dtype, then + bias in dtype."""
    out = torch.matmul(x.to(dtype), lin.weight.to(dtype).t())
    return out if lin.bias is None else out + lin.bias.to(dtype)


def linear(d_in: int, d_out: int, init, gen: torch.Generator, bias: bool = True) -> nn.Linear:
    """nn.Linear with the given weight init and zero bias (flax Dense
    defaults), drawn from ``gen`` and not from the global RNG."""
    lin = nn.utils.skip_init(nn.Linear, d_in, d_out, bias=bias)
    init(lin.weight, gen)
    if bias:
        inits.zeros_(lin.bias)
    return lin
