"""Fresh-init helpers (counterpart of ``lam_slide_tpu/nn/initializers.py``).

Each initializer fills a tensor in place from an explicit ``torch.Generator``
and returns it. Weights are in torch ``nn.Linear`` layout ``[out, in]``;
the distributions match the flax initializers (xavier is symmetric in
fan_in/fan_out). The two frameworks draw different numbers from the same
seed, so parity tests import weights instead of re-drawing them.
"""

import math

import torch


def _uniform_(w: torch.Tensor, limit: float, gen: torch.Generator) -> torch.Tensor:
    with torch.no_grad():
        vals = torch.rand(w.shape, generator=gen, dtype=torch.float32)
        w.copy_((vals * 2.0 - 1.0) * limit)
    return w


def xavier_uniform_(w: torch.Tensor, gen: torch.Generator, gain: float = 1.0) -> torch.Tensor:
    """torch.nn.init.xavier_uniform_: U(-a, a), a = gain*sqrt(6/(fan_in+fan_out))."""
    fan_out, fan_in = w.shape
    return _uniform_(w, gain * math.sqrt(6.0 / (fan_in + fan_out)), gen)


def attn_kernel_init_(w: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """xavier_uniform with gain 1/sqrt(2) (reference attention projections)."""
    return xavier_uniform_(w, gen, gain=1.0 / math.sqrt(2.0))


def torch_linear_init_(w: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """torch.nn.Linear default weight init: U(+-1/sqrt(fan_in)) (blocks.py:32)."""
    return _uniform_(w, 1.0 / math.sqrt(w.shape[1]), gen)


def normal_(w: torch.Tensor, gen: torch.Generator, std: float) -> torch.Tensor:
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=gen, dtype=torch.float32) * std)
    return w


def normal_002_(w: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """std=0.02 normals (reference time/vec embedders)."""
    return normal_(w, gen, 0.02)


def zeros_(w: torch.Tensor, gen: torch.Generator = None) -> torch.Tensor:
    with torch.no_grad():
        w.zero_()
    return w
