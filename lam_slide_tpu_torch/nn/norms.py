"""Normalizations (counterpart of ``lam_slide_tpu/nn/norms.py``).

Statistics in float32, output cast back to the input dtype, as in the
reference (torch_modules.py:84-105, mmdit.py:127-148).
"""

import torch


def rms_normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Scale-free RMS normalization computed in fp32, cast back to x.dtype."""
    x32 = x.float()
    rrms = torch.reciprocal(torch.sqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps))
    return (x32 * rrms).to(x.dtype)


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Non-affine LayerNorm in fp32 (reference: nn.LayerNorm(elementwise_affine=False))."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return ((x32 - mean) * torch.reciprocal(torch.sqrt(var + eps))).to(x.dtype)


class RMSNorm(torch.nn.Module):
    """Holds the learned ``scale`` of an RMSNorm (reference mmdit.py:127-136).

    The DiT applies it per head with ``ops.packed_attention.headmajor_rmsnorm``.
    """

    def __init__(self, dim: int):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.ones(dim))


class QKNorm(torch.nn.Module):
    """Holds the ``query_norm.scale`` / ``key_norm.scale`` parameters of the
    reference QKNorm (mmdit.py:139-148), so state_dict keys match."""

    def __init__(self, dim: int):
        super().__init__()
        self.query_norm = RMSNorm(dim)
        self.key_norm = RMSNorm(dim)


class LayerNorm(torch.nn.Module):
    """Affine LayerNorm (torch ``nn.LayerNorm`` keys ``weight``/``bias``):
    fp32 statistics, normalized value rounded to x.dtype, then the affine in
    x.dtype (JAX ``nn/norms.py:53``)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = torch.nn.Parameter(torch.ones(dim))
        self.bias = torch.nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = layer_norm(x, self.eps)
        return out * self.weight.to(out.dtype) + self.bias.to(out.dtype)
