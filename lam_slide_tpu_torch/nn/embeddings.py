"""Embeddings (counterpart of ``lam_slide_tpu/nn/embeddings.py``; main-path subset)."""

import math

import torch


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10_000.0,
                       time_factor: float = 1000.0) -> torch.Tensor:
    """Sinusoidal diffusion-time embedding (reference mmdit.py:93-113).

    t: [B] fractional timesteps in [0, 1]; returns [B, dim] = [cos | sin], fp32.
    """
    t = time_factor * t.float()
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb
