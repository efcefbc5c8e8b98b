"""Trajectory-forecasting evaluation (counterpart of
``lam_slide_tpu/composites/evaluation.py``; the MD17 subset).

The mean-over-K ADE/FDE of the GeoTDM protocol (second_stage/md17.py:139-179),
masked so the static entity padding never enters the metric, and the
test-time leak guard that zeroes the target frames.
"""

from typing import Dict, Optional, Sequence, Tuple

import torch

from lam_slide_tpu_torch.nn.losses import safe_norm


def zero_target_frames(batch: Dict[str, torch.Tensor], cond_end: int,
                       keys: Sequence[str] = ("pos", "atom")) -> Dict[str, torch.Tensor]:
    """Test-protocol leak guard (second_stage/md17.py:148-156): target frames
    are zeroed before sampling so conditioning cannot peek at them."""
    out = dict(batch)
    for k in keys:
        if k in out:
            out[k] = out[k].clone()
            out[k][:, cond_end:] = 0
    return out


def masked_ade_fde(pred_pos: torch.Tensor, true_pos: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample ADE/FDE over prediction frames: pred_pos/true_pos
    [..., B, Tp, N, D], mask [B, Tp, N] -> (ade, fde) of shape [..., B].
    ADE = mean_t,n ||Δ||; FDE = mean_n ||Δ_T|| (second_stage/md17.py:163-164)."""
    err = safe_norm(pred_pos - true_pos, dim=-1)
    if mask is None:
        return err.mean(dim=(-2, -1)), err[..., -1, :].mean(dim=-1)
    m = mask.to(err.dtype)
    ade = (err * m).sum(dim=(-2, -1)) / torch.clamp(m.sum(dim=(-2, -1)), min=1.0)
    fde = (err[..., -1, :] * m[..., -1, :]).sum(dim=-1) / torch.clamp(m[..., -1, :].sum(dim=-1),
                                                                      min=1.0)
    return ade, fde


def mean_over_k_ade_fde(pred_pos_k: torch.Tensor, true_pos: torch.Tensor,
                        mask: Optional[torch.Tensor] = None):
    """MD17 protocol: the mean over K of the per-repeat ADE/FDE;
    pred_pos_k [K, B, Tp, N, D] -> (ade [B], fde [B])."""
    ade_k, fde_k = masked_ade_fde(pred_pos_k, true_pos, mask)
    return ade_k.mean(dim=0), fde_k.mean(dim=0)
