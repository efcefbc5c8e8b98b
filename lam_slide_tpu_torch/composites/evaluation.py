"""Trajectory-forecasting evaluation (counterpart of
``lam_slide_tpu/composites/evaluation.py``).

The mean-over-K ADE/FDE of the GeoTDM protocol (MD17, K=5,
second_stage/md17.py:139-179) and the min-over-K ADE/FDE of the pedestrian
(K=20) and NBA (K=60) protocols (second_stage/pedestrian.py:149-239), with
the optional final-position clustering (FPC); all masked so the static
entity padding never enters the metric. And the test-time leak guard that
zeroes the target frames, with its check.
"""

from typing import Dict, Optional, Sequence, Tuple

import torch

from lam_slide_tpu_torch.nn.losses import safe_norm
from lam_slide_tpu_torch.parallel.rows import mask_denominator


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


def assert_no_target_leak(batch: Dict[str, torch.Tensor], cond_end: int,
                          keys: Sequence[str] = ("pos", "atom")) -> None:
    """Raise if a target frame of ``keys`` is nonzero (a conditioning leak)."""
    for k in keys:
        if k in batch and float(torch.as_tensor(batch[k])[:, cond_end:].abs().sum()) != 0.0:
            raise AssertionError(f"target frames of {k!r} are nonzero — conditioning leak")


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


def min_over_k_ade_fde(pred_pos_k: torch.Tensor, true_pos: torch.Tensor,
                       mask: Optional[torch.Tensor] = None):
    """Best-of-K at the scene level: the min over K of the per-sample
    ADE/FDE; pred_pos_k [K, B, Tp, N, D] -> (ade [B], fde [B])."""
    ade_k, fde_k = masked_ade_fde(pred_pos_k, true_pos, mask)
    return ade_k.min(dim=0).values, fde_k.min(dim=0).values


def per_entity_min_k_ade_fde(pred_pos_k: torch.Tensor, true_pos: torch.Tensor,
                             entity_mask: torch.Tensor, num_runs: Optional[int] = None,
                             fpc: bool = False, kmeans_iters: int = 20):
    """Pedestrian/NBA test protocol (second_stage/pedestrian.py:148-226).

    Each entity trajectory is scored on its own: the min over samples of its
    ADE and, independently, of its FDE. Without FPC the first ``num_runs``
    of the K samples count; with FPC the K final positions are clustered
    into ``num_runs`` k-means clusters and, per cluster, the sample nearest
    the centre counts (SocialVAE's FPC).

    pred_pos_k [K, B, Tp, N, D], true_pos [B, Tp, N, D], entity_mask [B, N]
    -> (ade, fde): masked means over all real entities (0-d tensors).
    """
    from lam_slide_tpu_torch.ops.kmeans import batched_kmeans

    k, b, tp, n, d = pred_pos_k.shape
    num_runs = num_runs or k
    pred = pred_pos_k.permute(1, 3, 0, 2, 4).reshape(b * n, k, tp, d)  # [B*N, K, Tp, D]
    true = true_pos.permute(0, 2, 1, 3).reshape(b * n, 1, tp, d)
    err = safe_norm(pred - true, dim=-1)  # [B*N, K, Tp]
    ade_k, fde_k = err.mean(dim=-1), err[..., -1]
    if fpc:
        finals = pred[:, :, -1]  # [B*N, K, D]
        centers, _ = batched_kmeans(finals, num_runs, kmeans_iters)
        dis = torch.linalg.vector_norm(finals[:, :, None] - centers[:, None], dim=-1)
        sel = dis.argmin(dim=1)  # [B*N, C]: the sample nearest each centre
        ade_sel, fde_sel = ade_k.gather(1, sel), fde_k.gather(1, sel)
    else:
        ade_sel, fde_sel = ade_k[:, :num_runs], fde_k[:, :num_runs]
    m = entity_mask.reshape(b * n).to(ade_k.dtype)
    denom = mask_denominator(m.sum())
    return ((ade_sel.min(dim=1).values * m).sum() / denom,
            (fde_sel.min(dim=1).values * m).sum() / denom)
