"""Masked losses as pure functions (counterpart of ``lam_slide_tpu/nn/losses.py``,
reference src/modules/losses.py).

All losses take explicit boolean/float masks and normalize by mask mass;
``safe_norm`` keeps a zero gradient at the origin, as torch.norm does.
"""

from typing import Optional

import torch

from lam_slide_tpu_torch.parallel.rows import mask_denominator


def _mask_mean(per_item: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    mask = mask.to(per_item.dtype)
    return (per_item * mask).sum() / mask_denominator(mask.sum())


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """MSE averaged over the feature axis, masked over items (losses.py:5-13)."""
    return _mask_mean((pred - target).square().mean(dim=-1), mask)


def masked_l1(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return _mask_mean((pred - target).abs().mean(dim=-1), mask)


def masked_huber(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                 delta: float = 1.0) -> torch.Tensor:
    diff = (pred - target).abs()
    per_elem = torch.where(diff <= delta, 0.5 * diff * diff, delta * (diff - 0.5 * delta))
    return _mask_mean(per_elem.mean(dim=-1), mask)


def masked_norm(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean Euclidean error over valid items (losses.py:27-34)."""
    return _mask_mean(safe_norm(pred - target, dim=-1), mask)


def masked_cross_entropy(logits: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                         label_smoothing: float = 0.0) -> torch.Tensor:
    """CE over integer targets, masked (losses.py:62-72)."""
    n_classes = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    onehot = torch.nn.functional.one_hot(target.long(), n_classes).to(logp.dtype)
    if label_smoothing > 0:
        onehot = onehot * (1.0 - label_smoothing) + label_smoothing / n_classes
    return _mask_mean(-(onehot * logp).sum(dim=-1), mask)


def masked_cosine(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """1 - cosine similarity, masked (losses.py:75-82)."""
    pn = pred / torch.clamp(safe_norm(pred, dim=-1, keepdim=True), min=1e-8)
    tn = target / torch.clamp(safe_norm(target, dim=-1, keepdim=True), min=1e-8)
    return _mask_mean(1.0 - (pn * tn).sum(dim=-1), mask)


def masked_cosine_v2(pred: torch.Tensor, target: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """1 - <pred, target> for already-normalized vectors (losses.py:85-92)."""
    return _mask_mean(1.0 - (pred * target).sum(dim=-1), mask)


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False,
              eps: float = 0.0) -> torch.Tensor:
    """L2 norm with a well-defined zero gradient at x == 0 (double where)."""
    sq = x.square().sum(dim=dim, keepdim=keepdim)
    safe = torch.where(sq > 0, sq, torch.ones_like(sq))
    return torch.where(sq > 0, torch.sqrt(safe + eps), torch.zeros_like(sq))


def cdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise Euclidean distances [..., N, M] with NaN-free gradients."""
    return safe_norm(a[..., :, None, :] - b[..., None, :, :], dim=-1)


def _pair_mask(mask: torch.Tensor) -> torch.Tensor:
    return (mask[..., :, None] * mask[..., None, :]).float()


def inter_distance(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Squared error between pairwise-distance matrices (losses.py:126-134).

    pred/target: [B, S, D], mask: [B, S] -> loss over valid (i, j) pairs.
    """
    pair_mask = _pair_mask(mask)
    diff = (cdist(pred, pred) - cdist(target, target)) * pair_mask
    return diff.square().sum() / mask_denominator(pair_mask.sum())


def inter_distance_huber(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                         delta: float = 1.0) -> torch.Tensor:
    """Huber variant of inter_distance (losses.py:37-48)."""
    pair_mask = _pair_mask(mask)
    diff = (cdist(pred, pred) - cdist(target, target)).abs()
    per_pair = torch.where(diff <= delta, 0.5 * diff * diff, delta * (diff - 0.5 * delta))
    return (per_pair * pair_mask).sum() / mask_denominator(pair_mask.sum())


def inter_distance_relative(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                            relative: bool = True) -> torch.Tensor:
    """|Δdist| (optionally relative) variant (losses.py:156-175)."""
    pair_mask = _pair_mask(mask)
    dt = cdist(target, target)
    diff = (cdist(pred, pred) - dt).abs()
    if relative:
        diff = diff / (dt + 1e-8)
    return (diff * pair_mask).sum() / mask_denominator(pair_mask.sum())


def similarity(pred: torch.Tensor, mask: torch.Tensor, sigma: float = 0.01) -> torch.Tensor:
    """RBF self-similarity repulsion over upper-triangular pairs (losses.py:112-123)."""
    s = pred.shape[-2]
    triu = torch.triu(torch.ones((s, s), dtype=torch.float32, device=pred.device), diagonal=1)
    pair_mask = _pair_mask(mask) * triu
    sim = torch.exp(-cdist(pred, pred).square() / (2.0 * sigma ** 2)) * pair_mask
    return sim.sum() / mask_denominator(mask.float().sum())


def masked_cosine_v3(pred: torch.Tensor, target: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Clamped squared-difference variant (reference MaskedCosineLossV3,
    losses.py:95-109 — despite the name it is an MSE with |diff| clamped)."""
    diff = torch.clamp((pred - target).abs(), min=1e-3)
    return _mask_mean((diff ** 2).sum(dim=-1), mask)


def inter_distance_signed(pred: torch.Tensor, target: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """Signed (non-squared) pairwise-distance difference (InterDistanceLoss2)."""
    pair_mask = _pair_mask(mask)
    diff = (cdist(pred, pred) - cdist(target, target)) * pair_mask
    return diff.sum() / mask_denominator(pair_mask.sum())


def inter_distance_adjacent(pred: torch.Tensor, target: torch.Tensor,
                            adj_matrix: torch.Tensor) -> torch.Tensor:
    """Squared distance error over an explicit adjacency (bond) matrix
    (InterDistanceLossAdjacent)."""
    adj = adj_matrix.float()
    diff = (cdist(pred, pred) - cdist(target, target)) * adj
    return (diff ** 2).sum() / mask_denominator(adj.sum())


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch axes (transport/utils.py mean_flat)."""
    return x.mean(dim=tuple(range(1, x.dim())))


def cross_entropy(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Unmasked mean CE (torch.nn.CrossEntropyLoss default reduction)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, target.long()[..., None])[..., 0].mean()


def ade_fde(pred: torch.Tensor, target: torch.Tensor, mask: Optional[torch.Tensor] = None):
    """Average / final displacement error over predicted frames.

    pred/target: [B, T, N, D]; mask: [B, T, N] (optional). Returns per-sample
    (ade[B], fde[B]) matching second_stage/md17.py:163-164 semantics.
    """
    err = safe_norm(pred - target, dim=-1)  # [B, T, N]
    if mask is None:
        return err.mean(dim=(1, 2)), err[:, -1].mean(dim=1)
    m = mask.to(err.dtype)
    ade = (err * m).sum(dim=(1, 2)) / torch.clamp(m.sum(dim=(1, 2)), min=1.0)
    fde = (err[:, -1] * m[:, -1]).sum(dim=1) / torch.clamp(m[:, -1].sum(dim=1), min=1.0)
    return ade, fde
