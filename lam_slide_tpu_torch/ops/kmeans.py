"""Batched k-means (Lloyd's algorithm), counterpart of
``lam_slide_tpu/ops/kmeans.py``.

The final-position clustering (FPC) of the pedestrian and NBA test
protocols (reference second_stage/pedestrian.py:190-226, which used
torch_kmeans): farthest-point initialisation (the first centre is point 0,
each next one the point farthest from the centres set so far; no draws),
then a fixed number of Lloyd iterations in which an empty cluster keeps its
centre (the guarded mean). Plain torch over whole sets at once by
broadcasting: a post-processing step on ``[sets, K, 2]`` points, which the
JAX package runs as jitted XLA, not as a Pallas kernel. Ties go to the
first index, as ``jnp.argmin`` / ``jnp.argmax`` do.
"""

from typing import Tuple

import torch


def _distances(points: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """points [B, N, D], centers [B, C, D] -> Euclidean distances [B, N, C]."""
    return torch.linalg.vector_norm(points[:, :, None] - centers[:, None], dim=-1)


def _init_centers(points: torch.Tensor, n_clusters: int) -> torch.Tensor:
    """Farthest-point initialisation: points [B, N, D] -> centers [B, C, D]."""
    b = points.shape[0]
    rows = torch.arange(b, device=points.device)
    centers = torch.zeros((b, n_clusters, points.shape[-1]), dtype=points.dtype,
                          device=points.device)
    centers[:, 0] = points[:, 0]
    unset = torch.arange(n_clusters, device=points.device)
    for n_set in range(1, n_clusters):
        fill = torch.where(unset < n_set, 0.0, float("inf")).to(points.dtype)
        d = (_distances(points, centers) + fill).amin(dim=-1)  # [B, N]
        centers[:, n_set] = points[rows, d.argmax(dim=-1)]
    return centers


def batched_kmeans(points: torch.Tensor, n_clusters: int,
                   n_iters: int = 20) -> Tuple[torch.Tensor, torch.Tensor]:
    """points [B, N, D] -> (centers [B, C, D], assignment [B, N])."""
    centers = _init_centers(points, n_clusters)
    for _ in range(n_iters):
        assign = _distances(points, centers).argmin(dim=-1)  # [B, N]
        onehot = torch.nn.functional.one_hot(assign, n_clusters).to(points.dtype)  # [B, N, C]
        counts = onehot.sum(dim=1)[..., None]  # [B, C, 1]
        sums = onehot.transpose(1, 2) @ points  # [B, C, D]
        centers = torch.where(counts > 0, sums / counts.clamp_min(1.0), centers)
    return centers, _distances(points, centers).argmin(dim=-1)


def kmeans(points: torch.Tensor, n_clusters: int,
           n_iters: int = 20) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-set k-means: points [N, D] -> (centers [C, D], assignment [N])."""
    centers, assign = batched_kmeans(points[None], n_clusters, n_iters)
    return centers[0], assign[0]
