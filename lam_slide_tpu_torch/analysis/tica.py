"""Time-lagged independent component analysis (TICA) + Koopman reweighting.

Numpy/scipy reimplementation of the two TICA surfaces the reference uses:

* ``pyemma.coordinates.tica(traj, lag, kinetic_map=True)``
  (src/modules/analysis.py:37-40) — symmetrized (reversible) covariance
  estimation, generalized eigenproblem, kinetic-map scaling of the
  projection by the eigenvalues.
* deeptime TICA fit with a ``KoopmanWeightingEstimator`` model
  (src/utils/tica_utils.py:42-48) — equilibrium reweighting for
  off-equilibrium data via the Koopman operator (Wu & Noé, J. Nonlinear
  Sci. 2020): weights w(x) = uᵀ·(x̃, 1) with u the Koopman-matrix
  eigenvector at eigenvalue 1 in whitened coordinates.
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np
import scipy.linalg


def _sym_inv_sqrt(c: np.ndarray, eps: float = 1e-10) -> np.ndarray:
    """C^{-1/2} for symmetric PSD C via eigen-decomposition with truncation."""
    w, v = np.linalg.eigh(c)
    keep = w > eps * w.max()
    return v[:, keep] @ np.diag(w[keep] ** -0.5) @ v[:, keep].T


def koopman_weights(x: np.ndarray, lag: int, eps: float = 1e-10) -> np.ndarray:
    """Per-frame equilibrium reweighting factors from the Koopman operator.

    x: [T, F]. Returns w [T] (normalized to mean 1). Implements the
    KoopmanWeightingEstimator algorithm: augment whitened mean-free features
    with a constant 1, estimate K = C00⁻¹ C0t in that basis, take the left
    eigenvector of K at eigenvalue 1 → stationary density coefficients.
    """
    x0 = x[:-lag]
    xt = x[lag:]
    mean0 = x0.mean(0)
    y0 = x0 - mean0
    yt = xt - mean0
    c00 = y0.T @ y0 / len(y0)
    w_half = _sym_inv_sqrt(c00, eps)
    z0 = y0 @ w_half
    zt = yt @ w_half
    # augmented basis (z, 1)
    a0 = np.concatenate([z0, np.ones((len(z0), 1))], axis=1)
    at = np.concatenate([zt, np.ones((len(zt), 1))], axis=1)
    c00a = a0.T @ a0 / len(a0)
    c0ta = a0.T @ at / len(a0)
    k = np.linalg.solve(c00a + eps * np.eye(len(c00a)), c0ta)
    # left eigenvector of K at eigenvalue closest to 1
    vals, vecs = np.linalg.eig(k.T)
    idx = np.argmin(np.abs(vals - 1.0))
    u = np.real(vecs[:, idx])
    zfull = np.concatenate([(x - mean0) @ w_half, np.ones((len(x), 1))], axis=1)
    w = zfull @ u
    if w.mean() < 0:
        w = -w
    w = np.clip(w, 0.0, None)
    return w / max(w.mean(), 1e-12)


@dataclass
class TICAModel:
    mean: np.ndarray
    components: np.ndarray  # [F, dim] projection (kinetic-map scaled)
    eigenvalues: np.ndarray
    lag: int = 1

    def transform(self, x: np.ndarray) -> np.ndarray:
        return (x - self.mean) @ self.components

    @property
    def timescales(self) -> np.ndarray:
        """Implied timescales in FRAMES: -lag / ln(λ) (pyemma semantics)."""
        lam = np.clip(np.abs(self.eigenvalues), 1e-12, 1 - 1e-12)
        return -float(self.lag) / np.log(lam)


def tica(
    x: np.ndarray,
    lag: int = 1000,
    dim: Optional[int] = None,
    kinetic_map: bool = True,
    weights: Optional[np.ndarray] = None,
    eps: float = 1e-10,
    var_cutoff: float = 0.95,
) -> TICAModel:
    """Fit TICA on one trajectory [T, F].

    Reversible (symmetrized) covariance estimation as in pyemma's default;
    optional per-frame weights (from ``koopman_weights``) reweight both
    instantaneous and lagged covariances. ``dim=None`` keeps components up
    to ``var_cutoff`` cumulative kinetic variance (Σλ², pyemma's
    var_cutoff=0.95 default) — the downstream clustering/MSM then runs in
    the truncated space the reference pipeline uses, not the full noisy
    feature space. Pass ``var_cutoff=1.0`` (or an explicit dim) for all
    components.
    """
    x = np.asarray(x, np.float64)
    x0 = x[:-lag]
    xt = x[lag:]
    if weights is not None:
        w = np.asarray(weights, np.float64)[: len(x0)]
    else:
        w = np.ones(len(x0))
    wsum = w.sum()
    mean = (w[:, None] * (x0 + xt)).sum(0) / (2 * wsum)
    y0 = x0 - mean
    yt = xt - mean
    # symmetrized estimates
    c00 = (y0.T @ (w[:, None] * y0) + yt.T @ (w[:, None] * yt)) / (2 * wsum)
    c0t = (y0.T @ (w[:, None] * yt) + yt.T @ (w[:, None] * y0)) / (2 * wsum)

    c00_half = _sym_inv_sqrt(c00, eps)
    m = c00_half @ c0t @ c00_half
    vals, vecs = np.linalg.eigh((m + m.T) / 2)
    order = np.argsort(-vals)
    vals = vals[order]
    vecs = vecs[:, order]
    if dim is None and var_cutoff < 1.0:
        kin = vals ** 2
        cum = np.cumsum(kin) / max(kin.sum(), 1e-300)
        dim = int(np.searchsorted(cum, var_cutoff) + 1)
    if dim is None:
        dim = vecs.shape[1]
    dim = max(1, min(dim, vecs.shape[1]))
    # eigenvalues stay FULL on the model (pyemma exposes the whole
    # spectrum); only the projection is truncated to `dim` components
    components = c00_half @ vecs[:, :dim]
    if kinetic_map:
        components = components * np.abs(vals[:dim])[None, :]
    return TICAModel(mean=mean, components=components, eigenvalues=vals, lag=lag)
