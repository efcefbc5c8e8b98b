"""Backbone-level structural metrics.

Numpy port of src/utils/backbone_utils.py (mdtraj-free: operates on CA
coordinate arrays [T, R, 3]): Ramachandran KLD, per-feature and joint JS
distances, contact-matrix RMSE, CA validity (no clash < 0.3 nm, no bond
break > 0.419 nm), radius of gyration.
"""

from typing import Tuple

import numpy as np
from scipy.spatial.distance import jensenshannon


def ramachandran_kld(phi_gen, psi_gen, phi_md, psi_md, bins: int = 64) -> float:
    """KLD of the 2D φ/ψ densities (backbone_utils.py:40-67)."""
    eps = 1e-10
    rng = [[-np.pi, np.pi], [-np.pi, np.pi]]
    h_md = np.histogram2d(phi_md, psi_md, bins, range=rng, density=True)[0]
    h_gen = np.histogram2d(phi_gen, psi_gen, bins, range=rng, density=True)[0]
    return float(np.sum(h_md * np.log((h_md + eps) / (h_gen + eps))) * (2 * np.pi / bins) ** 2)


def js_distance(feat_ref: np.ndarray, feat_model: np.ndarray, bins: int = 50) -> float:
    """Mean per-dimension JSD with ref-ranged bins (backbone_utils.py:70-82)."""
    out = []
    for d in range(feat_ref.shape[1]):
        edges = np.linspace(feat_ref[:, d].min(), feat_ref[:, d].max(), bins)
        hr = np.histogram(feat_ref[:, d], bins=edges)[0]
        hm = np.histogram(feat_model[:, d], bins=edges)[0]
        out.append(jensenshannon(hr, hm))
    return float(np.mean(out))


def joint_js_distance(f0_ref, f1_ref, f0_model, f1_model, bins: int = 50) -> float:
    """Joint 2D JSD over ref-ranged bins (backbone_utils.py:84-104)."""
    e0 = np.linspace(f0_ref.min(), f0_ref.max(), bins)
    e1 = np.linspace(f1_ref.min(), f1_ref.max(), bins)
    hr = np.histogram2d(f0_ref, f1_ref, bins=(e0, e1))[0]
    hm = np.histogram2d(f0_model, f1_model, bins=(e0, e1))[0]
    return float(jensenshannon(hr.flatten(), hm.flatten()))


def contact_matrix(ca_xyz: np.ndarray, threshold: float = 1.0) -> np.ndarray:
    """Upper-triangular CA contact rates (backbone_utils.py:107-121)."""
    d = np.linalg.norm(ca_xyz[:, :, None] - ca_xyz[:, None, :], axis=-1)
    rates = (d < threshold).mean(0)
    return np.triu(rates, k=1)


def contact_rmse(ca_ref: np.ndarray, ca_model: np.ndarray, threshold: float = 1.0) -> float:
    cr = contact_matrix(ca_ref, threshold)
    cm = contact_matrix(ca_model, threshold)
    return float(np.sqrt(np.mean((cr - cm) ** 2)))


def ca_validity(
    ca_xyz: np.ndarray, clash_threshold: float = 0.3, bond_break_threshold: float = 0.419
) -> float:
    """Fraction of frames with no CA clash and no broken CA-CA bond
    (backbone_utils.py:124-137)."""
    t, n = ca_xyz.shape[:2]
    d = np.linalg.norm(ca_xyz[:, :, None] - ca_xyz[:, None, :], axis=-1)
    has_clash = (d < clash_threshold).sum(axis=(1, 2)) - n > 0
    adjacent = d[:, np.arange(n - 1), np.arange(1, n)]
    has_break = (adjacent > bond_break_threshold).sum(axis=1) > 0
    return float(np.mean(~(has_clash | has_break)))


def radius_of_gyration(xyz: np.ndarray) -> np.ndarray:
    """Per-frame Rg of [T, N, 3] coordinates."""
    centered = xyz - xyz.mean(axis=1, keepdims=True)
    return np.sqrt((centered**2).sum(-1).mean(-1))


def roc_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Binary ROC-AUC via the rank statistic (torchmetrics AUROC stand-in)."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels).astype(bool)
    n_pos = labels.sum()
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    # tie-averaged ranks, vectorized: each unique value occupies a
    # contiguous 1-based rank range [start, end] in sort order; its
    # average rank is the midpoint (O(n log n), no per-value passes)
    uniq, inv, counts = np.unique(scores, return_inverse=True,
                                  return_counts=True)
    ends = np.cumsum(counts)
    ranks = (ends - (counts - 1) / 2.0)[inv]
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def multiclass_auroc(logits: np.ndarray, targets: np.ndarray) -> float:
    """Macro one-vs-rest AUROC (reference torchmetrics AUROC(multiclass),
    first_stage/nba.py:92-99 / peptide metrics)."""
    n_classes = logits.shape[-1]
    aucs = []
    for c in range(n_classes):
        auc = roc_auc(logits[:, c], targets == c)
        if np.isfinite(auc):
            aucs.append(auc)
    return float(np.mean(aucs)) if aucs else float("nan")


def traj_analysis(
    gen_ca: np.ndarray, ref_ca: np.ndarray, bins: int = 50
) -> dict:
    """Composite backbone metric bundle (reference traj_utils.traj_analysis):
    validity, contact RMSE, Rg JSD, pairwise-distance JSD."""
    from scipy.spatial.distance import jensenshannon

    rg_ref = radius_of_gyration(ref_ca)
    rg_gen = radius_of_gyration(gen_ca)
    edges = np.linspace(rg_ref.min(), rg_ref.max(), bins)
    rg_jsd = float(jensenshannon(np.histogram(rg_ref, edges)[0],
                                 np.histogram(rg_gen, edges)[0]))

    def pdists(ca):
        n = ca.shape[1]
        iu = np.triu_indices(n, 1)
        d = np.linalg.norm(ca[:, :, None] - ca[:, None, :], axis=-1)
        return d[:, iu[0], iu[1]]

    pw_jsd = js_distance(pdists(ref_ca), pdists(gen_ca), bins)
    return {
        "val_ca": ca_validity(gen_ca),
        "contact_rmse": contact_rmse(ref_ca, gen_ca),
        "rg_jsd": rg_jsd,
        "pwd_jsd": pw_jsd,
    }
