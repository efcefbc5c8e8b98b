"""Jensen–Shannon distance metrics over histograms.

The reference's eval metrics (src/eval_peptide.py:102-129,370-408): per-
torsion JSD on 100-bin histograms over (−π, π), 2D φ/ψ JSD on 50×50
histograms, TICA-space JSDs, and the BB/SC/ALL summary means. Histograms +
scipy.spatial.distance.jensenshannon, identical binning.
"""

from typing import Dict, Sequence

import numpy as np
from scipy.spatial.distance import jensenshannon


def hist_jsd(a: np.ndarray, b: np.ndarray, bins: int = 100, range_=(-np.pi, np.pi)) -> float:
    pa = np.histogram(a, range=range_, bins=bins)[0]
    pb = np.histogram(b, range=range_, bins=bins)[0]
    return float(jensenshannon(pa, pb))


def hist2d_jsd(a: np.ndarray, b: np.ndarray, bins: int = 50, range_=None) -> float:
    """a, b: [N, 2]. Default range (−π, π)² (reference eval_peptide.py:120-129)."""
    if range_ is None:
        range_ = ((-np.pi, np.pi), (-np.pi, np.pi))
    pa = np.histogram2d(a[:, 0], a[:, 1], range=range_, bins=bins)[0]
    pb = np.histogram2d(b[:, 0], b[:, 1], range=range_, bins=bins)[0]
    return float(jensenshannon(pa.flatten(), pb.flatten()))


def torsion_jsd(
    traj_feats: np.ndarray,
    ref_feats: np.ndarray,
    feature_names: Sequence[str],
    coupled_pairs: Sequence[int] = (1, 3),
) -> Dict[str, float]:
    """Per-feature JSD + coupled 2D JSD at the reference's column pairs
    (eval_peptide.py:112-129: indices [1,2] and [3,4] — φ/ψ pairs of the
    inner residues for tetrapeptides)."""
    out: Dict[str, float] = {}
    for i, name in enumerate(feature_names):
        out[name] = hist_jsd(ref_feats[:, i], traj_feats[:, i])
    for i in coupled_pairs:
        if i + 1 < traj_feats.shape[1]:
            key = "|".join([feature_names[i], feature_names[i + 1]])
            out[key] = hist2d_jsd(ref_feats[:, i : i + 2], traj_feats[:, i : i + 2])
    return out


def tica_jsd(ref_tica: np.ndarray, traj_tica: np.ndarray) -> Dict[str, float]:
    """TICA-0 (100 bins) and TICA-0,1 (50×50) JSD with joint min/max ranges
    (eval_peptide.py:189-219)."""
    lo0 = min(ref_tica[:, 0].min(), traj_tica[:, 0].min())
    hi0 = max(ref_tica[:, 0].max(), traj_tica[:, 0].max())
    lo1 = min(ref_tica[:, 1].min(), traj_tica[:, 1].min())
    hi1 = max(ref_tica[:, 1].max(), traj_tica[:, 1].max())
    out = {
        "TICA-0": hist_jsd(traj_tica[:, 0], ref_tica[:, 0], bins=100, range_=(lo0, hi0))
    }
    out["TICA-0,1"] = hist2d_jsd(
        ref_tica[:, :2], traj_tica[:, :2], bins=50, range_=((lo0, hi0), (lo1, hi1))
    )
    # note arg order of TICA-0 follows the reference (ref first) — JSD is symmetric
    return out


def summary_metrics(per_peptide: Dict[str, Dict]) -> Dict[str, float]:
    """BB/SC/ALL torsion means + TICA + MSM means (eval_peptide.py:370-408)."""
    bb, sc, allt, tica0, tica01, msms = [], [], [], [], [], []
    for metrics in per_peptide.values():
        jsd = metrics["JSD"]
        bb.extend([v for k, v in jsd.items()
                   if (("PHI" in k) or ("PSI" in k)) and ("|" not in k) and "TICA" not in k])
        sc.extend([v for k, v in jsd.items() if "CHI" in k])
        allt.extend([v for k, v in jsd.items()
                     if (("PHI" in k) or ("PSI" in k) or ("CHI" in k)) and ("|" not in k)])
        if "TICA-0" in jsd:
            tica0.append(jsd["TICA-0"])
            tica01.append(jsd["TICA-0,1"])
        if "ref_metastable_probs" in metrics and "traj_metastable_probs" in metrics:
            msms.append(float(jensenshannon(
                metrics["ref_metastable_probs"], metrics["traj_metastable_probs"])))
    out = {"BB": float(np.mean(bb)), "SC": float(np.mean(sc)) if sc else float("nan"),
           "ALL": float(np.mean(allt))}
    if tica0:
        out["TICA-0"] = float(np.mean(tica0))
        out["TICA-0,1"] = float(np.mean(tica01))
    if msms:
        out["MSMS"] = float(np.mean(msms))
    return out
