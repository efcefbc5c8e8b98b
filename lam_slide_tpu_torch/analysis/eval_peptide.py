"""4AA peptide evaluation pipeline.

Port of src/eval_peptide.py minus wandb/pyemma: sample autoregressive
rollouts per test peptide (RolloutSampler), then compute the full metric
bundle against the reference MD trajectory — per-torsion JSD (100-bin),
coupled 2D φ/ψ JSD, TICA-0 / TICA-0,1 JSD (TICA lag 1000, kinetic map),
torsion + TICA decorrelation curves, and the 10-state MSM metastable
occupation JSD — and the BB/SC/ALL/TICA/MSMS summary means.

Everything operates on atom14 arrays; no mdtraj/pyemma/deeptime needed.
"""

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
from scipy.spatial.distance import jensenshannon

from lam_slide_tpu_torch.analysis import decorrelation, jsd, msm as msm_mod, tica as tica_mod
from lam_slide_tpu_torch.analysis.features import TorsionFeatures


@dataclass
class EvalConfig:
    tica_lag: int = 1000
    msm_lag: int = 1000
    n_clusters: int = 100
    n_metastable: int = 10
    truncate: Optional[int] = None
    run_decorrelation: bool = True
    run_msm: bool = True
    decorr_nlag: int = 1000
    seed: int = 137


def analyze_trajectory(
    traj_atom14: np.ndarray,
    ref_atom14: np.ndarray,
    aatype: np.ndarray,
    cfg: EvalConfig = EvalConfig(),
) -> Dict:
    """Metric bundle for one peptide (eval_peptide.py:78-296)."""
    out: Dict = {}
    if cfg.truncate:
        traj_atom14 = traj_atom14[: cfg.truncate]

    feat = TorsionFeatures(aatype, sidechains=True)
    traj_t = feat(traj_atom14)
    ref_t = feat(ref_atom14)
    out["features"] = feat.describe()
    out["JSD"] = jsd.torsion_jsd(traj_t, ref_t, feat.describe())

    if cfg.run_decorrelation:
        out["md_decorrelation"] = {
            name: decorrelation.torsion_decorrelation(ref_t[:, i], nlag=min(
                cfg.decorr_nlag * 100, len(ref_t) - 2))
            for i, name in enumerate(feat.describe())
        }
        out["our_decorrelation"] = {
            name: decorrelation.torsion_decorrelation(
                traj_t[:, i], nlag=min(cfg.decorr_nlag, len(traj_t) - 2))
            for i, name in enumerate(feat.describe())
        }

    # TICA on cossin features, fit on the reference MD (eval_peptide.py:189-199)
    traj_cs = feat(traj_atom14, cossin=True)
    ref_cs = feat(ref_atom14, cossin=True)
    lag = min(cfg.tica_lag, len(ref_cs) // 2)
    model = tica_mod.tica(ref_cs, lag=lag, kinetic_map=True)
    if model.components.shape[1] < 2:
        # the TICA-0,1 JSD needs two components even when the 95%
        # kinetic-variance cutoff would keep only one
        model = tica_mod.tica(ref_cs, lag=lag, kinetic_map=True, dim=2)
    ref_tica = model.transform(ref_cs)
    traj_tica = model.transform(traj_cs)
    out["JSD"].update(jsd.tica_jsd(ref_tica, traj_tica))

    if cfg.run_decorrelation:
        out["md_decorrelation"]["tica"] = decorrelation.acovf(
            ref_tica[:, 0], nlag=min(cfg.decorr_nlag * 100, len(ref_tica) - 2),
            adjusted=True, demean=False)
        out["our_decorrelation"]["tica"] = decorrelation.acovf(
            traj_tica[:, 0], nlag=min(cfg.decorr_nlag, len(traj_tica) - 2),
            adjusted=True, demean=False)

    if cfg.run_msm:
        try:
            mlag = min(cfg.msm_lag, len(ref_tica) // 2)
            model_msm = msm_mod.estimate_msm(
                ref_tica, n_clusters=min(cfg.n_clusters, len(ref_tica) // 4),
                n_metastable=cfg.n_metastable, lag=mlag, seed=cfg.seed,
            )
            traj_meta = model_msm.discretize(traj_tica)
            ref_meta = model_msm.discretize(ref_tica)
            out["traj_metastable_probs"] = msm_mod.metastable_probs(
                traj_meta, cfg.n_metastable)
            out["ref_metastable_probs"] = msm_mod.metastable_probs(
                ref_meta, cfg.n_metastable)
            out["msm_transition_matrix"] = model_msm.transition
            out["msm_pi"] = model_msm.pi
        except Exception as e:  # mirror reference robustness (eval_peptide.py:291-293)
            out["msm_error"] = repr(e)
    return out


def evaluate_peptides(
    samples: Dict[str, Dict[str, np.ndarray]], cfg: EvalConfig = EvalConfig()
):
    """samples: name -> {"traj": atom14, "ref": atom14, "aatype": [R]}.

    Returns (per_peptide metric dicts, summary means).
    """
    per = {}
    for name, d in samples.items():
        per[name] = analyze_trajectory(d["traj"], d["ref"], d["aatype"], cfg)
    return per, jsd.summary_metrics(per)
