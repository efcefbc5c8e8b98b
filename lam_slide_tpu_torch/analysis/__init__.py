"""The 4AA eval pipeline (counterpart of ``lam_slide_tpu.analysis``): the
rollout sampler, ``eval_cli`` and the numpy/scipy torsion, TICA, MSM and
decorrelation analysis, copied. ``plots.py`` waits for matplotlib (ROADMAP.md)."""

from lam_slide_tpu_torch.analysis import backbone, decorrelation, features, jsd, msm, tica

__all__ = ["backbone", "decorrelation", "features", "jsd", "msm", "tica"]
