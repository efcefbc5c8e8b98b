"""Experiment builders (counterpart of ``lam_slide_tpu.experiments``)."""
