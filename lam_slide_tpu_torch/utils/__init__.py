"""Utilities (counterpart of ``lam_slide_tpu.utils``)."""
