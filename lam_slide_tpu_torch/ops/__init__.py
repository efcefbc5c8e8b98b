"""Kernels and their plain PyTorch versions (counterpart of ``lam_slide_tpu.ops``)."""
