"""Kernels the JAX package keeps as opt-in ablations (counterpart of
``lam_slide_tpu.ops.ablations``)."""
