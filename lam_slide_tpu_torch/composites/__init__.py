"""Composites (counterpart of ``lam_slide_tpu.composites``): the two-stage
assembly, the MD17 domain and its evaluation protocol."""
