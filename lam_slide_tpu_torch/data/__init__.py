"""Host-side data pipeline (counterpart of ``lam_slide_tpu.data``): numpy
datasets, collates and the prefetching loader, copied from the JAX package
(which the port never imports), and ``device_batch`` for the card."""
