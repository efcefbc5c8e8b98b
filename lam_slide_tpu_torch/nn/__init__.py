"""Neural-network building blocks (counterpart of ``lam_slide_tpu.nn``)."""
