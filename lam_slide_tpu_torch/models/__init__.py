"""Models (counterpart of ``lam_slide_tpu.models``)."""

from lam_slide_tpu_torch.models.latent_dit import LatentDiT

__all__ = ["LatentDiT"]
