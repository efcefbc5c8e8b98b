"""Host-side data pipeline (counterpart of ``lam_slide_tpu.data``): numpy
datasets, collates and the prefetching loader, copied from the JAX package
(which the port never imports), and ``device_batch`` for the card."""

from lam_slide_tpu_torch.data.collate import pad_collate, pad_collate_temporal
from lam_slide_tpu_torch.data.loader import Loader
from lam_slide_tpu_torch.data.nbody import NBodyDataset, Trajectory

__all__ = ["Loader", "NBodyDataset", "Trajectory", "pad_collate", "pad_collate_temporal"]
