"""Transport (counterpart of ``lam_slide_tpu.transport``)."""

from lam_slide_tpu_torch.transport.transport import Sampler, Transport, create_transport

__all__ = ["Sampler", "Transport", "create_transport"]
