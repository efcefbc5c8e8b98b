"""All-atom geometry (counterpart of ``lam_slide_tpu.geometry``): residue
tables, rigid transforms and the differentiable atom14/atom37/torsion ops."""

from lam_slide_tpu_torch.geometry import constants, ops
from lam_slide_tpu_torch.geometry.rigid import Rigid

__all__ = ["Rigid", "constants", "ops"]
