"""Trajectory featurization from atom14 coordinates.

Replaces the pyemma/mdtraj featurizers (src/modules/analysis.py:10-24,
src/utils/tica_utils.py:24-39) with direct computation from the atom14
representation through the port's torch geometry ops: backbone torsions (phi/psi —
and omega for the TICA feature set), side-chain chi torsions, and CA
pairwise distances. Feature ordering follows the pyemma convention the
reference's JSD bookkeeping relies on: per residue PHI, PSI interleaved,
then CHI1..4 per residue.
"""

from typing import List, Optional, Tuple

import numpy as np

from lam_slide_tpu_torch.geometry import constants as pc
from lam_slide_tpu_torch.geometry import ops as geo


def trajectory_torsions(atom14: np.ndarray, aatype: np.ndarray):
    """atom14 [T, R, 14, 3], aatype [R] → (angles [T, 7, R], mask [7, R]).

    Angle order along axis 1: omega, phi, psi, chi1..4 (atan2 of the sin/cos
    pipeline output). Mask marks defined angles (first-residue phi/omega and
    absent chis excluded).
    """
    t, r = atom14.shape[:2]
    aatype_t = np.broadcast_to(np.asarray(aatype), (t, r))
    atom37 = np.asarray(geo.atom14_to_atom37(atom14, aatype_t))
    sin_cos, mask = geo.atom37_to_torsions(atom37, aatype_t)
    sin_cos = np.asarray(sin_cos)
    angles = np.arctan2(sin_cos[..., 0], sin_cos[..., 1])  # [T, R, 7]
    return angles.transpose(0, 2, 1), np.asarray(mask)[0].transpose(1, 0)


class TorsionFeatures:
    """Named torsion feature matrix (pyemma add_backbone/sidechain_torsions).

    Backbone features per residue: PHI (skip residue 0), PSI (skip last
    residue — pyemma convention); sidechains: CHI1..4 where defined.
    """

    def __init__(self, aatype: np.ndarray, sidechains: bool = True):
        self.aatype = np.asarray(aatype)
        self.sidechains = sidechains
        r = len(self.aatype)
        chi_mask = pc.CHI_ANGLES_MASK_ARR[self.aatype]  # [R, 4]
        self.columns: List[Tuple[str, int, int]] = []  # (name, angle_idx, residue)
        for ri in range(r):
            if ri > 0:
                self.columns.append((f"PHI {ri}", 1, ri))
            if ri < r - 1:
                self.columns.append((f"PSI {ri}", 2, ri))
        if sidechains:
            for ri in range(r):
                for ci in range(4):
                    if chi_mask[ri, ci]:
                        self.columns.append((f"CHI{ci+1} {ri}", 3 + ci, ri))

    def describe(self) -> List[str]:
        return [c[0] for c in self.columns]

    def __call__(self, atom14: np.ndarray, cossin: bool = False) -> np.ndarray:
        """atom14 [T, R, 14, 3] → [T, F] angles (or [T, 2F] sin|cos pairs)."""
        angles, _ = trajectory_torsions(atom14, self.aatype)  # [T, 7, R]
        cols = np.stack([angles[:, ai, ri] for _, ai, ri in self.columns], axis=1)
        if not cossin:
            return cols
        out = np.empty((cols.shape[0], 2 * cols.shape[1]), cols.dtype)
        out[:, 0::2] = np.cos(cols)
        out[:, 1::2] = np.sin(cols)
        return out


def ca_distances(atom14: np.ndarray) -> np.ndarray:
    """Pairwise CA distances [T, R*(R-1)/2] (tica_utils.py distances)."""
    ca = atom14[:, :, pc.ATOM_ORDER["CA"]]
    r = ca.shape[1]
    iu = np.triu_indices(r, k=1)
    d = np.linalg.norm(ca[:, :, None] - ca[:, None, :], axis=-1)
    return d[:, iu[0], iu[1]]


def tica_feature_matrix(atom14: np.ndarray, aatype: np.ndarray) -> np.ndarray:
    """CA distances ⊕ phi/psi/omega sin-cos (tica_utils.py:24-39)."""
    angles, _ = trajectory_torsions(atom14, aatype)  # [T, 7, R]
    # reference order: sin(phi), cos(phi), sin(psi), cos(psi), sin(omega), cos(omega)
    phi = angles[:, 1, 1:]
    psi = angles[:, 2, :-1]
    omega = angles[:, 0, 1:]
    dihedrals = np.concatenate(
        [np.sin(phi), np.cos(phi), np.sin(psi), np.cos(psi), np.sin(omega), np.cos(omega)],
        axis=-1,
    )
    return np.concatenate([ca_distances(atom14), dihedrals], axis=-1)
