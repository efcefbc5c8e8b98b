"""Differentiable all-atom geometry ops in torch (counterpart of
``lam_slide_tpu/geometry/ops.py``; reference src/modules/geometry.py, the
mdgen/OpenFold all-atom pipeline).

atom14 <-> atom37 conversion, backbone frames from N/CA/C, atom37 -> torsion
sin/cos, and torsion -> frames -> atom14 forward kinematics. Plain torch in
fp32, differentiable, on the device of their inputs; no kernel (JAX
computes them outside any Pallas kernel too). Each op also takes numpy
arrays (floating ones as fp32, as JAX's default dtype makes them) and then
returns CPU tensors, which ``np.asarray`` reads: the numpy analysis modules
call them so.
"""

from typing import Tuple

import numpy as np
import torch

from lam_slide_tpu_torch.geometry import constants as pc
from lam_slide_tpu_torch.geometry.rigid import Rigid


def _tensor(x, device=None) -> torch.Tensor:
    """A tensor of x: numpy floats become fp32, integers int64."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    a = np.asarray(x)
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    elif a.dtype.kind in "iu":
        a = a.astype(np.int64)
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if device is None else t.to(device)


def _table(name: str, device) -> torch.Tensor:
    return _tensor(getattr(pc, name), device)


def _gather(arr: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """take_along_axis of arr by idx on ``axis`` (-2 for [..., A, 3] atoms,
    -1 for [..., A] masks), the other axes broadcast against each other."""
    if axis == -2:
        batch = torch.broadcast_shapes(arr.shape[:-2], idx.shape[:-1])
        arr = arr.expand(*batch, *arr.shape[-2:])
        idx = idx.expand(*batch, idx.shape[-1])
        return torch.gather(arr, -2, idx.long().unsqueeze(-1).expand(*idx.shape, arr.shape[-1]))
    batch = torch.broadcast_shapes(arr.shape[:-1], idx.shape[:-1])
    return torch.gather(arr.expand(*batch, arr.shape[-1]), -1,
                        idx.long().expand(*batch, idx.shape[-1]))


def atom14_to_atom37(atom14, aatype, atom14_mask=None):
    """[..., N, 14, 3] -> [..., N, 37, 3] (geometry.py:14-32)."""
    atom14 = _tensor(atom14)
    aatype = _tensor(aatype, atom14.device).long()
    idx = _table("RESTYPE_ATOM37_TO_ATOM14", atom14.device)[aatype]  # [..., N, 37]
    mask37 = _table("RESTYPE_ATOM37_MASK", atom14.device)[aatype]
    atom37 = _gather(atom14, idx, -2) * mask37[..., None]
    if atom14_mask is not None:
        m = _gather(_tensor(atom14_mask, atom14.device), idx, -1) * mask37
        return atom37, m
    return atom37


def atom37_to_atom14(atom37, aatype, atom37_mask=None):
    """[..., N, 37, 3] -> [..., N, 14, 3] (geometry.py:35-53)."""
    atom37 = _tensor(atom37)
    aatype = _tensor(aatype, atom37.device).long()
    idx = _table("RESTYPE_ATOM14_TO_ATOM37", atom37.device)[aatype]
    mask14 = _table("RESTYPE_ATOM14_MASK", atom37.device)[aatype]
    atom14 = _gather(atom37, idx, -2) * mask14[..., None]
    if atom37_mask is not None:
        m = _gather(_tensor(atom37_mask, atom37.device), idx, -1) * mask14
        return atom14, m
    return atom14


_FLIP = np.diag([-1.0, 1.0, -1.0]).astype(np.float32)


def atom14_to_frames(atom14) -> Rigid:
    """Backbone frames from N/CA/C with the mdgen axis flip
    (geometry.py:212-227): atom14 [..., N, 14, 3] -> Rigid of batch [..., N]."""
    atom14 = _tensor(atom14)
    n = atom14[..., pc.ATOM_ORDER["N"], :]
    ca = atom14[..., pc.ATOM_ORDER["CA"], :]
    c = atom14[..., pc.ATOM_ORDER["C"], :]
    frames = Rigid.from_3_points(c, ca, n)
    flip = _tensor(_FLIP, atom14.device).to(frames.rots.dtype)
    return frames.compose(Rigid(flip.expand(frames.rots.shape), torch.zeros_like(frames.trans)))


def atom37_to_torsions(all_atom_positions, aatype,
                       all_atom_mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """7 torsions (omega, phi, psi, chi1-4) as sin/cos and their validity
    mask (geometry.py:80-196): positions [..., N, 37, 3], aatype [..., N] ->
    (torsions [..., N, 7, 2], mask [..., N, 7])."""
    pos = _tensor(all_atom_positions)
    dev = pos.device
    aatype = _tensor(aatype, dev).long()
    if all_atom_mask is None:
        all_atom_mask = _table("RESTYPE_ATOM37_MASK", dev)[aatype]
    mask = _tensor(all_atom_mask, dev)
    mask = mask if mask.is_floating_point() else mask.float()

    prev_pos = torch.cat([torch.zeros_like(pos[..., :1, :, :]), pos[..., :-1, :, :]], dim=-3)
    prev_mask = torch.cat([torch.zeros_like(mask[..., :1, :]), mask[..., :-1, :]], dim=-2)

    # backbone torsion atom quadruples
    pre_omega_pos = torch.cat([prev_pos[..., 1:3, :], pos[..., :2, :]], dim=-2)
    phi_pos = torch.cat([prev_pos[..., 2:3, :], pos[..., :3, :]], dim=-2)
    psi_pos = torch.cat([pos[..., :3, :], pos[..., 4:5, :]], dim=-2)
    pre_omega_mask = prev_mask[..., 1:3].prod(dim=-1) * mask[..., :2].prod(dim=-1)
    phi_mask = prev_mask[..., 2] * mask[..., :3].prod(dim=-1)
    psi_mask = mask[..., :3].prod(dim=-1) * mask[..., 4]

    # chi quadruples through per-residue atom indices
    chi_idx = _table("CHI_ATOM_INDICES", dev)[aatype]  # [..., N, 4, 4]
    flat_idx = chi_idx.reshape(*chi_idx.shape[:-2], 16)
    chis_pos = _gather(pos, flat_idx, -2).reshape(*chi_idx.shape[:-2], 4, 4, 3)
    chis_atom_mask = _gather(mask, flat_idx, -1).reshape(*chi_idx.shape[:-2], 4, 4)
    chis_mask = _table("CHI_ANGLES_MASK_ARR", dev)[aatype] * chis_atom_mask.prod(dim=-1)

    torsions_pos = torch.cat([pre_omega_pos[..., None, :, :], phi_pos[..., None, :, :],
                              psi_pos[..., None, :, :], chis_pos], dim=-3)  # [..., N, 7, 4, 3]
    torsions_mask = torch.cat([pre_omega_mask[..., None], phi_mask[..., None],
                               psi_mask[..., None], chis_mask], dim=-1)

    frames = Rigid.from_3_points(torsions_pos[..., 1, :], torsions_pos[..., 2, :],
                                 torsions_pos[..., 0, :], eps=1e-8)
    fourth_rel = frames.invert_apply(torsions_pos[..., 3, :])
    sin_cos = torch.stack([fourth_rel[..., 2], fourth_rel[..., 1]], dim=-1)
    sin_cos = sin_cos / torch.sqrt((sin_cos ** 2).sum(dim=-1, keepdim=True) + 1e-8)
    # psi sign flip (geometry.py:189-196)
    sign = torch.tensor([1.0, 1.0, -1.0, 1.0, 1.0, 1.0, 1.0], device=dev)[:, None]
    return sin_cos * sign, torsions_mask


def torsion_angles_to_frames(bb: Rigid, alpha, aatype) -> Rigid:
    """Backbone frame + 7 torsions -> 8 global group frames
    (geometry.py:284-328): bb Rigid [..., N], alpha [..., N, 7, 2] sin/cos
    -> Rigid [..., N, 8]."""
    dev = bb.rots.device
    alpha = _tensor(alpha, dev)
    aatype = _tensor(aatype, dev).long()
    default_r = Rigid.from_tensor_4x4(_table("RESTYPE_RIGID_GROUP_DEFAULT_FRAME", dev)[aatype])

    bb_rot = torch.zeros((*alpha.shape[:-2], 1, 2), dtype=alpha.dtype, device=dev)
    bb_rot[..., 1] = 1.0
    alpha8 = torch.cat([bb_rot, alpha], dim=-2)  # [..., N, 8, 2]
    sin_a, cos_a = alpha8[..., 0], alpha8[..., 1]
    zeros, ones = torch.zeros_like(sin_a), torch.ones_like(sin_a)
    # x-axis rotation by the torsion angle (geometry.py:306-317)
    rots = torch.stack([ones, zeros, zeros, zeros, cos_a, -sin_a, zeros, sin_a, cos_a],
                       dim=-1).reshape(*sin_a.shape, 3, 3)
    all_frames = default_r.compose(Rigid(rots, torch.zeros((*sin_a.shape, 3), dtype=alpha.dtype,
                                                           device=dev)))
    chi1 = all_frames[..., 4]
    chi2 = chi1.compose(all_frames[..., 5])
    chi3 = chi2.compose(all_frames[..., 6])
    chi4 = chi3.compose(all_frames[..., 7])
    all_to_bb = Rigid.cat([all_frames[..., :5], chi2.unsqueeze(-1), chi3.unsqueeze(-1),
                           chi4.unsqueeze(-1)], axis=-1)
    return bb.unsqueeze(-1).compose(all_to_bb)


def frames_to_atom14(frames8: Rigid, aatype) -> torch.Tensor:
    """8 global group frames -> idealized atom14 coordinates
    (geometry.py:231-262): each atom takes its rigid group's frame."""
    dev = frames8.rots.device
    aatype = _tensor(aatype, dev).long()
    group_idx = _table("RESTYPE_ATOM14_TO_RIGID_GROUP", dev)[aatype]  # [..., N, 14]
    batch = torch.broadcast_shapes(frames8.rots.shape[:-3], group_idx.shape[:-1])
    g = group_idx.expand(*batch, 14)
    rots = torch.gather(frames8.rots.expand(*batch, 8, 3, 3), -3,
                        g[..., None, None].expand(*batch, 14, 3, 3))
    trans = torch.gather(frames8.trans.expand(*batch, 8, 3), -2,
                         g[..., None].expand(*batch, 14, 3))
    lit = _table("RESTYPE_ATOM14_RIGID_GROUP_POSITIONS", dev)[aatype]  # [..., N, 14, 3]
    mask = _table("RESTYPE_ATOM14_MASK", dev)[aatype][..., None]
    return Rigid(rots, trans).apply(lit) * mask


def frames_torsions_to_atom14(bb: Rigid, torsions, aatype) -> torch.Tensor:
    """Full forward kinematics: backbone frames + torsions -> atom14
    (geometry.py:66-77)."""
    return frames_to_atom14(torsion_angles_to_frames(bb, torsions, aatype), aatype)


def frames_torsions_to_atom37(bb: Rigid, torsions, aatype) -> torch.Tensor:
    return atom14_to_atom37(frames_torsions_to_atom14(bb, torsions, aatype), aatype)
