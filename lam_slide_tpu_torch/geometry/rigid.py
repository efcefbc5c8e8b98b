"""Rigid-body (SE(3)) transforms over torch tensors (counterpart of
``lam_slide_tpu/geometry/rigid.py``; reference src/utils/rigid_utils.py).

A transform is a rotation-matrix stack ``rots [..., 3, 3]`` and a
translation stack ``trans [..., 3]``. Every contraction is a broadcast
product summed in fp32, so no TF32 setting of the card reaches it and the
3 x 3 products stay exact fp32 as the JAX ``Precision.HIGHEST`` einsums are.
Quaternion helpers are kept for checkpoint and IO parity; all compute paths
use matrices.
"""

from typing import Sequence, Tuple

import torch


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., i, j] @ [..., j, k] over broadcast batch axes, in fp32 sums."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(dim=-2)


def _matvec3(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[..., i, j] @ [..., j] -> [..., i]."""
    return (m * v.unsqueeze(-2)).sum(dim=-1)


class Rigid:
    """``rots [..., 3, 3]`` and ``trans [..., 3]``; methods as in JAX's."""

    def __init__(self, rots: torch.Tensor, trans: torch.Tensor):
        self.rots, self.trans = rots, trans

    # -- constructors ------------------------------------------------------

    @staticmethod
    def identity(batch_shape: Tuple[int, ...] = (), dtype=torch.float32,
                 device=None) -> "Rigid":
        rots = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3)
        return Rigid(rots, torch.zeros((*batch_shape, 3), dtype=dtype, device=device))

    @staticmethod
    def from_3_points(p_neg_x_axis: torch.Tensor, origin: torch.Tensor,
                      p_xy_plane: torch.Tensor, eps: float = 1e-8) -> "Rigid":
        """Gram–Schmidt frame construction (AlphaFold alg. 21;
        rigid_utils.py:1093-1136): e0 = origin − p_neg_x_axis, e1 =
        p_xy_plane − origin orthogonalized against e0, e2 = e0 × e1; the
        basis vectors are the matrix columns, origin the translation."""
        e0 = origin - p_neg_x_axis
        e1 = p_xy_plane - origin
        e0 = e0 / torch.sqrt((e0 ** 2).sum(dim=-1, keepdim=True) + eps)
        e1 = e1 - e0 * (e0 * e1).sum(dim=-1, keepdim=True)
        e1 = e1 / torch.sqrt((e1 ** 2).sum(dim=-1, keepdim=True) + eps)
        e2 = torch.linalg.cross(e0, e1, dim=-1)
        return Rigid(torch.stack([e0, e1, e2], dim=-1), origin)

    @staticmethod
    def from_tensor_4x4(t: torch.Tensor) -> "Rigid":
        return Rigid(t[..., :3, :3], t[..., :3, 3])

    def to_tensor_4x4(self) -> torch.Tensor:
        out = torch.zeros((*self.shape, 4, 4), dtype=self.rots.dtype, device=self.rots.device)
        out[..., :3, :3] = self.rots
        out[..., :3, 3] = self.trans
        out[..., 3, 3] = 1.0
        return out

    # -- algebra -----------------------------------------------------------

    @property
    def shape(self):
        return self.trans.shape[:-1]

    def compose(self, other: "Rigid") -> "Rigid":
        """self ∘ other: apply ``other`` first in the local frame, then self."""
        return Rigid(_matmul3(self.rots, other.rots), self.apply(other.trans))

    def apply(self, points: torch.Tensor) -> torch.Tensor:
        """Rotate and translate points [..., 3]."""
        return _matvec3(self.rots, points) + self.trans

    def invert(self) -> "Rigid":
        inv_rots = self.rots.transpose(-1, -2)
        return Rigid(inv_rots, -_matvec3(inv_rots, self.trans))

    def invert_apply(self, points: torch.Tensor) -> torch.Tensor:
        return _matvec3(self.rots.transpose(-1, -2), points - self.trans)

    def scale_translation(self, factor) -> "Rigid":
        return Rigid(self.rots, self.trans * factor)

    # -- structural ops ------------------------------------------------------

    def __getitem__(self, idx) -> "Rigid":
        if not isinstance(idx, tuple):
            idx = (idx,)
        return Rigid(self.rots[idx + (slice(None), slice(None))],
                     self.trans[idx + (slice(None),)])

    @staticmethod
    def cat(rigids: Sequence["Rigid"], axis: int = 0) -> "Rigid":
        """Concatenate along a batch axis (negative axes count from the last
        batch dim, as in the reference's Rigid.cat)."""
        rot_axis = axis if axis >= 0 else axis - 2
        tr_axis = axis if axis >= 0 else axis - 1
        return Rigid(torch.cat([r.rots for r in rigids], dim=rot_axis),
                     torch.cat([r.trans for r in rigids], dim=tr_axis))

    def unsqueeze(self, axis: int) -> "Rigid":
        rot_axis = axis if axis >= 0 else axis - 2
        tr_axis = axis if axis >= 0 else axis - 1
        return Rigid(self.rots.unsqueeze(rot_axis), self.trans.unsqueeze(tr_axis))


# ---------------------------------------------------------------------------
# Quaternion interop (reference Rotation quaternion pathway)
# ---------------------------------------------------------------------------


def quat_to_rot(quat: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] (w, x, y, z) -> rotation matrix [..., 3, 3]."""
    quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    w, x, y, z = quat.unbind(-1)
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(*quat.shape[:-1], 3, 3)


def rot_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4] (w, x, y, z):
    the eigenvector of the largest eigenvalue of the K-matrix (robust for
    all traces; rigid_utils.py rot_to_quat), sign fixed so that w >= 0."""
    m = rot
    xx, xy, xz = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    yx, yy, yz = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    zx, zy, zz = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    k = torch.stack([
        xx + yy + zz, zy - yz, xz - zx, yx - xy,
        zy - yz, xx - yy - zz, xy + yx, xz + zx,
        xz - zx, xy + yx, yy - xx - zz, yz + zy,
        yx - xy, xz + zx, yz + zy, zz - xx - yy,
    ], dim=-1).reshape(*m.shape[:-2], 4, 4) / 3.0
    _, vecs = torch.linalg.eigh(k)
    quat = vecs[..., -1]
    return quat * torch.sign(quat[..., :1] + 1e-20)
