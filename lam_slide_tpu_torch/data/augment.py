"""Host-side geometric augmentations (numpy, explicit RNG), copied from
``lam_slide_tpu/data/augment.py`` (numpy port of the reference's
src/utils/data_utils.py): the rotations of the MD17 train set, the Haar
rotation and centre/rotate/translate of the peptide sets, the 2D rotation
of the pedestrian and NBA sets, the rotation about the centroid, the range
remap and the element classes of a parsed topology.
"""

import numpy as np


def random_rotation_matrix(rng: np.random.Generator) -> np.ndarray:
    """Euler-angle 3D rotation (data_utils.py:11-31): Rz(θ)·Ry(φ)·Rx(ψ)."""
    theta = 2 * np.pi * rng.random()
    phi = np.arccos(2 * rng.random() - 1)
    psi = 2 * np.pi * rng.random()
    ct, st = np.cos(theta), np.sin(theta)
    cp, sp = np.cos(phi), np.sin(phi)
    cs, ss = np.cos(psi), np.sin(psi)
    rz = np.array([[ct, -st, 0], [st, ct, 0], [0, 0, 1]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rx = np.array([[1, 0, 0], [0, cs, -ss], [0, ss, cs]])
    return (rz @ ry @ rx).astype(np.float32)


def random_rotation_matrices(rng: np.random.Generator, b: int) -> np.ndarray:
    """[b, 3, 3] batch of Euler rotations Rz(θ)Ry(φ)Rx(ψ) — vectorized
    random_rotation_matrix (same per-matrix distribution, batched draws)."""
    theta = 2 * np.pi * rng.random(b)
    phi = np.arccos(2 * rng.random(b) - 1)
    psi = 2 * np.pi * rng.random(b)
    ct, st = np.cos(theta), np.sin(theta)
    cp, sp = np.cos(phi), np.sin(phi)
    cs, ss = np.cos(psi), np.sin(psi)
    z = np.zeros(b)
    o = np.ones(b)
    rz = np.stack([ct, -st, z, st, ct, z, z, z, o], -1).reshape(b, 3, 3)
    ry = np.stack([cp, z, sp, z, o, z, -sp, z, cp], -1).reshape(b, 3, 3)
    rx = np.stack([o, z, z, z, cs, -ss, z, ss, cs], -1).reshape(b, 3, 3)
    return (rz @ ry @ rx).astype(np.float32)


def random_rotation_matrix_2d(rng: np.random.Generator) -> np.ndarray:
    theta = 2 * np.pi * rng.random()
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]], dtype=np.float32)


def rotate(points: np.ndarray, rot: np.ndarray) -> np.ndarray:
    """points [..., D] @ R^T (data_utils.py rotate_point_cloud)."""
    return points @ rot.T


def uniform_rotation_matrix(rng: np.random.Generator) -> np.ndarray:
    """Haar-uniform SO(3) rotation via QR (used for SE(3) trajectory aug)."""
    a = rng.standard_normal((3, 3))
    q, r = np.linalg.qr(a)
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q.astype(np.float32)


def centre_random_augmentation(points: np.ndarray, rot: np.ndarray,
                               translation: np.ndarray) -> np.ndarray:
    """Center at the mean, rotate, translate (data_utils.py:40-50);
    points [N, D] or [B, N, D]."""
    axis = points.ndim - 2
    center = points.mean(axis=axis, keepdims=True)
    return (points - center) @ rot.T + translation


def rotate_about_center(points: np.ndarray, rot: np.ndarray) -> np.ndarray:
    """Rotate about the per-cloud centroid, keeping the centroid fixed
    (data_utils.py:53-84); points [N, D] or [B, N, D], rot [D, D]."""
    axis = points.ndim - 2
    center = points.mean(axis=axis, keepdims=True)
    return (points - center) @ rot.T + center


def scale_to_new_range(x, old_min=-0.5, old_max=0.5, new_min=0.1, new_max=0.9):
    """Affine range remap (data_utils.py:99-100; occupancy-grid tooling)."""
    return (x - old_min) * (new_max - new_min) / (old_max - old_min) + new_min


def encode_atoms(residues, encoding=None) -> np.ndarray:
    """Element-class ids for a parsed topology (data_utils.py:87-89, with the
    mdtraj Trajectory replaced by peptide.parse_pdb_topology residues:
    [(resname, [atom names])]; element = leading letter of the atom name)."""
    from lam_slide_tpu_torch.data.constants import ATOM_ENCODING

    encoding = ATOM_ENCODING if encoding is None else encoding
    out = []
    for _, names in residues:
        for name in names:
            element = next((c for c in name if c.isalpha()), "C")
            out.append(encoding[element])
    return np.asarray(out, np.int64)
