"""Derived residue-constant arrays (numpy, computed at import).

Reimplements the derivation logic of the reference's vendored AlphaFold
``residue_constants`` (src/utils/residue_constants.py:1108-1420) on top of
the compact data tables in ``tables.py``: atom14/atom37 index maps + masks,
chi-angle atom indices, rigid-group assignments, idealized group-local atom
positions, and the 8-frame default-transform stack
``RESTYPE_RIGID_GROUP_DEFAULT_FRAME`` built with the published Gram–Schmidt
construction (AlphaFold suppl. alg. 24; ``_make_rigid_group_constants``).

All arrays carry a trailing UNK row (index 20) of zeros/identities.
"""

import numpy as np

from lam_slide_tpu_torch.geometry.tables import (
    ATOM14_NAMES,
    ATOM37_NAMES,
    CHI_ANGLES_ATOMS,
    CHI_ANGLES_MASK,
    CHI_PI_PERIODIC,
    RESTYPE_1TO3,
    RESTYPES,
    RIGID_GROUP_ATOM_POSITIONS,
)

N_RESTYPES = len(RESTYPES) + 1  # 20 + UNK
RESNAMES = [RESTYPE_1TO3[r] for r in RESTYPES] + ["UNK"]
RESNAME_TO_IDX = {n: i for i, n in enumerate(RESNAMES)}
RESTYPE_ORDER = {r: i for i, r in enumerate(RESTYPES)}
ATOM37_ORDER = {a: i for i, a in enumerate(ATOM37_NAMES)}

ATOM14_NAME_LISTS = [ATOM14_NAMES[RESTYPE_1TO3[r]].split() for r in RESTYPES] + [[]]


def _build_atom_maps():
    a37_to_a14 = np.zeros((N_RESTYPES, 37), dtype=np.int64)
    a14_to_a37 = np.zeros((N_RESTYPES, 14), dtype=np.int64)
    a37_mask = np.zeros((N_RESTYPES, 37), dtype=np.float32)
    a14_mask = np.zeros((N_RESTYPES, 14), dtype=np.float32)
    for ri, names in enumerate(ATOM14_NAME_LISTS):
        name_to_14 = {n: i for i, n in enumerate(names)}
        for i14, n in enumerate(names):
            i37 = ATOM37_ORDER[n]
            a14_to_a37[ri, i14] = i37
            a14_mask[ri, i14] = 1.0
            a37_to_a14[ri, i37] = i14
            a37_mask[ri, i37] = 1.0
    return a37_to_a14, a14_to_a37, a37_mask, a14_mask


(
    RESTYPE_ATOM37_TO_ATOM14,
    RESTYPE_ATOM14_TO_ATOM37,
    RESTYPE_ATOM37_MASK,
    RESTYPE_ATOM14_MASK,
) = _build_atom_maps()


def _build_chi_atom_indices():
    """[21, 4, 4] atom37 indices of each chi quadruple (geometry.py:332-353)."""
    out = np.zeros((N_RESTYPES, 4, 4), dtype=np.int64)
    for ri, r in enumerate(RESTYPES):
        for ci, quad in enumerate(CHI_ANGLES_ATOMS[RESTYPE_1TO3[r]]):
            out[ri, ci] = [ATOM37_ORDER[a] for a in quad.split()]
    return out


CHI_ATOM_INDICES = _build_chi_atom_indices()

CHI_ANGLES_MASK_ARR = np.concatenate(
    [np.asarray(CHI_ANGLES_MASK, dtype=np.float32), np.zeros((1, 4), np.float32)]
)
CHI_PI_PERIODIC_ARR = np.concatenate(
    [np.asarray(CHI_PI_PERIODIC, dtype=np.float32), np.zeros((1, 4), np.float32)]
)


def _gram_schmidt_4x4(ex: np.ndarray, ey: np.ndarray, translation: np.ndarray) -> np.ndarray:
    """Rigid 4x4 from two axes + origin (AlphaFold _make_rigid_transformation_4x4)."""
    ex = ex / np.linalg.norm(ex)
    ey = ey - np.dot(ey, ex) * ex
    ey = ey / np.linalg.norm(ey)
    ez = np.cross(ex, ey)
    m = np.eye(4)
    m[:3, 0] = ex
    m[:3, 1] = ey
    m[:3, 2] = ez
    m[:3, 3] = translation
    return m


def _build_rigid_group_constants():
    """Group assignments, group-local positions and default frames.

    Follows the published algorithm (_make_rigid_group_constants): groups are
    0 backbone, 1 pre-omega, 2 phi, 3 psi, 4..7 chi1..4; pre-omega/backbone
    frames are identity; phi/psi/chi1 frames are Gram–Schmidt constructions
    from idealized positions; chi2..4 frames hang off the previous chi frame
    along its x-axis.
    """
    group_idx = np.zeros((N_RESTYPES, 14), dtype=np.int64)
    group_pos = np.zeros((N_RESTYPES, 14, 3), dtype=np.float32)
    # zeros, not identity: undefined chi groups and the UNK row stay all-zero
    # (matching the reference init at residue_constants.py:1108) — their
    # frames are masked out downstream by RESTYPE_ATOM14_MASK.
    default_frame = np.zeros((N_RESTYPES, 8, 4, 4), dtype=np.float32)

    for ri, r in enumerate(RESTYPES):
        default_frame[ri, 0] = np.eye(4)  # backbone
        default_frame[ri, 1] = np.eye(4)  # pre-omega
        resname = RESTYPE_1TO3[r]
        entries = RIGID_GROUP_ATOM_POSITIONS[resname]
        pos_by_name = {n: np.asarray(p, dtype=np.float64) for n, g, *p in entries}
        group_by_name = {n: g for n, g, *p in entries}
        names14 = ATOM14_NAME_LISTS[ri]
        for i14, n in enumerate(names14):
            group_idx[ri, i14] = group_by_name[n]
            group_pos[ri, i14] = pos_by_name[n]

        chi_quads = [q.split() for q in CHI_ANGLES_ATOMS[resname]]

        # phi frame (group 2): x toward N, arbitrary y
        default_frame[ri, 2] = _gram_schmidt_4x4(
            ex=pos_by_name["N"] - pos_by_name["CA"],
            ey=np.array([1.0, 0.0, 0.0]),
            translation=pos_by_name["N"],
        )
        # psi frame (group 3): x toward C, y toward N-CA
        default_frame[ri, 3] = _gram_schmidt_4x4(
            ex=pos_by_name["C"] - pos_by_name["CA"],
            ey=pos_by_name["CA"] - pos_by_name["N"],
            translation=pos_by_name["C"],
        )
        # chi1 frame (group 4)
        if CHI_ANGLES_MASK[ri][0]:
            base = [pos_by_name[a] for a in chi_quads[0][:3]]
            default_frame[ri, 4] = _gram_schmidt_4x4(
                ex=base[2] - base[1], ey=base[0] - base[1], translation=base[2]
            )
        # chi2..4 (groups 5..7): axis-end atom position is stored in the
        # *previous* group's frame; new x axis points at it.
        for chi in range(1, 4):
            if CHI_ANGLES_MASK[ri][chi]:
                axis_end = pos_by_name[chi_quads[chi][2]]
                default_frame[ri, 4 + chi] = _gram_schmidt_4x4(
                    ex=axis_end, ey=np.array([-1.0, 0.0, 0.0]), translation=axis_end
                )
    return group_idx, group_pos, default_frame


(
    RESTYPE_ATOM14_TO_RIGID_GROUP,
    RESTYPE_ATOM14_RIGID_GROUP_POSITIONS,
    RESTYPE_RIGID_GROUP_DEFAULT_FRAME,
) = _build_rigid_group_constants()

ATOM_ORDER = ATOM37_ORDER  # alias matching reference naming (rc.atom_order)
