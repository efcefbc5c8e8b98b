"""Protein structure container + PDB IO.

Dependency-free replacement for the reference's vendored
``src/modules/protein.py`` (Protein dataclass, to_pdb, from_pdb_string) and
the trajectory writers in geometry.py:356-398 (multi-model PDB) — the XTC
path needed MDAnalysis; multi-model PDB serves the same eval pipeline here.
"""

import dataclasses
import io
from typing import List, Optional

import numpy as np

from lam_slide_tpu_torch.geometry import constants as pc
from lam_slide_tpu_torch.geometry import ops as geo

RESTYPE_3 = [pc.RESTYPE_1TO3[r] for r in pc.RESTYPES] + ["UNK"]


@dataclasses.dataclass
class Protein:
    """Atom37 protein representation (reference protein.py Protein)."""

    atom_positions: np.ndarray  # [N, 37, 3]
    atom_mask: np.ndarray       # [N, 37]
    aatype: np.ndarray          # [N]
    residue_index: np.ndarray   # [N]
    b_factors: np.ndarray       # [N, 37]
    chain_index: np.ndarray     # [N]


def create_full_prot(atom37: np.ndarray, aatype: Optional[np.ndarray] = None,
                     b_factors: Optional[np.ndarray] = None) -> Protein:
    """atom37 [N, 37, 3] → Protein (geometry.py:401-419)."""
    assert atom37.ndim == 3 and atom37.shape[-2:] == (37, 3)
    n = atom37.shape[0]
    atom_mask = (np.abs(atom37).sum(-1) > 1e-7).astype(np.float32)
    return Protein(
        atom_positions=atom37,
        atom_mask=atom_mask,
        aatype=np.zeros(n, int) if aatype is None else np.asarray(aatype),
        residue_index=np.arange(n),
        b_factors=np.zeros((n, 37)) if b_factors is None else b_factors,
        chain_index=np.zeros(n, int),
    )


_CHAIN_IDS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789"


def to_pdb(prot: Protein) -> str:
    """Serialize to PDB (reference protein.py to_pdb conventions)."""
    lines: List[str] = ["MODEL     1"]
    atom_index = 1
    for ri in range(prot.aatype.shape[0]):
        resname = RESTYPE_3[int(prot.aatype[ri])] if prot.aatype[ri] < 21 else "UNK"
        chain = _CHAIN_IDS[int(prot.chain_index[ri]) % len(_CHAIN_IDS)]
        for ai, name in enumerate(pc.ATOM37_NAMES):
            if prot.atom_mask[ri, ai] < 0.5:
                continue
            x, y, z = prot.atom_positions[ri, ai]
            element = name[0]
            pad_name = name if len(name) == 4 else f" {name:<3s}"
            lines.append(
                f"ATOM  {atom_index:5d} {pad_name}{'':1s}{resname:>3s} {chain}"
                f"{int(prot.residue_index[ri]) + 1:4d}{'':1s}   "
                f"{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{prot.b_factors[ri, ai]:6.2f}"
                f"          {element:>2s}"
            )
            atom_index += 1
    lines += ["TER", "ENDMDL", "END", ""]
    return "\n".join(lines)


def from_pdb_string(pdb_str: str) -> Protein:
    """Parse the first model of a PDB string into a Protein."""
    residues = {}
    for line in io.StringIO(pdb_str):
        if line.startswith("ENDMDL"):
            break
        if not line.startswith("ATOM"):
            continue
        name = line[12:16].strip()
        resname = line[17:20].strip()
        chain = line[21]
        resseq = int(line[22:26])
        xyz = [float(line[30:38]), float(line[38:46]), float(line[46:54])]
        b = float(line[60:66]) if line[60:66].strip() else 0.0
        key = (chain, resseq)
        residues.setdefault(key, {"resname": resname, "atoms": {}})
        residues[key]["atoms"][name] = (xyz, b)

    keys = sorted(residues, key=lambda k: (k[0], k[1]))
    n = len(keys)
    pos = np.zeros((n, 37, 3))
    mask = np.zeros((n, 37))
    bfac = np.zeros((n, 37))
    aatype = np.full(n, 20, dtype=np.int64)
    res_idx = np.zeros(n, dtype=np.int64)
    chain_idx = np.zeros(n, dtype=np.int64)
    chains = sorted({k[0] for k in keys})
    for i, key in enumerate(keys):
        entry = residues[key]
        if entry["resname"] in pc.RESNAME_TO_IDX:
            aatype[i] = pc.RESNAME_TO_IDX[entry["resname"]]
        res_idx[i] = key[1] - 1
        chain_idx[i] = chains.index(key[0])
        for name, (xyz, b) in entry["atoms"].items():
            if name in pc.ATOM37_ORDER:
                ai = pc.ATOM37_ORDER[name]
                pos[i, ai] = xyz
                mask[i, ai] = 1.0
                bfac[i, ai] = b
    return Protein(pos, mask, aatype, res_idx, bfac, chain_idx)


def prots_to_pdb(prots: List[Protein]) -> str:
    """Multi-model PDB for trajectories (geometry.py:356-364)."""
    parts = []
    for i, prot in enumerate(prots):
        body = to_pdb(prot).split("\n")
        parts.append(f"MODEL {i}")
        parts.extend(body[1:-3])  # strip MODEL/END wrappers
        parts.append("ENDMDL")
    parts.append("END")
    return "\n".join(parts) + "\n"


def atom14_to_pdb(atom14: np.ndarray, aatype: np.ndarray, path: str):
    """atom14 trajectory [T, R, 14, 3] → multi-model PDB file
    (geometry.py:367-373)."""
    prots = []
    for frame in atom14:
        atom37 = np.asarray(geo.atom14_to_atom37(frame, np.asarray(aatype)))
        prots.append(create_full_prot(atom37, aatype=aatype))
    with open(path, "w") as f:
        f.write(prots_to_pdb(prots))
