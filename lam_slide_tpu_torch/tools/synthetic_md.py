"""Raw MD files of synthetic peptides, the input ``process_4aa`` reads (no
JAX counterpart: the real 4AA/ATLAS releases are not in the repository).

Each peptide is ``data.peptide._synthetic_trajectory`` (forward kinematics
of random torsions, Å), written as a raw simulation would be: a PDB
topology that includes hydrogens (an amide ``H`` on N, ``HA`` on CA and
``1HB`` on CB, so both hydrogen-name rules of the topology readers are
exercised) and a trajectory in one of three formats:

- ``xtc``: ``{name}.xtc`` in nm (the port's codec, ``precision``) beside the
  frame-0 ``{name}.pdb`` topology;
- ``dcd``: ``{name}.dcd`` (Å on disk, written from nm) beside the topology;
- ``pdb``: a multi-model ``{name}.pdb`` of every frame (Å, 8.3f), its own
  topology.

    from lam_slide_tpu_torch.tools.synthetic_md import write_raw_peptide
    frames_nm, heavy = write_raw_peptide("sims", "raw0", "xtc", n_frames=1100)
"""

import os
from typing import List, Tuple

import numpy as np

from lam_slide_tpu_torch.data.dcd import write_dcd
from lam_slide_tpu_torch.data.peptide import _synthetic_trajectory
from lam_slide_tpu_torch.data.xtc import write_xtc
from lam_slide_tpu_torch.geometry import constants as pc

FORMATS = ("xtc", "dcd", "pdb")
H_BOND = 1.0  # Å from the heavy atom a hydrogen sits on
# hydrogen name -> the heavy atom it sits on
HYDROGENS = {"N": "H", "CA": "HA", "CB": "1HB"}


def _atoms(atom14: np.ndarray, aatype: np.ndarray) -> Tuple[List[tuple], np.ndarray]:
    """-> ([(resname, res_index, atom name, element)], xyz [T, n_all, 3] Å),
    heavy atoms in atom14 order, each hydrogen after its heavy atom."""
    atoms, cols = [], []
    for r, a in enumerate(aatype):
        resname = pc.RESTYPE_1TO3[pc.RESTYPES[int(a)]]
        names = pc.ATOM14_NAMES[resname].split()
        for i, name in enumerate(names):
            atoms.append((resname, r, name, name[0]))
            cols.append(atom14[:, r, i])
            if name in HYDROGENS:
                # on the axis from N (from CA, for N itself) through the
                # heavy atom
                anchor = atom14[:, r, 0] if name != "N" else atom14[:, r, 1]
                axis = atom14[:, r, i] - anchor
                axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
                atoms.append((resname, r, HYDROGENS[name], "H"))
                cols.append(atom14[:, r, i] + H_BOND * axis)
    return atoms, np.stack(cols, axis=1).astype(np.float32)


def _pdb_model(atoms, xyz_angstrom: np.ndarray) -> List[str]:
    lines = []
    for i, ((resname, r, name, element), (x, y, z)) in enumerate(zip(atoms, xyz_angstrom)):
        pad = name if len(name) == 4 or name[:1].isdigit() else f" {name:<3s}"
        lines.append(f"ATOM  {i + 1:5d} {pad:<4s} {resname:>3s} A{r + 1:4d}    "
                     f"{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{0.0:6.2f}          {element:>2s}\n")
    return lines


def write_raw_peptide(sim_dir: str, name: str, fmt: str, n_frames: int,
                      precision: float = 1000.0) -> Tuple[np.ndarray, np.ndarray]:
    """Write ``{sim_dir}/{name}/{name}.pdb`` (+ ``.xtc``/``.dcd``) ->
    (the written frames [T, n_all, 3] float32 in nm, before any codec's
    rounding; the heavy atoms' indices into n_all)."""
    if fmt not in FORMATS:
        raise ValueError(f"format {fmt!r} not in {FORMATS}")
    atom14, aatype = _synthetic_trajectory(name, n_frames=n_frames)
    atoms, xyz = _atoms(atom14, aatype)
    heavy = np.asarray([i for i, a in enumerate(atoms) if a[3] != "H"], np.int64)
    frames_nm = (xyz / np.float32(10.0)).astype(np.float32)
    base = os.path.join(sim_dir, name, name)
    os.makedirs(os.path.dirname(base), exist_ok=True)
    with open(base + ".pdb", "w") as f:
        if fmt == "pdb":
            for t in range(n_frames):
                f.write(f"MODEL     {t + 1:4d}\n")
                f.writelines(_pdb_model(atoms, xyz[t]))
                f.write("ENDMDL\n")
        else:
            f.writelines(_pdb_model(atoms, xyz[0]))
        f.write("END\n")
    if fmt == "xtc":
        write_xtc(base + ".xtc", frames_nm, precision=precision)
    elif fmt == "dcd":
        write_dcd(base + ".dcd", frames_nm)
    return frames_nm, heavy
