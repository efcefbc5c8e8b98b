"""Multi-format trajectory loading (host-side; counterpart of
``lam_slide_tpu/data/trajio.py``).

Library equivalent of the reference's ``load_traj`` dispatcher
(src/utils/traj_utils.py:25-41), which routes .pdb/.xtc/.dcd/.npz/.npy
through mdtraj. Here each format is decoded natively:

    .xtc  the port's GROMACS codec (native/xtc.cc via data/xtc.py)
    .dcd  pure-numpy CHARMM/NAMD codec (data/dcd.py)
    .npz  positions under "positions"/"xyz"/"arr_0"
    .npy  raw array; a leading batch axis of a [B, T, N, 3] array is
          squeezed to [T, N, 3] like the reference (traj_utils.py:35-37);
          a 4-D *.npz* is an error (the reference squeezes .npy only — a
          batched npz would silently drop trajectories 1..B-1)
    .pdb  multi-model ATOM/HETATM records

Units: nm for xtc/dcd (the dcd codec converts from Angstrom to match
mdtraj), as-saved for npz/npy. **pdb returns Angstrom as stored in the
file — a deliberate divergence from the mdtraj-backed reference, whose
load_traj converts pdb to nm on load.** Callers mixing pdb with xtc/dcd
inputs (e.g. tools/process_4aa.py) must reconcile units themselves; pass
``pdb_unit="nm"`` to get the reference's nm contract instead.
"""

import os

import numpy as np

__all__ = ["load_traj", "read_pdb_frames"]


def read_pdb_frames(source) -> np.ndarray:
    """Parse a multi-model PDB (path or file-like) -> [T, n_atoms, 3]."""
    if hasattr(source, "read"):
        f = source
        close = False
    else:
        f = open(source)
        close = True
    frames, cur = [], []
    try:
        for line in f:
            if line.startswith("ENDMDL"):
                if cur:
                    frames.append(cur)
                    cur = []
            elif line.startswith(("ATOM", "HETATM")):
                cur.append([float(line[30:38]), float(line[38:46]),
                            float(line[46:54])])
    finally:
        if close:
            f.close()
    if cur:
        frames.append(cur)
    if not frames:
        raise ValueError("no ATOM records found")
    counts = {len(fr) for fr in frames}
    if len(counts) != 1:
        raise ValueError(f"inconsistent atom counts across models: {sorted(counts)}")
    return np.asarray(frames, np.float32)


def load_traj(path: str, pdb_unit: str = "angstrom") -> np.ndarray:
    """Load any supported trajectory format -> [T, n_atoms, 3] float32.

    ``pdb_unit``: "angstrom" (default; coordinates as stored in the PDB)
    or "nm" (divide by 10 — the reference's mdtraj contract).
    Raises ValueError for an unsupported extension or a file whose
    contents don't yield a coordinate array.
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".xtc":
        from lam_slide_tpu_torch.data.xtc import read_xtc

        arr = np.asarray(read_xtc(path)[0], np.float32)
    elif ext == ".dcd":
        from lam_slide_tpu_torch.data.dcd import read_dcd

        arr = np.asarray(read_dcd(path)[0], np.float32)
    elif ext in (".npz", ".npy"):
        data = np.load(path)
        if hasattr(data, "files"):  # npz archive
            for k in ("positions", "xyz", "arr_0"):
                if k in data.files:
                    arr = np.asarray(data[k], np.float32)
                    break
            else:
                raise ValueError(f"{path}: no positions/xyz/arr_0 key")
            if arr.ndim == 4:
                # the reference squeezes .npy only (traj_utils.py:34-37);
                # silently returning arr[0] would drop trajectories 1..B-1
                raise ValueError(
                    f"{path}: batched [B, T, N, 3] npz is ambiguous — save "
                    "one trajectory per key/file, or use .npy for the "
                    "reference's first-trajectory squeeze")
        else:
            arr = np.asarray(data, np.float32)
            if arr.ndim == 4:  # [B, T, N, 3] -> first trajectory (npy only)
                arr = arr[0]
    elif ext == ".pdb":
        arr = read_pdb_frames(path)
        if pdb_unit == "nm":
            arr = arr / np.float32(10.0)
        elif pdb_unit != "angstrom":
            raise ValueError(f"pdb_unit must be 'angstrom' or 'nm', got {pdb_unit!r}")
    else:
        raise ValueError(f"unsupported trajectory format: {path}")
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(f"{path}: expected [T, N, 3], got {arr.shape}")
    return arr
