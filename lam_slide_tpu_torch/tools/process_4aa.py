"""4AA/ATLAS trajectory preprocessing: raw MD -> stride-reduced npz + state0
pdb (counterpart of ``tools/process_4aa.py``).

mdtraj-free port of the reference peptide prep scripts
(scripts/peptide/process_4AA.py + prep_sims.py, themselves adapted from
mdgen): per system, load the trajectory, strip hydrogens, center every
frame, superpose onto frame 0 (Kabsch), stride, and write
``{name}-traj-arrays.npz`` (key ``positions`` [T, n_atoms, 3], nm) plus
``{name}-traj-state0.pdb``, exactly the inputs
``lam_slide_tpu_torch.data.peptide.PeptideDataset`` consumes.

Trajectory input formats, read by ``lam_slide_tpu_torch.data.trajio``:
- ``{name}.xtc`` + ``{name}.pdb`` topology, decoded by the port's XTC codec
  (lam_slide_tpu_torch/native/xtc.cc, built with g++ at first use);
- ``{name}.dcd`` + ``{name}.pdb`` topology;
- a multi-model ``{name}.pdb`` trajectory, its own topology;
- a ``{name}.npz``/``.npy`` coordinate dump (keys: positions | xyz | arr_0)
  with a ``{name}.pdb`` topology.

There is no mdtraj fallback: a file the codecs cannot read raises.

    python -m lam_slide_tpu_torch.tools.process_4aa --split splits/atlas.csv \
        --sim-dir .../atlas --outdir data_4aa --stride 100 --num-workers 4
"""

import argparse
import csv
import os
from multiprocessing import Pool

import numpy as np

from lam_slide_tpu_torch.data.peptide import superpose_center
from lam_slide_tpu_torch.data.trajio import load_traj


def _read_names(split: str):
    with open(split) as f:
        rows = list(csv.DictReader(f))
    key = "name" if rows and "name" in rows[0] else list(rows[0].keys())[0]
    return [r[key] for r in rows]


def _heavy_atom_indices(top_path: str):
    """Indices of non-hydrogen ATOM records, in file order (the reference's
    ``a.element.symbol != 'H'`` atom_slice)."""
    keep = []
    i = 0
    with open(top_path) as f:
        for line in f:
            if line.startswith(("ENDMDL", "END ", "END\n")):
                break  # multi-model files: topology = first model
            if not line.startswith(("ATOM", "HETATM")):
                continue
            name = line[12:16].strip()
            is_h = name.startswith("H") or (name[:1].isdigit() and "H" in name)
            if not is_h:
                keep.append(i)
            i += 1
    return np.asarray(keep, np.int64)


def _load_xyz(traj_path: str) -> np.ndarray:
    """-> [T, n_atoms_all, 3] float32, nm for xtc/dcd/pdb (pdb converted
    Angstrom->nm, the reference's mdtraj contract — so mixed-format inputs
    can't silently mix units 10x apart), as-stored for npz/npy."""
    return load_traj(traj_path, pdb_unit="nm")


def _write_state0_pdb(out_path: str, top_path: str, xyz0_nm: np.ndarray,
                      keep: np.ndarray):
    """Frame-0 PDB: the topology's heavy-atom records with updated coords.

    ``xyz0_nm`` is in nm; written x10 as Angstrom (PDB convention — the
    reference's mdtraj ``save_pdb`` does the same nm->A conversion)."""
    kept = set(int(i) for i in keep)
    xyz0 = np.asarray(xyz0_nm, np.float64) * 10.0
    lines, ai, wi = [], 0, 0
    with open(top_path) as f:
        for line in f:
            if not line.startswith(("ATOM", "HETATM")):
                continue
            if ai in kept:
                x, y, z = (float(c) for c in xyz0[wi])
                lines.append(f"{line[:30]}{x:8.3f}{y:8.3f}{z:8.3f}{line[54:]}")
                wi += 1
            ai += 1
    with open(out_path, "w") as f:
        f.writelines(lines + ["END\n"])


def process_one(args_tuple):
    name, sim_dir, outdir, stride = args_tuple
    base = os.path.join(sim_dir, name, name)
    top_path = base + ".pdb"
    traj_path = next(
        (base + ext for ext in (".xtc", ".dcd", ".npz", ".npy")
         if os.path.exists(base + ext)),
        top_path,  # multi-model pdb doubles as its own topology
    )
    xyz = _load_xyz(traj_path)
    keep = _heavy_atom_indices(top_path)
    xyz = xyz[:, keep]
    xyz = superpose_center(xyz)          # center + Kabsch onto frame 0
    xyz = xyz[::stride]
    np.savez(os.path.join(outdir, f"{name}-traj-arrays.npz"),
             positions=xyz.astype(np.float32))
    _write_state0_pdb(os.path.join(outdir, f"{name}-traj-state0.pdb"),
                      top_path, xyz[0], keep)
    return name


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--split", required=True, help="csv with a 'name' column")
    p.add_argument("--sim-dir", required=True)
    p.add_argument("--outdir", required=True)
    p.add_argument("--stride", type=int, default=100)
    p.add_argument("--num-workers", type=int, default=1)
    args = p.parse_args(argv)

    os.makedirs(args.outdir, exist_ok=True)
    jobs = [
        (n, args.sim_dir, args.outdir, args.stride)
        for n in _read_names(args.split)
        if not os.path.exists(os.path.join(args.outdir, f"{n}-traj-arrays.npz"))
    ]
    if args.num_workers > 1:
        with Pool(args.num_workers) as pool:
            for name in pool.imap_unordered(process_one, jobs):
                print("done", name)
    else:
        for job in jobs:
            print("done", process_one(job))


if __name__ == "__main__":
    main()
