"""The port's trajectory formats (``data/trajio.py``, ``data/dcd.py``,
``data/constants.py`` and ``augment.encode_atoms``) against the JAX
package's, on the CPU.

DCD and multi-model PDB files written by either package read to the same
floats in both; ``load_traj`` gives the JAX package's array for every
format and unit (xtc, dcd, npz, npy with its batch squeeze, pdb in Å and in
nm) and raises the same errors (a 4-D npz, a missing key, a bad shape, an
unknown extension or pdb unit, models of different sizes).
"""

import struct

import numpy as np
import pytest

from lam_slide_tpu.data import augment as jaug
from lam_slide_tpu.data import constants as jconst
from lam_slide_tpu.data import dcd as jdcd
from lam_slide_tpu.data import trajio as jtraj
from lam_slide_tpu.data import xtc as jxtc
from lam_slide_tpu.data.peptide import parse_pdb_topology
from lam_slide_tpu_torch.data import augment as taug
from lam_slide_tpu_torch.data import constants as tconst
from lam_slide_tpu_torch.data import dcd as tdcd
from lam_slide_tpu_torch.data import trajio as ttraj


def _xyz(t=4, n=6, seed=0):
    return np.random.default_rng(seed).normal(size=(t, n, 3)).astype(np.float32)


def _pdb_text(xyz_angstrom):
    lines = []
    for t, frame in enumerate(xyz_angstrom):
        lines.append(f"MODEL     {t + 1}")
        for i, (x, y, z) in enumerate(frame):
            lines.append(f"ATOM  {i + 1:5d}  CA  ALA A{i + 1:4d}    "
                         f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00           C")
        lines.append("ENDMDL")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("cells", [False, True])
def test_dcd_files_read_the_same_in_both(tmp_path, writer, cells):
    xyz = _xyz()
    unit_cells = np.tile([10.0, 90.0, 11.0, 90.0, 90.0, 12.0], (4, 1)) if cells else None
    path = str(tmp_path / "a.dcd")
    (jdcd if writer == "jax" else tdcd).write_dcd(path, xyz, unit_cells=unit_cells)
    got, got_cells = tdcd.read_dcd(path)
    want, want_cells = jdcd.read_dcd(path)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, xyz, rtol=1e-6, atol=1e-6)
    if cells:
        np.testing.assert_array_equal(got_cells, want_cells)
    else:
        assert got_cells is None and want_cells is None


@pytest.mark.parametrize("endian", ["<", ">"])
def test_dcd_hand_laid_bytes_of_either_endian(tmp_path, endian):
    xyz_ang = _xyz(t=2, n=3) * 10.0

    def rec(payload):
        m = struct.pack(endian + "i", len(payload))
        return m + payload + m

    icntrl = [0] * 20
    icntrl[0], icntrl[19] = 2, 24
    raw = rec(b"CORD" + struct.pack(endian + "20i", *icntrl))
    raw += rec(struct.pack(endian + "i", 1) + b"T" * 80) + rec(struct.pack(endian + "i", 3))
    for f in range(2):
        for ax in range(3):
            raw += rec(struct.pack(endian + "3f", *xyz_ang[f, :, ax]))
    path = tmp_path / "h.dcd"
    path.write_bytes(raw)
    got, _ = tdcd.read_dcd(str(path))
    np.testing.assert_array_equal(got, jdcd.read_dcd(str(path))[0])
    np.testing.assert_allclose(got, xyz_ang * 0.1, rtol=1e-6)


@pytest.mark.parametrize("writer", ["text", "jax_protein"])
def test_pdb_frames_read_the_same_in_both(tmp_path, writer):
    path = str(tmp_path / "a.pdb")
    if writer == "text":
        with open(path, "w") as f:
            f.write(_pdb_text(_xyz(t=3, n=5) * 10.0))
    else:
        from lam_slide_tpu.geometry.protein import atom14_to_pdb

        rng = np.random.default_rng(1)
        aatype = np.asarray([0, 7, 5, 19])
        atom14 = rng.normal(size=(2, 4, 14, 3)).astype(np.float32) * 5.0
        atom14_to_pdb(atom14, aatype, path)
    np.testing.assert_array_equal(ttraj.read_pdb_frames(path), jtraj.read_pdb_frames(path))
    with open(path) as f:  # a file-like source too
        np.testing.assert_array_equal(ttraj.read_pdb_frames(f), jtraj.read_pdb_frames(path))


def _write(tmp_path, fmt):
    xyz = _xyz(t=3, n=12)
    if fmt == "xtc":
        path = tmp_path / "a.xtc"
        jxtc.write_xtc(str(path), xyz)
    elif fmt == "dcd":
        path = tmp_path / "a.dcd"
        jdcd.write_dcd(str(path), xyz)
    elif fmt in ("npz", "npz_xyz", "npz_arr_0"):
        path = tmp_path / "a.npz"
        key = {"npz": "positions", "npz_xyz": "xyz", "npz_arr_0": "arr_0"}[fmt]
        np.savez(path, **{key: xyz})
    elif fmt == "npy":
        path = tmp_path / "a.npy"
        np.save(path, xyz)
    elif fmt == "npy_batched":
        path = tmp_path / "a.npy"
        np.save(path, np.stack([xyz, xyz + 1.0]))
    else:
        path = tmp_path / "a.pdb"
        path.write_text(_pdb_text(xyz * 10.0))
    return str(path)


@pytest.mark.parametrize("fmt,unit", [("xtc", "angstrom"), ("dcd", "angstrom"),
                                      ("npz", "angstrom"), ("npz_xyz", "angstrom"),
                                      ("npz_arr_0", "angstrom"), ("npy", "angstrom"),
                                      ("npy_batched", "angstrom"), ("pdb", "angstrom"),
                                      ("pdb", "nm")])
def test_load_traj_matches_jax(tmp_path, fmt, unit):
    path = _write(tmp_path, fmt)
    got, want = ttraj.load_traj(path, pdb_unit=unit), jtraj.load_traj(path, pdb_unit=unit)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _bad(tmp_path, case):
    if case == "npz_batched":
        np.savez(tmp_path / "a.npz", positions=_xyz()[None].repeat(2, axis=0))
        return str(tmp_path / "a.npz"), {}, "batched"
    if case == "npz_missing_key":
        np.savez(tmp_path / "a.npz", other=np.zeros(3))
        return str(tmp_path / "a.npz"), {}, "positions"
    if case == "npy_bad_shape":
        np.save(tmp_path / "a.npy", np.zeros((5, 7)))
        return str(tmp_path / "a.npy"), {}, "expected"
    if case == "unsupported":
        (tmp_path / "a.h5").write_bytes(b"")
        return str(tmp_path / "a.h5"), {}, "unsupported"
    if case == "pdb_unit":
        (tmp_path / "a.pdb").write_text(_pdb_text(_xyz(t=1, n=2)))
        return str(tmp_path / "a.pdb"), {"pdb_unit": "bogus"}, "pdb_unit"
    (tmp_path / "a.pdb").write_text(_pdb_text(_xyz(t=1, n=2)) + _pdb_text(_xyz(t=1, n=3)))
    return str(tmp_path / "a.pdb"), {}, "inconsistent"


@pytest.mark.parametrize("case", ["npz_batched", "npz_missing_key", "npy_bad_shape",
                                  "unsupported", "pdb_unit", "pdb_inconsistent"])
def test_load_traj_raises_as_jax_does(tmp_path, case):
    path, kw, match = _bad(tmp_path, case)
    with pytest.raises(ValueError, match=match) as want:
        jtraj.load_traj(path, **kw)
    with pytest.raises(ValueError, match=match) as got:
        ttraj.load_traj(path, **kw)
    assert str(got.value) == str(want.value)


def test_constants_and_encode_atoms_match_jax(tmp_path):
    for name in ("ATOM_ENCODING", "ATOM_ENCODING_COLOR", "ELEMENT_COLORS",
                 "NUM_TO_ATOM_TYPE", "AA_TO_NUM", "ATOMIC_NUMBER_COLORS"):
        assert getattr(tconst, name) == getattr(jconst, name), name
    path = tmp_path / "top.pdb"
    path.write_text("".join(
        f"ATOM  {i + 1:5d} {name:<4s} {res} A{r:4d}    {0:8.3f}{0:8.3f}{0:8.3f}\n"
        for i, (name, res, r) in enumerate([(" N", "MET", 1), (" CA", "MET", 1),
                                            (" SD", "MET", 1), (" H", "MET", 1),
                                            (" OG", "SER", 2), ("1HB", "SER", 2)])))
    residues = parse_pdb_topology(str(path))
    got = taug.encode_atoms(residues)
    np.testing.assert_array_equal(got, jaug.encode_atoms(residues))
    np.testing.assert_array_equal(got, [1, 0, 3, 2])  # N, C, S, O; hydrogens stripped
