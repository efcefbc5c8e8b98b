"""The port's 4AA preprocessing (``lam_slide_tpu_torch/tools/process_4aa.py``)
against ``tools/process_4aa.py``, on the CPU, on raw MD files of synthetic
peptides (``lam_slide_tpu_torch/tools/synthetic_md.py``: PDB topologies with
hydrogens, trajectories as XTC, DCD, multi-model PDB or an npz dump).

``process_one`` writes the JAX tool's npz bits and state0 PDB text; the
hydrogens are gone; each npz is the decoded frames after
``superpose_center``, bit for bit, and the written frames after it within
the codec's bound carried through the fit (below); the JAX and port
``PeptideDataset`` read those files to the same precomputed arrays, within
``tests/test_torch_port_peptide_data.py``'s limit (the precompute runs on
jnp and on torch). ``main`` runs a split csv with a stride.
"""

import importlib.util
import os

import numpy as np
import pytest

from lam_slide_tpu.data import peptide as jpep
from lam_slide_tpu_torch.data import peptide as tpep
from lam_slide_tpu_torch.data.trajio import load_traj
from lam_slide_tpu_torch.tools import process_4aa as tproc
from lam_slide_tpu_torch.tools.synthetic_md import write_raw_peptide

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 40
PRECISION = 1000.0
# What each codec keeps of a written coordinate, in nm: XTC rounds to a grid
# of 1 / precision, PDB prints Å to 3 decimals, DCD stores float32 Å; each
# also 2 float32 ulps of the largest coordinate (the nm <-> Å scaling).
CODEC_BOUND = {"xtc": 0.5 / PRECISION, "pdb": 5e-5, "dcd": 0.0}
# The bound carried through superpose_center: centering moves each error by
# the frame's mean error (at most the bound), and the fit onto frame 0
# carries frame 0's errors into every frame, so up to 4x the bound. Readings
# on synthetic peptides of 300 frames: at most 1.9x.
FIT_FACTOR = 4.0
PEPTIDE_ATOL = 1e-5  # tests/test_torch_port_peptide_data.py


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_process_4aa", os.path.join(ROOT, "tools", "process_4aa.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write(sim_dir, name, fmt):
    if fmt == "npz":  # a coordinate dump beside the xtc-style topology
        frames_nm, heavy = write_raw_peptide(sim_dir, name, "dcd", FRAMES)
        os.remove(os.path.join(sim_dir, name, f"{name}.dcd"))
        np.savez(os.path.join(sim_dir, name, f"{name}.npz"), positions=frames_nm)
        return frames_nm, heavy
    return write_raw_peptide(sim_dir, name, fmt, FRAMES, precision=PRECISION)


@pytest.mark.parametrize("fmt", ["xtc", "dcd", "pdb", "npz"])
@pytest.mark.parametrize("stride", [1, 3])
def test_process_one_matches_jax(tmp_path, fmt, stride):
    sims, name = str(tmp_path / "sims"), f"raw{fmt}"
    frames_nm, heavy = _write(sims, name, fmt)
    for out in ("port", "jax"):
        os.makedirs(tmp_path / out)
    assert tproc.process_one((name, sims, str(tmp_path / "port"), stride)) == name
    _jax_tool().process_one((name, sims, str(tmp_path / "jax"), stride))
    files = (f"{name}-traj-arrays.npz", f"{name}-traj-state0.pdb")
    assert sorted(os.listdir(tmp_path / "port")) == sorted(files)
    got = np.load(tmp_path / "port" / files[0])["positions"]
    want = np.load(tmp_path / "jax" / files[0])["positions"]
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert (tmp_path / "port" / files[1]).read_text() == (tmp_path / "jax" / files[1]).read_text()

    # hydrogens stripped: the state0 topology holds the heavy atoms alone
    residues = tpep.parse_pdb_topology(str(tmp_path / "port" / files[1]))
    with open(tmp_path / "port" / files[1]) as f:
        names = [line[12:16].strip() for line in f if line.startswith("ATOM")]
    assert len(names) == sum(len(n) for _, n in residues) == len(heavy) == got.shape[1]
    assert not any(n.startswith("H") or n[:1].isdigit() for n in names)

    # the npz is the decoded heavy frames after superpose_center, strided
    ext = {"xtc": ".xtc", "dcd": ".dcd", "pdb": ".pdb", "npz": ".npz"}[fmt]
    decoded = load_traj(os.path.join(sims, name, name + ext), pdb_unit="nm")
    np.testing.assert_array_equal(got, tpep.superpose_center(decoded[:, heavy])[::stride])
    bound = CODEC_BOUND.get(fmt, 0.0) + 2 * np.spacing(np.abs(frames_nm).max())
    assert np.abs(decoded - frames_nm).max() <= bound
    fit = np.abs(got - tpep.superpose_center(frames_nm[:, heavy].copy())[::stride]).max()
    assert fit <= FIT_FACTOR * bound, fit


def test_peptide_datasets_read_the_processed_files_alike(tmp_path):
    sims, out = str(tmp_path / "sims"), str(tmp_path / "out")
    os.makedirs(out)
    for i, fmt in enumerate(("xtc", "dcd", "pdb")):
        _write(sims, f"raw{i}", fmt)
        tproc.process_one((f"raw{i}", sims, out, 1))
    kw = dict(data_dir=out, first_stage=False, n_timesteps=16)
    tds, jds = tpep.PeptideDataset(**kw), jpep.PeptideDataset(**kw)
    assert [t["name"] for t in tds.trajectories] == ["raw0", "raw1", "raw2"]
    for tt, jt in zip(tds.trajectories, jds.trajectories):
        assert tt["name"] == jt["name"] and tt["n_frames"] == jt["n_frames"] == FRAMES
        for k in ("atom14_pos", "atom14_pos_frame", "torsions"):
            np.testing.assert_allclose(tt[k], jt[k], atol=PEPTIDE_ATOL, err_msg=k)
        for k in ("atom14_mask", "torsions_mask", "aatype"):
            np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)


def test_main_runs_a_split(tmp_path, capsys):
    sims, out = str(tmp_path / "sims"), str(tmp_path / "out")
    for i, fmt in enumerate(("xtc", "pdb")):
        _write(sims, f"raw{i}", fmt)
    (tmp_path / "split.csv").write_text("name,seqres\nraw0,AAAA\nraw1,GGGG\n")
    argv = ["--split", str(tmp_path / "split.csv"), "--sim-dir", sims, "--outdir", out,
            "--stride", "4"]
    tproc.main(argv)
    assert capsys.readouterr().out.split() == ["done", "raw0", "done", "raw1"]
    for i in range(2):
        assert np.load(f"{out}/raw{i}-traj-arrays.npz")["positions"].shape[0] == FRAMES // 4
    tproc.main(argv)  # finished systems are skipped
    assert capsys.readouterr().out == ""


def test_a_codec_failure_raises(tmp_path):
    sims = str(tmp_path / "sims")
    write_raw_peptide(sims, "bad", "xtc", 4)
    with open(os.path.join(sims, "bad", "bad.xtc"), "r+b") as f:
        f.truncate(100)
    with pytest.raises(ValueError, match="corrupt"):
        tproc.process_one(("bad", sims, str(tmp_path), 1))
