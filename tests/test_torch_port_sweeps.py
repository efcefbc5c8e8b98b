"""The port's sweep launcher (``experiments/sweeps.py``) against the JAX
package's, on the CPU.

The presets and the resolved entries are the same; the subprocess fan-out
builds the same ``train.cli`` argv but for the module path
(``subprocess.run`` is replaced, so nothing trains in a subprocess); the
SLURM scripts hold the same text but for the module path. ``run_sweep``
trains a smoke entry in-process on the port's registry and ``Trainer``.
The multi-device options forward ``--devices N`` (``devices``) and
``--multihost`` (SLURM jobs of more than one node, which also export the
rendezvous) as the JAX launcher does.
"""

import json
import os
import subprocess
import uuid

import pytest

from lam_slide_tpu.experiments import sweeps as jsw
from lam_slide_tpu_torch.experiments import sweeps as tsw

EXTRA = {"batch_size": 8, "lr_scale": 0.5}


@pytest.fixture
def fixed_ids(monkeypatch):
    """uuid4 draws a fixed sequence, restarted for each package."""
    def restart():
        ids = iter(range(1000))
        monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=(next(ids) + 1) << 96))
    return restart


def test_presets_match_jax():
    assert tsw.SWEEPS == jsw.SWEEPS


@pytest.mark.parametrize("name", sorted(jsw.SWEEPS))
@pytest.mark.parametrize("fs_runs", [None, "ab12cd34", {"aspirin": "a1", "eth": "e1"}])
def test_entries_match_jax(name, fs_runs, fixed_ids):
    fixed_ids()
    want = list(jsw._resolve_entries(name, fs_runs, EXTRA))
    fixed_ids()
    assert list(tsw._resolve_entries(name, fs_runs, EXTRA)) == want


def _port_argv(argv):
    return [a.replace("lam_slide_tpu_torch.", "lam_slide_tpu.") for a in argv]


@pytest.mark.parametrize("name", ["md17", "nba", "peptide"])
def test_fanout_argv_matches_jax(name, tmp_path, monkeypatch, fixed_ids):
    seen = []

    def fake_run(cmd, stdout=None, stderr=None):
        seen.append(list(cmd))
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(subprocess, "run", fake_run)
    ws = str(tmp_path / "ws")
    kw = dict(workspace=ws, first_stage_runs="ab12cd34", smoke=True, extra=EXTRA, jobs=2)
    fixed_ids()
    jax_ids = jsw.run_sweep(name, **kw)
    want, seen[:] = sorted(seen), []
    fixed_ids()
    assert tsw.run_sweep(name, **kw) == jax_ids
    got = sorted(seen)
    assert all(cmd[1:3] == ["-m", "lam_slide_tpu_torch.train.cli"] for cmd in got)
    assert [_port_argv(cmd) for cmd in got] == want
    # a device other than the card is forwarded to each job
    seen[:] = []
    tsw.run_sweep(name, **kw, device="cpu")
    assert seen and all(cmd[cmd.index("--device") + 1] == "cpu" for cmd in seen)


def test_fanout_surfaces_failures(tmp_path, monkeypatch):
    monkeypatch.setattr(subprocess, "run",
                        lambda cmd, stdout=None, stderr=None:
                        subprocess.CompletedProcess(cmd, 3))
    with pytest.raises(RuntimeError, match="1/1 jobs failed"):
        tsw.run_sweep("peptide", workspace=str(tmp_path), jobs=2)


def test_slurm_scripts_match_jax(tmp_path, fixed_ids):
    kw = dict(first_stage_runs={"score": "s1"}, smoke=True, extra=EXTRA, partition="gpu",
              account="proj1", time_limit="08:00:00", nodes=1, qos="normal", submit=False)
    fixed_ids()
    want = {p: open(p).read() for p in jsw.submit_slurm("nba", workspace=str(tmp_path), **kw)}
    fixed_ids()
    got = tsw.submit_slurm("nba", workspace=str(tmp_path), **kw)
    assert got == list(want) and len(set(got)) == len(jsw.SWEEPS["nba"])
    for path in got:
        text = open(path).read()
        assert "-m lam_slide_tpu_torch.train.cli " in text
        assert text.replace("lam_slide_tpu_torch.", "lam_slide_tpu.") == want[path]
        assert os.access(path, os.X_OK)


def test_multi_device_options_raise(tmp_path, monkeypatch, fixed_ids):
    """Named for the refusals it once pinned: the multi-device options now
    run. ``devices`` forwards ``--devices N`` to each job (the JAX
    launcher's argv), also from the shell and at jobs=1; a SLURM job of two
    nodes passes ``--multihost`` and exports the rendezvous, its script
    otherwise JAX's."""
    seen = []

    def fake_run(cmd, stdout=None, stderr=None):
        seen.append(list(cmd))
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(subprocess, "run", fake_run)
    ws = str(tmp_path / "ws")
    fixed_ids()
    jsw.run_sweep("nba", workspace=ws, jobs=2, devices=2)
    want, seen[:] = sorted(seen), []
    fixed_ids()
    tsw.run_sweep("nba", workspace=ws, devices=2)
    assert [_port_argv(cmd) for cmd in sorted(seen)] == want
    assert all(cmd[cmd.index("--devices") + 1] == "2" for cmd in want)
    seen[:] = []
    tsw.main(["peptide", "--workspace", ws, "--devices", "2"])
    assert len(seen) == 1 and seen[0][seen[0].index("--devices") + 1] == "2"

    kw = dict(first_stage_runs="s1", smoke=True, nodes=2, submit=False)
    fixed_ids()
    want = {p: open(p).read() for p in jsw.submit_slurm("peptide", workspace=str(tmp_path),
                                                         **kw)}
    fixed_ids()
    (path,) = tsw.submit_slurm("peptide", workspace=str(tmp_path), **kw)
    text = open(path).read()
    assert "#SBATCH --nodes=2" in text and " --multihost" in text
    rendezvous = ('export MASTER_ADDR=$(scontrol show hostnames "$SLURM_JOB_NODELIST" '
                  '| head -n 1)\nexport MASTER_PORT=29500\n')
    assert rendezvous in text
    assert text.replace(rendezvous, "").replace("lam_slide_tpu_torch.", "lam_slide_tpu.") \
        == want[path]


def test_in_process_smoke_sweep(tmp_path, monkeypatch):
    monkeypatch.setenv("LAM_SLIDE_NO_DATA_CACHE", "1")
    monkeypatch.setitem(tsw.SWEEPS, "_test_md17", [("md17_first_stage", {"molecule": "ethanol"}),
                                                    ("md17_first_stage", {"molecule": "benzene"})])
    ws = str(tmp_path / "ws")
    run_ids = tsw.run_sweep("_test_md17", workspace=ws, smoke=True, device="cpu")
    assert len(set(run_ids)) == 2
    for rid in run_ids:
        with open(os.path.join(ws, rid, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        train = [r for r in recs if r.get("split") == "train"]
        assert len(train) == 2 and all(r["train/loss"] == r["train/loss"] for r in train)
        assert os.path.isdir(os.path.join(ws, rid, "checkpoints"))
