"""The port's 4AA workload through its entry points, on the CPU at smoke
width: ``train.cli --experiment peptide_first_stage``, then
``peptide_second_stage --first-stage-run`` with ``--test``, then
``analysis.eval_cli --run``.

* The run registry links stage 2 to stage 1, and stage 2's ``launch`` block
  has the JAX CLI's keys; ``--test`` on a peptide stage-2 run prints the
  pointer to the eval CLI and writes no metrics, as JAX's does
  (lam_slide_tpu/train/cli.py:315-316), and ``--test-only`` does the same.
* ``eval_cli --num-rollouts 1 --batch-peptides --sampling-method euler``
  exits 0, writes one PDB a test peptide and ``metrics.json`` with the JAX
  eval's keys and finite values, on the fp32 rebuild of the bf16-trained
  DiT; ``--unroll`` changes nothing; ``--control`` samples a random DiT;
  ``--figures`` writes the summary figure (and exits naming matplotlib
  without it); unknown ``--pdb-ids`` exit with their message.
* The registry: the configs, trainer settings and overrides (``num_heads``,
  ``batch_size``, ``dit_dtype``, ``n_timesteps``) as the JAX registry sets
  them.
"""

import ast
import contextlib
import dataclasses
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from lam_slide_tpu.composites import peptide as jpep
from lam_slide_tpu_torch.analysis import eval_cli
from lam_slide_tpu_torch.composites import peptide as tpep
from lam_slide_tpu_torch.experiments import registry as treg
from lam_slide_tpu_torch.train.cli import main

ROOT = Path(__file__).resolve().parents[1]
SUMMARY_KEYS = {"BB", "SC", "ALL", "TICA-0", "TICA-0,1", "MSMS"}
EVAL = ["--num-rollouts", "1", "--batch-peptides", "--sampling-method", "euler",
        "--device", "cpu", "--no-decorr"]


def _jax_launch_keys():
    tree = ast.parse((ROOT / "lam_slide_tpu" / "train" / "cli.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for key, value in zip(node.keys, node.values):
                if isinstance(key, ast.Constant) and key.value == "launch":
                    return {k.value for k in value.keys}
    raise AssertionError("no launch block in the JAX CLI")


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """Smoke stage 1 (s1), then stage 2 (s2) on it with --test and a bf16
    training DiT, through the port's CLI on the CPU; the output of each."""
    ws = str(tmp_path_factory.mktemp("pep") / "ws")
    common = ["--smoke", "--workspace", ws, "--device", "cpu", "--epochs", "1"]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LAM_SLIDE_NO_DATA_CACHE", "1")
        for run_id, extra in (("s1", ["--experiment", "peptide_first_stage"]),
                              ("s2", ["--experiment", "peptide_second_stage",
                                      "--first-stage-run", "s1", "--test",
                                      "--exp-set", "dit_dtype=bfloat16"])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert main([*extra, "--run-id", run_id, *common]) == 0
            out[run_id] = buf.getvalue()
    return ws, out


def test_lineage_and_test_pointer(workspace, capsys, monkeypatch):
    ws, out = workspace
    registry = json.load(open(Path(ws) / "runs.json"))
    assert registry["s2"]["config"]["first_stage_run"] == "s1"
    assert registry["s2"]["config"]["launch"]["first_stage_run"] == "s1"
    assert set(registry["s2"]["config"]["launch"]) == _jax_launch_keys()
    assert registry["s1"]["config"]["domain"] == registry["s2"]["config"]["domain"] == "peptide"
    assert registry["s2"]["config"]["launch"]["exp_overrides"] == {"dit_dtype": "bfloat16"}
    pointer = "use python -m lam_slide_tpu_torch.analysis.eval_cli --run s2"
    assert pointer in out["s2"]
    assert not (Path(ws) / "s2" / "test_metrics.json").exists()
    for run_id, splits in (("s1", ["train", "val/val"]), ("s2", ["train", "val/val"])):
        records = [json.loads(line) for line in open(Path(ws) / run_id / "metrics.jsonl")]
        assert [r["split"] for r in records] == splits
        assert all(np.isfinite(v) for r in records for v in r.values() if isinstance(v, float))
    monkeypatch.setenv("LAM_SLIDE_NO_DATA_CACHE", "1")
    assert main(["--workspace", ws, "--run-id", "s2", "--test-only", "--device", "cpu"]) == 0
    assert pointer in capsys.readouterr().out
    assert not (Path(ws) / "s2" / "test_metrics.json").exists()


def test_eval_cli_end_to_end(workspace, monkeypatch):
    ws, _ = workspace
    monkeypatch.setenv("LAM_SLIDE_NO_DATA_CACHE", "1")
    built = []
    orig = tpep.build_peptide_second_stage  # eval_cli imports it when it runs

    def spy(*args, **kw):
        built.append(orig(*args, **kw))
        return built[-1]

    monkeypatch.setattr(tpep, "build_peptide_second_stage", spy)
    outdir = Path(ws) / "eval_a"
    assert eval_cli.main(["--run", "s2", "--workspace", ws, "--outdir", str(outdir), *EVAL]) == 0
    # the fp32 rebuild of the bf16-trained DiT, every floating tensor fp32
    (ss,) = built
    assert ss.backbone.dtype == torch.float32
    for module in (ss.backbone, ss.first_stage):
        assert all(not t.is_floating_point() or t.dtype == torch.float32
                   for t in module.state_dict().values())
    metrics = json.load(open(outdir / "metrics.json"))
    assert set(metrics) == {"summary", "per_peptide"}
    assert set(metrics["summary"]) == SUMMARY_KEYS
    assert all(np.isfinite(v) for v in metrics["summary"].values())
    names = sorted(metrics["per_peptide"])
    assert names == [f"synth{i}" for i in range(4)]
    assert sorted(p.name for p in outdir.glob("*.pdb")) == [f"{n}.pdb" for n in names]
    assert all(np.isfinite(v) for d in metrics["per_peptide"].values() for v in d.values())

    # --unroll changes nothing
    assert eval_cli.main(["--run", "s2", "--workspace", ws, "--outdir", str(Path(ws) / "eval_b"),
                          "--unroll", *EVAL]) == 0
    assert json.load(open(Path(ws) / "eval_b" / "metrics.json")) == metrics
    # the control arm samples a freshly drawn DiT, by default into
    # eval_control (at smoke width one step leaves both near the reference
    # init's zero output, so their metrics need not differ; their weights do)
    assert eval_cli.main(["--run", "s2", "--workspace", ws, "--control", *EVAL]) == 0
    control = json.load(open(Path(ws) / "s2" / "eval_control" / "metrics.json"))
    assert set(control["summary"]) == SUMMARY_KEYS
    trained = treg.load_checkpoint_raw(str(Path(ws) / "s2"), "best")
    assert torch.equal(built[0].backbone.x_in.weight, trained["ema_params"]["x_in.weight"])
    assert not torch.equal(built[-1].backbone.x_in.weight, trained["ema_params"]["x_in.weight"])


def test_eval_cli_refusals(workspace, monkeypatch, tmp_path):
    """``--figures`` draws the summary figure with analysis/plots.py, and
    exits naming matplotlib where it is not installed; unknown
    ``--pdb-ids`` are refused."""
    ws, _ = workspace
    monkeypatch.setenv("LAM_SLIDE_NO_DATA_CACHE", "1")
    assert eval_cli.main(["--run", "s2", "--workspace", ws, "--figures", "--outdir",
                          str(tmp_path), *EVAL]) == 0
    assert (tmp_path / "summary.png").stat().st_size > 0
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else real(name, *a))
    with pytest.raises(SystemExit, match="matplotlib"):
        eval_cli.main(["--run", "s2", "--workspace", ws, "--figures", *EVAL])
    with pytest.raises(SystemExit, match="--pdb-ids not found"):
        eval_cli.main(["--run", "s2", "--workspace", ws, "--pdb-ids", "nope", *EVAL])


def test_registry_configs_and_overrides_match_jax():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LAM_SLIDE_NO_DATA_CACHE", "1")
        run1 = treg.peptide_first_stage(smoke=True, device="cpu", scale=10.0)
        run2 = treg.peptide_second_stage(first_stage=run1, smoke=True, device="cpu",
                                         num_heads=2, batch_size=3, dit_dtype="bfloat16",
                                         n_timesteps=12)
    jcfg1 = jpep.PeptideFirstStageConfig(dim_input=32, dim_latent=16, dim_entity=32,
                                         num_latents=2, num_split=4, dim_head_cross=8,
                                         dim_head_latent=8, scale=10.0)
    assert dataclasses.asdict(run1.config) == jcfg1.__dict__
    assert run1.train_loader.batch_size == 4
    assert (run1.trainer_cfg.lr, run1.trainer_cfg.monitor) == (1e-3, "pos_loss")
    jcfg2 = jpep.PeptideSecondStageConfig(in_dim=16, depth=2, hidden_size=32, num_heads=2,
                                          num_timesteps=12)
    assert dataclasses.asdict(run2.config) == jcfg2.__dict__
    assert run2.model.num_heads == 2 and run2.model.dtype == torch.bfloat16
    assert run2.test_model.backbone.dtype == torch.float32
    assert run2.train_loader.batch_size == 3
    assert run2.train_loader.dataset.scale == 10.0  # the lineage's normalization
    assert (run2.trainer_cfg.lr, run2.trainer_cfg.grad_clip,
            run2.trainer_cfg.monitor) == (1e-3, 0.5, "si_loss")
    assert [t["name"] for t in run2.test_loaders["test"].dataset.trajectories] == [
        "testsynth0", "testsynth1"]
    with pytest.raises(ValueError, match="frame_holdout"):
        treg.peptide_first_stage(smoke=True, device="cpu", data_root="x", frame_holdout=0.1)
    with pytest.raises(ValueError, match="requires first_stage_run"):
        treg.peptide_second_stage(device="cpu")
